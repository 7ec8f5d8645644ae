"""Device milliseconds of the Newton loop per replayed iteration: the
activities that belong to a CUDA graph's replay in the traced window, over
the replays the solver's loop counters add in the window."""


def read(run):
    if run.trace is None or run.loop_after is None:
        return None
    try:
        replays = run.loop_delta('replays')
    except KeyError:
        return None
    if replays <= 0:
        return None
    acts = run.trace.within(run.trace.replayed, run.t0, run.t_end)
    return 1e3 * sum(b - a for _, a, b in acts) / replays
