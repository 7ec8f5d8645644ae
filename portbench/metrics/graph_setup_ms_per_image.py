"""Milliseconds per image the Newton loop spends capturing and
instantiating its CUDA graphs (the solver's loop counters, as a delta over
the window)."""


def read(run):
    if not run.done or run.loop_after is None:
        return None
    try:
        s = run.loop_delta('capture_s') + run.loop_delta('instantiate_s')
    except KeyError:
        return None
    return 1e3 * s / len(run.done)
