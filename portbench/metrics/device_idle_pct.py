"""Share (%) of the traced window in which no activity ran on the card."""


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy(run.t0, run.t1) / run.window_s)
