"""Host calls that wait for the card (stream, device and event
synchronizations, synchronous copies) in the traced window, per image done
in it (``images_in_window``)."""

from portbench import devtrace as tracemod


def read(run):
    if run.trace is None or not run.done:
        return None
    n = run.trace.host_calls(tracemod.HOST_SYNC_CALLS, run.t0, run.t1)
    return n / run.images_in_window()
