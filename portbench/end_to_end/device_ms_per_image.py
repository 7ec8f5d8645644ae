"""Device milliseconds a label map costs: the seconds in which some
operation ran on the card (the union of the trace's device activities),
from the window's open until the last image handed off in the window was
done, over those images. All the work of the window counts, over all of
its time; a failed image's work counts, and the image does not."""


def read(run):
    done = len(run.done)
    if run.trace is None or not done:
        return None
    return 1e3 * run.trace.busy(run.t0, run.t_end) / done
