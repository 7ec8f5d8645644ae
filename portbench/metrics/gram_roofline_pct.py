"""Share (%) of its roofline that the gram kernel reaches in the window:
the least time the gram work of the window's solves could take at the
float32 peak or the HBM bandwidth (``roofline.gram_work``: every
deformable-model lane's own pixels and non-zero features, times its
iterations, whatever route the program gives the lane), over the device
time of the gram kernels (names beginning ``gram_``) in the traced window."""

from portbench import roofline
from portbench import devtrace as tracemod


def read(run):
    if run.trace is None or not run.recorder.gram_probe:
        return None
    ops, nbytes = roofline.gram_work(run.recorder.lanes)
    acts = run.trace.within(run.trace.device, run.t0, run.t_end)
    t = run.trace.device_seconds(lambda n: tracemod.short_name(n).startswith('gram_'), acts)
    if t <= 0 or ops <= 0:
        return None
    return 100.0 * roofline.bound_seconds(ops, nbytes)[0] / t
