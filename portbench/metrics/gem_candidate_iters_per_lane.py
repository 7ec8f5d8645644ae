"""Mean Newton iterations of a warm-started DSM lane (a problem with
``init_params``) of the window images, its canonical re-solve included:
the gram probe's per-lane iterations (``run.recorder.lanes``, one entry
each time a lane's chunk is stored) summed over those lanes, over the
lanes."""


def read(run):
    if not run.recorder.gram_probe:
        return None
    iters = {}
    for p, _, it in run.recorder.lanes:
        if getattr(p, 'init_params', None) is not None:
            iters[id(p)] = iters.get(id(p), 0) + it
    if not iters:
        return None
    return sum(iters.values()) / len(iters)
