"""What the benchmark records around the port's calls, from the outside.

- :class:`SolveRecorder` wraps the solve seam (``solve_problems`` as the
  stages call it) and keeps each window image's problems, arguments and
  results for the correctness check, and wraps the seam's result store to
  keep each lane's Newton iterations and the chunk's bucket, from which the
  gram's work is counted (:mod:`roofline`).
- :class:`StageSpans` records each stage's start and end on the host clock
  through the pipeline's stage callbacks.

Nothing here changes what the port computes: each wrapper calls the
original with the same arguments and returns its result unchanged.
"""

import inspect
import threading
import time

from portbench import roofline


class SolveRecorder:
    """Records the solve seam while a window image is being processed (the
    thread's ``image`` is set); warm-up images are not recorded."""

    def __init__(self):
        self.local = threading.local()
        self.solves = []   # dicts: image, args, problems, results
        self.lanes = []    # (problem, support radius, iterations)
        self.gram_probe = False
        self._undo = []

    def image(self, idx):
        self.local.image = idx

    def _current(self):
        return getattr(self.local, 'image', None)

    def install(self):
        from superdsm_tpu_torch import c2freganal, objects
        from superdsm_tpu_torch.dsm import batching
        orig = batching.solve_problems
        sig = inspect.signature(orig)
        rec = self

        def solve_problems(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            kw = {k: v for k, v in bound.arguments.items() if k not in ('problems', 'out')}
            rec.local.radius = roofline.support_radius(kw['smooth_amount'],
                                                       kw['gaussian_shape_multiplier'])
            results = orig(*args, **kwargs)
            idx = rec._current()
            if idx is not None:
                rec.solves.append(dict(image=idx, args=kw,
                                       problems=list(bound.arguments['problems']),
                                       results=list(results)))
            return results

        for mod in (c2freganal, objects):
            if getattr(mod, 'solve_problems', None) is orig:
                self._patch(mod, 'solve_problems', solve_problems)

        # the gram probe: each lane's iterations as its chunk is stored
        orig_store = getattr(batching, '_store_results', None)
        if orig_store is None:
            return
        self.gram_probe = True

        def store_results(results, problems, kind, chunk, row, fetch):
            out = orig_store(results, problems, kind, chunk, row, fetch)
            if kind.startswith('dsm') and rec._current() is not None:
                it = row['it']
                for j, i in enumerate(chunk):
                    rec.lanes.append((problems[i], rec.local.radius, int(it[j])))
            return out

        self._patch(batching, '_store_results', store_results)

    def _patch(self, mod, name, fn):
        self._undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def uninstall(self):
        while self._undo:
            mod, name, fn = self._undo.pop()
            setattr(mod, name, fn)


class StageSpans:
    """Host-clock spans of every stage of the pipelines it is attached to,
    for the images the recorder marks: ``(image, thread id, stage name,
    start, end)`` in :func:`time.perf_counter` seconds."""

    def __init__(self, recorder):
        self.spans = []
        self.rec = recorder

    def attach(self, pipeline):
        for stage in pipeline.stages:
            stage.add_callback('start', lambda _n, _d, s=stage.name: self._start(s))
            stage.add_callback('end', lambda _n, _d, s=stage.name: self._end(s))
        return pipeline

    def _start(self, stage):
        self.rec.local.stage = (stage, time.perf_counter())

    def _end(self, stage):
        idx = self.rec._current()
        name, t0 = self.rec.local.stage
        if idx is not None and name == stage:
            self.spans.append((idx, threading.get_ident(), stage, t0, time.perf_counter()))
