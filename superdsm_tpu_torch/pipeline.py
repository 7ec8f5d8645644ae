"""Staged segmentation pipeline with partial execution.

Counterpart of the reference's ``superdsm/pipeline.py``
(``superdsm/pipeline.py:10-265``). The :class:`Stage` /
:class:`Pipeline` *protocol* — stage names, ``cfgns`` hyperparameter
namespaces, declared inputs/outputs, the ``configure``/``configure_ex``
auto-configuration contract, ``first_stage``/``last_stage`` partial
execution (including the ``"<stage>+"`` resume-after notation), and the
``(data, cfg, timings)`` return shape — is deliberately API-compatible: the
batch pickup system, the automation layer, and user code written against the
reference all program against it. The machinery behind the protocol is
original: partial execution resolves to an index window over an
``init``-prefixed slot list up front (the reference threads a stateful
``ProcessingControl`` stepper through the loop), stage ordering is a ready-
set topological sort, and ``init`` sanitizes non-finite camera pixels before
normalization.
"""

import math
import time

import numpy as np

from .output import get_output
from .image import normalize_image
from ._aux import mkdir

#: Name of the implicit normalization step that precedes the first stage.
#: ``process_image(first_stage='init')`` re-runs it; any later entry point
#: skips it (the batch pickup system passes previously computed ``data``).
INIT_SLOT = 'init'


class Stage(object):
    """A pipeline stage with a hyperparameter namespace and declared I/O.

    :param name: Readable identifier.
    :param cfgns: Hyperparameter namespace (defaults to ``name``).
    :param inputs: Keys this stage consumes from the pipeline data object.
    :param outputs: Keys this stage adds to the pipeline data object.

    Subclasses implement :meth:`process` and may override
    :meth:`configure_ex` to declare scale-dependent hyperparameter defaults
    (each entry ``key -> (factor, default_user_factor[, spec])``, where the
    effective value is ``factor * AF_key`` and ``spec`` may clamp
    type/min/max — same protocol as the reference,
    ``superdsm/pipeline.py:102-118``).
    """

    ENABLED_BY_DEFAULT = True

    def __init__(self, name, cfgns=None, inputs=[], outputs=[]):
        self.name = name
        self.cfgns = name if cfgns is None else cfgns
        self.inputs = {key: key for key in inputs}
        self.outputs = {key: key for key in outputs}
        self._callbacks = {}

    def _callback(self, name, *args, **kwargs):
        for cb in self._callbacks.get(name, []):
            cb(name, *args, **kwargs)

    def add_callback(self, name, cb):
        self._callbacks.setdefault(name, []).append(cb)

    def remove_callback(self, name, cb):
        if name in self._callbacks:
            self._callbacks[name].remove(cb)

    def __call__(self, data, cfg, out=None, log_root_dir=None):
        """Runs the stage on the shared ``data`` dict; returns seconds spent.

        A stage disabled via ``<cfgns>/enabled`` is skipped (its ``skip``
        callback still fires, so batch snapshot hooks see every file)."""
        out = get_output(out)
        stage_cfg = cfg.get(self.cfgns, {})
        if not stage_cfg.get('enabled', self.ENABLED_BY_DEFAULT):
            out.write(f'Skipping disabled stage "{self.name}"')
            self._callback('skip', data)
            return 0.0
        out.intermediate(f'Starting stage "{self.name}"')
        self._callback('start', data)
        taken = {alias: data[key] for key, alias in self.inputs.items()}
        t0 = time.time()
        produced = self.process(taken, cfg=stage_cfg, out=out,
                                log_root_dir=log_root_dir)
        elapsed = time.time() - t0
        assert produced.keys() == self.outputs.keys(), \
            f'stage "{self.name}" generated unexpected output'
        for key, alias in self.outputs.items():
            data[alias] = produced[key]
        self._callback('end', data)
        return elapsed

    def process(self, input_data, cfg, out, log_root_dir):
        """Runs this stage. Returns a dict of the declared outputs."""
        raise NotImplementedError()

    def configure(self, scale):
        """Scale-dependent defaults; ``radius = sqrt(2)*scale``,
        ``diameter = 2*radius`` (cf. ``superdsm/pipeline.py:84-100``)."""
        radius = scale * math.sqrt(2)
        return self.configure_ex(scale, radius, 2 * radius)

    def configure_ex(self, scale, radius, diameter):
        return dict()


class Pipeline:
    """An ordered list of stages operated on a shared data dictionary."""

    def __init__(self):
        self.stages = []

    def _slots(self):
        """Executable slot names: the ``init`` pseudo-stage, then the stages."""
        return [INIT_SLOT] + [stage.name for stage in self.stages]

    def _stage_window(self, first_stage, last_stage):
        """Resolves (first_stage, last_stage) names to an inclusive slot-index
        window [lo, hi]; an unknown ``first_stage`` yields an empty window and
        an unknown ``last_stage`` runs to the end — matching the reference's
        stepper, which in those cases never starts / never stops."""
        slots = self._slots()
        if first_stage is None:
            lo = 0
        elif first_stage.endswith('+'):
            lo = slots.index(first_stage[:-1]) + 1
        elif first_stage in slots:
            lo = slots.index(first_stage)
        else:
            lo = len(slots)
        hi = slots.index(last_stage) if last_stage in slots else len(slots) - 1
        return lo, hi

    def process_image(self, g_raw, cfg, first_stage=None, last_stage=None, data=None,
                      out=None, log_root_dir=None):
        """Segments an image.

        :return: ``(data, cfg, timings)`` — the pipeline data object with all
            intermediate and final results, the hyperparameters used, and the
            per-stage wall-clock timings in seconds.

        With ``first_stage`` set, ``data`` from a previous run must be passed
        and earlier stages are skipped (the batch pickup mechanism).
        """
        out = get_output(out)
        cfg = cfg.copy()
        if log_root_dir is not None:
            mkdir(log_root_dir)
        if data is None and first_stage == self._slots()[1]:
            first_stage = None  # a fresh run from the first stage includes init
        lo, hi = self._stage_window(first_stage, last_stage)
        if first_stage is not None and last_stage is not None and lo > hi:
            return data, cfg, {}
        if lo == 0:
            data = self.init(g_raw, cfg)
        else:
            assert data is not None, 'data argument must be provided if first_stage is used'
        timings = {}
        for index, stage in enumerate(self.stages, start=1):
            if lo <= index <= hi:
                timings[stage.name] = stage(data, cfg, out=out,
                                            log_root_dir=log_root_dir)
        return data, cfg, timings

    def init(self, g_raw, cfg):
        """Normalizes ``g_raw`` to [0, 1]; inverts histological RGB images.

        Non-finite pixels (dead/hot camera pixels) are replaced by the median
        of the finite pixels BEFORE normalization — a single inf otherwise
        collapses the normalization to zeros and silently produces an empty
        segmentation (the reference behaves that way,
        ``superdsm/image.py:48``; sanitizing only non-finite
        inputs leaves every valid image bit-identical)."""
        g_raw = np.asarray(g_raw)
        finite = np.isfinite(g_raw)
        if not finite.all():
            fill = np.median(g_raw[finite]) if finite.any() else 0.0
            g_raw = np.where(finite, g_raw, fill)
        data = {}
        if cfg.get('histological', False):
            data['g_rgb'] = g_raw
            g_raw = g_raw.mean(axis=2)
            g_raw = g_raw.max() - g_raw
        data['g_raw'] = normalize_image(g_raw)
        return data

    def find(self, stage_name, not_found_dummy=np.inf):
        """Position of the stage named ``stage_name`` (or ``not_found_dummy``)."""
        for index, stage in enumerate(self.stages):
            if stage.name == stage_name:
                return index
        return not_found_dummy

    def append(self, stage, after=None):
        if after is None:
            self.stages.append(stage)
            return
        position = self.find(after) if isinstance(after, str) else after
        self.stages.insert(position + 1, stage)


def create_pipeline(stages):
    """Builds a :class:`Pipeline`, ordering stages by their declared I/O
    (ready-set topological sort seeded with the raw image)."""
    pipeline = Pipeline()
    provided = {'g_raw'}
    pending = list(stages)
    while pending:
        ready = next((stage for stage in pending
                      if provided.issuperset(stage.inputs)), None)
        if ready is None:
            raise ValueError('failed to resolve total ordering')
        pending.remove(ready)
        provided.update(ready.outputs)
        pipeline.append(ready)
    return pipeline


def create_default_pipeline():
    """The default five-stage pipeline (preprocess → dsm → c2f → gem → post)."""
    from .preprocess import Preprocessing
    from .dsmcfg import DSM_Config
    from .c2freganal import C2F_RegionAnalysis
    from .globalenergymin import GlobalEnergyMinimization
    from .postprocess import Postprocessing

    return create_pipeline([
        Preprocessing(),
        DSM_Config(),
        C2F_RegionAnalysis(),
        GlobalEnergyMinimization(),
        Postprocessing(),
    ])
