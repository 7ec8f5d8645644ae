"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell is made of is found by name under this folder:
``configs/<config>.json`` (the deployment: its settings and the generator's
parameters), ``traffic/<mix>.json`` (how images reach the program, read by
the traffic mode ``modes/<mode>.py`` that it names), ``gen/<generator>.py``
(images and their planted nuclei from the seed), ``end_to_end/<metric>.py``
and ``metrics/<metric>.py`` (one reader per metric) and
``limits/<config>.json`` (the check's limits). :func:`run_cell` takes names
and returns the result object that ``run.py`` prints.
"""

import copy
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

from portbench import check, probes
from portbench import devtrace as tracemod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(kind, name):
    with open(os.path.join(HERE, kind, f'{name}.json')) as f:
        return json.load(f)


def load_module(kind, name):
    path = os.path.join(HERE, kind, f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'portbench_{kind}_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """The state one run builds; the metric readers and the check read it.

    ``records``: per window image (by order of hand-off) its hand-off and
    label-map times, stage timings, offset image, label map and error.
    """

    def __init__(self, config, traffic, seed, seconds, device):
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.device = int(seed), float(seconds), device
        self.records = {}
        self.repeats = 0
        self.trace = None
        self.recorder = probes.SolveRecorder()
        self.spans = probes.StageSpans(self.recorder)
        self.loop_before = self.loop_after = None
        self.t0 = self.t_end = None
        self.cpu0 = self.cpu1 = None
        self.peak_window_bytes = None
        self.setup_s = None
        self.barrier = None
        self.check_details = None

    # -- set-up ---------------------------------------------------------
    def make_images(self):
        """The plate: ``plate_fields`` fields made from the configuration's
        plate seed, and one warm-up field per worker after them. The run's
        seed sets the order in which the window visits the fields, one pass
        after another, and the flip of each field in each pass (identity,
        up-down, left-right, both): every seed gets the same fields, so
        the same work, in another order, and a field comes back only in
        another flip until four passes are spent (further passes repeat,
        and are counted)."""
        p = self.config['assumed']
        gen = load_module('gen', p['generator'])
        plate = self.config['plate']
        n = plate['fields']
        n_warm = self.traffic['threads'] * self.traffic['warmup_images_per_worker']
        made = [gen.make(plate['seed'], i, p) for i in range(n + n_warm)]
        self.fields = [img for img, _ in made[:n]]
        self.planted = [nuclei for _, nuclei in made[:n]]
        self.warm_images = [img for img, _ in made[n:]]
        self.order_rng = np.random.default_rng([self.seed & 0xFFFFFFFFFFFF, 1])
        self.first_flip = self.order_rng.integers(0, 4, n)
        self.passes = []

    def visit(self, k):
        """``(field, flip)`` of the window's ``k``-th hand-off."""
        n = len(self.fields)
        while len(self.passes) <= k // n:
            self.passes.append(self.order_rng.permutation(n))
        field = int(self.passes[k // n][k % n])
        return field, int((self.first_flip[field] + k // n) % 4)

    def image(self, k):
        field, flip = self.visit(k)
        img = self.fields[field]
        if flip & 1:
            img = img[::-1]
        if flip & 2:
            img = img[:, ::-1]
        return np.ascontiguousarray(img)

    def truth(self, k):
        """The planted nuclei of the window's ``k``-th image, flipped as the
        image is: ``(n, 3)`` row, column, radius."""
        field, flip = self.visit(k)
        nuclei = self.planted[field].copy()
        H, W = self.fields[field].shape
        if flip & 1:
            nuclei[:, 0] = H - 1 - nuclei[:, 0]
        if flip & 2:
            nuclei[:, 1] = W - 1 - nuclei[:, 1]
        return nuclei

    def base_config(self):
        import superdsm_tpu_torch as port
        return port.Config(copy.deepcopy(self.config['config']))

    # -- one image --------------------------------------------------------
    def run_image(self, pipeline, cfg, item, out):
        """Processes one hand-off: a warm-up image or a window image, up to
        its label map. Returns what ``process_images_pipelined`` expects."""
        from superdsm_tpu_torch import automation, render
        kind, k = item
        if kind == 'warm':
            img = self.warm_images[k]
            automation.process_image(pipeline, cfg, img, out=out)
            if self.barrier is not None:
                self.barrier.wait()
            return None, None, None
        t_start = time.perf_counter()
        if t_start >= self.deadline:
            return None, None, None
        rec = dict(start=t_start)
        self.records[k] = rec
        self.recorder.image(k)
        try:
            data, _, timings = automation.process_image(pipeline, cfg, self.image(k), out=out)
            labels = render.rasterize_labels(data)
            rec.update(timings=timings, y=data['y'], labels=labels)
        except Exception as err:  # a failed image is counted and reported
            rec['error'] = repr(err)
        finally:
            self.recorder.image(None)
            rec['end'] = time.perf_counter()
        return None, None, None

    def window_started(self):
        import torch
        if self.device != 'cpu':
            torch.cuda.synchronize()
        from superdsm_tpu_torch.dsm import solver
        self.loop_before = dict(solver.LOOP_STATS)
        self.cpu0 = time.process_time()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds

    def window_closed(self):
        import torch
        if self.device != 'cpu':
            torch.cuda.synchronize()
        ends = [r['end'] for r in self.records.values()]
        self.t_end = max(ends) if ends else time.perf_counter()
        self.cpu1 = time.process_time()
        from superdsm_tpu_torch.dsm import solver
        self.loop_after = dict(solver.LOOP_STATS)
        if self.device != 'cpu':
            self.peak_window_bytes = torch.cuda.max_memory_allocated()

    # -- the window ------------------------------------------------------
    def drive(self):
        """Warm-up and the window, by the traffic mix's mode
        (``modes/<mode>.py``), under the profiler in every run: the
        end-to-end ``device_ms_per_image`` is read from its trace, so a
        ``--trace 0`` run and a ``--trace 1`` run differ only in the metrics
        they print."""
        import torch
        from superdsm_tpu_torch.output import get_output
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device != 'cpu':
            acts.append(ProfilerActivity.CUDA)
        # started here, in the thread that stops it; the window is cut out
        # of the trace by its times
        prof = profile(activities=acts)
        prof.start()
        self.mark_perf = time.perf_counter()
        with torch.profiler.record_function(tracemod.MARK):
            pass
        out = get_output(None).derive(muted=True)
        window = [('img', k) for k in range(64 * len(self.fields))]
        for k in range(len(window)):
            self.visit(k)  # the order, drawn before the window
        warm = [('warm', k) for k in range(len(self.warm_images))]
        self.deadline = math.inf
        mode = load_module('modes', self.traffic['mode'])
        mode.drive(self, self.base_config(), warm, window, out)
        self.repeats = max(0, len(self.records) - 4 * len(self.fields))
        prof.stop()
        if self.device != 'cpu':
            self.trace = tracemod.Trace(prof, self.mark_perf)

    # -- what the readers see ---------------------------------------------
    @property
    def failed(self):
        return sum(1 for r in self.records.values() if 'error' in r)

    @property
    def done(self):
        return [r for r in self.records.values() if r.get('error') is None]

    @property
    def t1(self):
        """The window's close: hand-offs stop here; the images in flight
        finish after it (until ``t_end``) and are checked."""
        return self.t0 + self.seconds

    @property
    def window_s(self):
        return self.seconds

    def images_in_window(self):
        """Images done in the window: each image counts by the share of its
        own seconds that falls inside ``[t0, t1]``, so that the images in
        flight at the close count by the part of them done in it."""
        return sum((min(r['end'], self.t1) - max(r['start'], self.t0)) / (r['end'] - r['start'])
                   for r in self.done if r['end'] > r['start'])

    def loop_delta(self, key):
        return self.loop_after[key] - self.loop_before[key]


def read_metrics(run, specs, kind):
    """Each metric's reader, ``<kind>/<name>.py``, by name; a reader that
    finds nothing returns None, and its metric is left out and named on
    standard error."""
    out = {}
    for spec in specs:
        value = load_module(kind, spec['name']).read(run)
        if value is not None and math.isfinite(value):
            out[spec['name']] = dict(value=float(value), unit=spec['unit'])
        else:
            print(f'metric {spec["name"]} read nothing', file=sys.stderr)
    return out


def breakdown(run):
    """The device's top operations and its longest idle time by what the
    host was doing (the stage spans open during each gap)."""
    tr = run.trace
    by_stage = {}
    spans = run.spans.spans
    for a, b in tr.gaps(run.t0, run.t1):
        open_ = [(s, max(a, t0), min(b, t1)) for _, _, s, t0, t1 in spans
                 if t1 > a and t0 < b]
        covered = sum(e - s for _, s, e in open_)
        for stage, s, e in open_:
            by_stage[stage] = by_stage.get(stage, 0.0) + (b - a) * (e - s) / covered
        if not open_:
            by_stage['outside stages'] = by_stage.get('outside stages', 0.0) + (b - a)
    gaps = sorted(([k, v] for k, v in by_stage.items()), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=tr.top_ops(run.t0, run.t1, 10), idle_gaps=gaps)


def run_cell(workload, seed, seconds, trace, device='cuda', overrides=None,
             t_process=None):
    """Runs one cell once; returns ``(result, numbers, notes)``. ``overrides``
    (tests) replaces entries of the configuration's ``assumed`` and of the
    traffic mix."""
    import torch
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    cell = next(w for w in bench['workloads'] if w['name'] == workload)
    config = load_json('configs', cell['config'])
    traffic = load_json('traffic', cell['traffic'])
    limits = load_json('limits', cell['config'])
    if overrides:
        config['assumed'].update(overrides.get('assumed', {}))
        traffic.update(overrides.get('traffic', {}))
        config.update(overrides.get('config', {}))
        limits.update(overrides.get('limits', {}))
    import superdsm_tpu_torch as port
    from superdsm_tpu_torch.dsm import gram
    port.set_device(device)
    t_build = time.perf_counter()
    if device != 'cpu':
        for src in gram._KERNELS:
            gram._load(src)
    build_s = time.perf_counter() - t_build
    run = Run(config, traffic, seed, seconds, device)
    run.make_images()
    run.recorder.install()
    if trace and not run.recorder.gram_probe:
        run.recorder.uninstall()
        raise RuntimeError('the gram probe found no per-lane result store '
                           '(batching._store_results) to read the iterations from')
    try:
        run.drive()
    finally:
        run.recorder.uninstall()
    t_start = t_process if t_process is not None else t_build
    run.setup_s = run.t0 - t_start
    if trace:
        metrics = read_metrics(run, bench['per_layer'], 'metrics')
    else:
        metrics = read_metrics(run, bench['end_to_end'], 'end_to_end')
    dev = device_info(device, run)
    if trace and run.trace is not None:
        dev['busy_s'] = run.trace.busy(run.t0, run.t1)
        dev['window_s'] = run.window_s
    # the reference runs once the window has closed and the peak is read
    ok, numbers, notes = check.judge(run, limits, seed, 'cuda' if device != 'cpu' else 'cpu')
    notes = [f'images {len(run.records)} started, {run.images_in_window():.3f} done in '
             f'{run.window_s:.0f} s, the last done {run.t_end - run.t1:.1f} s after the close, '
             f'repeats {run.repeats}, build {build_s:.1f} s, the process\'s CPU seconds '
             f'from the open to the last image {run.cpu1 - run.cpu0:.2f}'] + notes
    result = dict(correct=bool(ok), attempted=len(run.records), failed=run.failed,
                  metrics=metrics, device=dev)
    if trace and run.trace is not None:
        result['breakdown'] = breakdown(run)
    # a number with nothing to judge reads null (and the run is not correct)
    result['check'] = {k: dict(value=v['value'] if math.isfinite(v['value']) else None,
                               limit=v['limit'])
                       for k, v in numbers.items()}
    return result, run, notes


def device_info(device, run):
    import torch
    if device == 'cpu':
        return dict(platform='cpu', kind='cpu', count=0, memory_peak_bytes=0)
    return dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                count=1, memory_peak_bytes=int(torch.cuda.max_memory_allocated()),
                intra_op_threads=torch.get_num_threads())

