"""The span recorder (``superdsm_tpu_torch.trace``) on the CPU: off it records
nothing and calls nothing; on it keeps parents and image ids across worker
threads and pools, counts how every solved lane ended, and leaves what the
program computes bitwise as it was."""

import collections
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import superdsm_tpu_torch as T
from superdsm_tpu_torch import automation, trace
from superdsm_tpu_torch.dsm import batching, solver
from superdsm_tpu_torch.image import Image
from superdsm_tpu_torch.output import get_output
from superdsm_tpu_torch.render import rasterize_labels

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _recorder():
    """Each test starts and ends with the recorder off and empty."""
    trace.enable(False)
    trace.drain()
    with T.use_device('cpu'):
        yield
    trace.enable(False)
    trace.drain()


def _blobs(seed=0, size=120):
    rr, cc = np.indices((size, size))
    g = sum(np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * (rad * 0.7) ** 2)))
            for r0, c0, rad in [(40, 40, 14), (40, 66, 12), (90, 90, 14)])
    g += np.random.RandomState(seed).randn(size, size) * 0.02
    return g.astype(np.float32)


_CFG = {'AF_scale': 12, 'c2f-region-analysis/min_atom_radius': 6,
        'global-energy-minimization/beta': 0.5}


def _segment(g):
    data, _, timings = automation.process_image(
        T.create_default_pipeline(), T.Config(dict(_CFG)), g,
        out=get_output(None).derive(muted=True))
    return data, timings


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s['name']].append(s)
    return out


@pytest.mark.parametrize('name', ['sdsm.image', 'sdsm.stage.c2f-region-analysis',
                                  'sdsm.solve.fetch'])
def test_off_records_nothing_and_calls_nothing(monkeypatch, name):
    def refuse(*args, **kwargs):
        raise AssertionError('a profiler range opened while the recorder is off')

    monkeypatch.setattr(trace, '_RANGE', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    fn = lambda: None  # noqa: E731
    assert trace.span(name) is trace.OFF and trace.span(name, k=1) is trace.OFF
    with trace.span(name) as span:
        assert span is trace.OFF
        span.times(0.0, 1.0)
        trace.count('dsm.converged', 3)
        assert trace.carry(fn) is fn
    assert trace.drain() == dict(spans=[], dropped=0, counts={})


def test_on_a_span_is_a_profiler_range():
    trace.enable(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span('sdsm.solve.fetch'):
            torch.ones(4).sum()
    span, = trace.drain()['spans']
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == span['name']]
    assert len(ranges) == 1


def test_parents_and_images_across_a_worker_thread_and_a_pool():
    trace.enable(True)
    with ThreadPoolExecutor(max_workers=2) as pool:

        def cluster(k):
            with trace.span('sdsm.c2f.cluster', k=k):
                return threading.get_ident()

        def worker():
            with trace.span(trace.IMAGE):
                with trace.span('sdsm.c2f.advance'):
                    return list(pool.map(trace.carry(cluster), range(4)))

        with ThreadPoolExecutor(max_workers=1) as outer:
            pool_threads = outer.submit(worker).result(timeout=60)
    spans = _by_name(trace.drain()['spans'])
    image, = spans[trace.IMAGE]
    advance, = spans['sdsm.c2f.advance']
    clusters = spans['sdsm.c2f.cluster']
    assert image['parent'] is None and image['image'] is not None
    assert advance['parent'] == image['id'] and advance['image'] == image['image']
    assert sorted(c['attrs']['k'] for c in clusters) == [0, 1, 2, 3]
    for c in clusters:
        assert c['parent'] == advance['id'] and c['image'] == image['image']
        assert c['thread'] != advance['thread'] and c['thread'] in pool_threads
        assert advance['start'] <= c['start'] <= c['end'] <= advance['end']
        assert c['cpu'] >= 0.0


def test_two_threads_keep_two_images():
    trace.enable(True)
    both_open = threading.Barrier(2, timeout=60)

    def image():
        with trace.span(trace.IMAGE):
            # an image span inside an open image opens no new id
            with trace.span(trace.IMAGE) as inner:
                assert inner is trace.OFF
                both_open.wait()
                with trace.span('sdsm.solve'):
                    trace.count('dsm.converged')

    threads = [threading.Thread(target=image) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans = _by_name(trace.drain()['spans'])
    images = {s['thread']: s['image'] for s in spans[trace.IMAGE]}
    assert len(images) == 2 and len(set(images.values())) == 2
    for s in spans['sdsm.solve']:
        assert s['image'] == images[s['thread']] and s['counts'] == {'dsm.converged': 1}


def test_many_threads_lose_no_span_or_count():
    """More threads than cores, the interpreter switching threads often:
    every span and count arrives."""
    trace.enable(True)
    n_threads, n_spans = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with trace.span(trace.IMAGE):
                for _ in range(n_spans):
                    with trace.span('sdsm.c2f.cluster'):
                        trace.count('poly.converged')
                    trace.count('dsm.capped')

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    drained = trace.drain()
    spans = _by_name(drained['spans'])
    assert drained['dropped'] == 0
    assert len(spans['sdsm.c2f.cluster']) == n_threads * n_spans
    assert len({s['id'] for s in drained['spans']}) == len(drained['spans'])
    assert sum(s['counts']['poly.converged'] for s in spans['sdsm.c2f.cluster']) \
        == n_threads * n_spans
    assert sum(s['counts']['dsm.capped'] for s in spans[trace.IMAGE]) == n_threads * n_spans


def test_records_beyond_the_limit_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(trace, 'MAX_RECORDS', 3)
    trace.enable(True)
    for _ in range(5):
        with trace.span('sdsm.solve'):
            pass
    trace.count('dsm.canonical', 2)  # no span open: counted on its own
    drained = trace.drain()
    assert len(drained['spans']) == 3 and drained['dropped'] == 2
    assert drained['counts'] == {'dsm.canonical': 2}


def test_telemetry_prints_from_spans_it_does_not_hold(monkeypatch, capsys):
    """``SDSM_SOLVE_TELEMETRY``'s recorder (on, keeping nothing) prints its
    lines from the spans as they close, and holds none however many images
    run."""
    monkeypatch.setattr(batching, '_TELEMETRY', True)
    trace.enable(True, keep=False)
    for seed in range(2):
        _segment(_blobs(seed=seed))
    for _ in range(10_000):
        with trace.span(trace.IMAGE):
            with trace.span('sdsm.solve'):
                trace.count('dsm.converged')
    err = capsys.readouterr().err
    for prefix in ('[solve_problems]', '[c2f]', '[c2f-drive]', '[compute_objects]'):
        assert err.count(prefix) >= 2, prefix
    assert trace.drain() == dict(spans=[], dropped=0, counts={})


def test_stage_timing_is_the_stage_span():
    trace.enable(True)
    data, timings = _segment(_blobs())
    spans = _by_name(trace.drain()['spans'])
    image, = spans[trace.IMAGE]
    for stage, seconds in timings.items():
        span, = spans[f'sdsm.stage.{stage}']
        assert span['end'] - span['start'] == seconds
        assert span['parent'] == image['id'] and span['image'] == image['image']
    # every span of the field belongs to its one image, nested in it
    for s in sum(spans.values(), []):
        assert s['image'] == image['image']
        assert image['start'] <= s['start'] <= s['end'] <= image['end']


def _problems(n=6, seed=0, size=40):
    rng = np.random.RandomState(seed)
    rr, cc = np.indices((size, size))
    out = []
    for k in range(n):
        r0, c0 = size // 2 + rng.randint(-3, 4), size // 2 + rng.randint(-3, 4)
        rad = size / 5 + k % 4
        model = np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * rad ** 2))) - 0.3
        model += rng.randn(size, size) * 0.05
        mask = (rr - size / 2) ** 2 + (cc - size / 2) ** 2 < (size / 2.5) ** 2
        region = Image(model=model, mask=mask)
        out.append(batching.make_problem(region, img_shape=(size, size), smooth_amount=3,
                                         smooth_subsample=10, tag=k))
    return out


@pytest.mark.parametrize('smooth_amount,maxiter', [(np.inf, 50), (3, 50), (3, 2)])
def test_lane_causes_sum_to_the_lanes_solved(monkeypatch, smooth_amount, maxiter):
    stored = collections.Counter()
    store = batching._store_results

    def counted(results, problems, kind, chunk, row, fetch):
        stored[kind.split('-')[0]] += len(chunk)
        return store(results, problems, kind, chunk, row, fetch)

    monkeypatch.setattr(batching, '_store_results', counted)
    trace.enable(True)
    batching.solve_problems(_problems(), smooth_amount=smooth_amount, maxiter=maxiter)
    spans = trace.drain()['spans']
    causes = collections.Counter()
    for s in spans:
        causes.update(s['counts'])
    assert stored  # lanes were solved
    for kind, lanes in stored.items():
        assert sum(causes[f'{kind}.{c}'] for c in ('converged', 'capped', 'fallback')) == lanes
    assert sum(stored.values()) == sum(v for k, v in causes.items() if k != 'dsm.canonical')
    canonical = [s for s in spans if s['name'] == 'sdsm.solve.canonical']
    assert causes['dsm.canonical'] == sum(s['attrs']['lanes'] for s in canonical)
    if np.isfinite(smooth_amount):
        assert stored['dsm'] == 6
    if maxiter == 2:
        assert causes['dsm.capped'] > 0
    solve, = [s for s in spans if s['name'] == 'sdsm.solve']
    assert {s['parent'] for s in spans if s['name'] == 'sdsm.solve.fetch'} <= \
        {solve['id']} | {s['id'] for s in canonical}


def test_recorder_leaves_the_results_bitwise():
    g = _blobs(seed=1)
    results = []
    for on in (False, True):
        trace.enable(on)
        solver.reset_loop_stats()
        data, _ = _segment(g)
        results.append((rasterize_labels(data),
                        [o.energy for o in data['objects']],
                        dict(solver.LOOP_STATS)))
        trace.enable(False)
    (labels0, energies0, loop0), (labels1, energies1, loop1) = results
    assert np.array_equal(labels0, labels1) and labels0.max() > 0
    assert energies0 == energies1
    assert loop0 == loop1 and loop0['iterations'] > 0
    assert trace.drain()['spans']  # the second run was recorded
