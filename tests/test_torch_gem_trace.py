"""The global energy minimization's spans and counts, and the colony field
generator of the ``gowt1`` configuration, on the CPU.

One colony field (``portbench/gen/colony_fields.py``) at GOWT1's published
settings scaled to nuclei of radius 8 goes through
``automation.process_image`` twice: with the span recorder off, and with it
on and the benchmark's solve probe (``portbench/probes.SolveRecorder``)
around the solver. The counts must add up (``grown = pruned + solved``,
``kept <= solved``), ``solved`` must equal the warm-started lanes the probe
saw, and the label maps of the two runs must be bitwise equal.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import superdsm_tpu_torch as T
from portbench import probes
from portbench.gen import colony_fields
from superdsm_tpu_torch import automation, trace
from superdsm_tpu_torch.output import get_output
from superdsm_tpu_torch.render import rasterize_labels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOWT1 = json.load(open(os.path.join(REPO, 'portbench', 'configs', 'gowt1.json')))
RADIUS = 8.0


def _segment(img):
    cfg = copy.deepcopy(GOWT1['config'])
    cfg['AF_scale'] = RADIUS / np.sqrt(2)
    with T.use_device('cpu'):
        data, _, _ = automation.process_image(T.create_default_pipeline(), T.Config(cfg), img,
                                              out=get_output(None).derive(muted=True))
    return data


@pytest.fixture(scope='module')
def runs():
    p = dict(GOWT1['assumed'], radius=RADIUS, height=128, width=128, nuclei=8, colonies=2)
    img = colony_fields.make(5, 0, p)[0]
    off = _segment(img)
    rec = probes.SolveRecorder()
    rec.install()
    trace.enable(True)
    try:
        rec.image(0)
        on = _segment(img)
    finally:
        rec.image(None)
        rec.uninstall()
        drained = trace.drain()
        trace.enable(False)
    return off, on, drained['spans'], rec


def test_generation_counts_add_up(runs):
    _, _, spans, rec = runs
    gens = [s for s in spans if s['name'] == 'sdsm.gem.generation']
    first = [s for s in gens if s['attrs']['number'] == 1]
    later = [s for s in gens if s['attrs']['number'] > 1]
    assert len(first) == 1 and later, [s['attrs'] for s in gens]
    c = first[0]['counts']
    assert c['clusters'] >= 1 and c['atoms'] >= c['clusters'] >= c['direct']
    assert c['largest_cluster'] >= 3
    total = dict(grown=0, pruned=0, solved=0, kept=0)
    for s in later:
        k = {key: s['counts'].get(key, 0) for key in total}
        assert k['grown'] == k['pruned'] + k['solved'] and k['kept'] <= k['solved'], k
        for key in total:
            total[key] += k[key]
    assert total['solved'] > 0
    warm = sum(1 for s in rec.solves for p in s['problems'] if p.init_params is not None)
    assert total['solved'] == warm, (total, warm)


def test_bounds_estimate_and_split_spans(runs):
    _, _, spans, _ = runs
    names = {s['name'] for s in spans}
    assert {'sdsm.gem.bounds', 'sdsm.gem.estimate'} <= names
    parents = {s['id']: s['name'] for s in spans}
    for s in spans:
        if s['name'] == 'sdsm.gem.bounds':
            assert parents[s['parent']] == 'sdsm.gem.generation'
    clusters = [s['counts'] for s in spans if s['name'] == 'sdsm.c2f.cluster']
    tried = sum(c.get('splits_tried', 0) for c in clusters)
    kept = sum(c.get('splits_kept', 0) for c in clusters)
    assert tried >= kept > 0


def test_recorder_leaves_label_maps_bitwise_equal(runs):
    off, on, _, _ = runs
    assert np.array_equal(rasterize_labels(off), rasterize_labels(on))


def test_colony_fields_deterministic_and_planted():
    p = GOWT1['assumed']
    img, planted = colony_fields.make(1, 2, p)
    again, planted2 = colony_fields.make(1, 2, p)
    assert np.array_equal(img, again) and np.array_equal(planted, planted2)
    assert img.shape == (p['height'], p['width']) and img.dtype == np.float32
    for index in range(7):  # the plate's four fields and three warm-up fields
        assert len(colony_fields.make(1, index, p)[1]) == p['nuclei']
    other = colony_fields.make(1, 3, p)[0]
    assert not np.array_equal(img, other)
    rr, cc = np.indices(img.shape)
    inside = np.zeros(img.shape, bool)
    for r0, c0, rad in planted:
        assert p['border'] * p['radius'] <= r0 <= p['height'] - 1 - p['border'] * p['radius']
        assert (1 - p['radius_jitter']) * p['radius'] <= rad <= (1 + p['radius_jitter']) * p['radius']
        core = (rr - r0) ** 2 + (cc - c0) ** 2 <= (0.5 * rad) ** 2
        # a nucleus's core holds its level, darkened by nucleoli at most
        assert img[core].mean() > 0.6 * p['amplitude'][0]
        inside |= (rr - r0) ** 2 + (cc - c0) ** 2 <= (1.5 * rad) ** 2
        # each nucleus touches another of its colony
        d = np.hypot(planted[:, 0] - r0, planted[:, 1] - c0)
        assert np.sort(d)[1] <= (p['min_separation'] + 0.3) * p['radius'] + 1e-9
    assert abs(img[~inside].mean()) < 3 * p['noise'] / np.sqrt((~inside).sum()) + 1e-3
    assert img[~inside].std() == pytest.approx(p['noise'], rel=0.05)


def test_gem_metric_readers_read_the_solve_probe(runs):
    """``gem_candidates_per_image`` counts the same warm-started lanes as the
    generations' ``solved``; ``gem_candidate_iters_per_lane`` is their mean
    Newton iterations; a run with nothing recorded reads None."""
    from types import SimpleNamespace
    from portbench import harness
    _, _, spans, rec = runs
    solved = sum(s['counts'].get('solved', 0) for s in spans
                 if s['name'] == 'sdsm.gem.generation')
    run = SimpleNamespace(records={0: {}}, recorder=rec)
    per_image = harness.load_module('metrics', 'gem_candidates_per_image').read
    per_lane = harness.load_module('metrics', 'gem_candidate_iters_per_lane').read
    assert per_image(run) == solved
    warm = [it for p, _, it in rec.lanes if p.init_params is not None]
    assert rec.gram_probe and warm
    assert sum(warm) / solved <= per_lane(run) <= 50 * 2
    empty = SimpleNamespace(records={}, recorder=probes.SolveRecorder())
    assert per_image(empty) is None and per_lane(empty) is None


def test_dispatch_spans_give_the_chunk_histogram(runs):
    """Each DSM chunk's dispatch span carries its pixel bucket, parameter
    count and padded batch, and ``tools/gem_report.py`` builds the chunk
    histogram from them alone: its lanes are the probe's DSM problems."""
    import importlib.util
    from types import SimpleNamespace
    _, _, spans, rec = runs
    path = os.path.join(REPO, 'tools', 'gem_report.py')
    spec = importlib.util.spec_from_file_location('gem_report', path)
    gem_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gem_report)
    run = SimpleNamespace(program_spans=dict(spans=spans), t0=-np.inf, t1=np.inf)
    rows = gem_report.chunk_histogram(run)
    assert rows
    for stage, P, n, B, chunks, lanes in rows:
        assert stage in ('c2f-region-analysis', 'global-energy-minimization'), stage
        assert n > 6 and B & (B - 1) == 0 and chunks <= lanes <= chunks * B
    dsm = sum(1 for s in rec.solves for p in s['problems'] if len(p.sub))
    assert sum(r[-1] for r in rows) == dsm
    gem = sum(r[-1] for r in rows if r[0] == 'global-energy-minimization')
    warm = sum(1 for s in rec.solves for p in s['problems'] if p.init_params is not None)
    assert gem >= warm > 0
