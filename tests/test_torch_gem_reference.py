"""The port's global energy minimization against the exhaustive optimum, on
the CPU.

GOWT1's published settings (``portbench/configs/gowt1.json``: the c2f
splits with no improvement floor, exact pruning) scaled to nuclei of
radius 10 (``AF_scale`` 10 / sqrt(2)) on 160x160 colony fields of 8 nuclei
(``portbench/gen/colony_fields.py``) whose nucleoli lie 40 to 60% below
the nucleus's level, so that the c2f cuts them into clusters of 3 to 5
atoms. For each cluster of 3 to 12 atoms, the plain reference
(``portbench/reference/gem.py``) minimizes every connected footprint in
float64 and finds the least cover by a dynamic program; where that
optimum is defined (every footprint's minimum exists), the port's cover,
each footprint's energy taken from the reference, must cost at most the
reference's ``TOLERANCE`` (2% of the optimum: the port's float32 energies
stop up to about 2% above the float64 minimum at the Newton loop's
tolerance, stall test or cap, and the greedy set cover with its merge
step is not exact) above it. On these fields the port's covers are the
optimum's (gap 0). A gem stopped after its first generation (atoms and
universes only, the control) misses merges that cost 5% and 10% more.

A cluster whose footprints include a region the model separates has no
defined optimum: its energy has an infimum of 0 that no parameters attain,
and the port reports where its float32 Newton loop stopped (on a field of
radius-8 nuclei, seed 1, an atom of 191 positive pixels among 858 that
the port reports at energy 3,743 with parameters near 1e12; PERF.md, Open
questions). Such clusters are not judged.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import superdsm_tpu_torch as T
from portbench.gen import colony_fields
from portbench.reference import gem as ref
from superdsm_tpu_torch import automation, globalenergymin
from superdsm_tpu_torch.output import get_output

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOWT1 = json.load(open(os.path.join(REPO, 'portbench', 'configs', 'gowt1.json')))
SEEDS = (0, 1)
RADIUS = 10.0


def colony_image(seed):
    p = dict(GOWT1['assumed'], radius=RADIUS, height=160, width=160, nuclei=8, colonies=2,
             nucleolus_depth=[0.4, 0.6])
    return colony_fields.make(seed, 0, p)[0]


def segment(img):
    cfg = copy.deepcopy(GOWT1['config'])
    cfg['AF_scale'] = RADIUS / np.sqrt(2)
    with T.use_device('cpu'):
        data, _, _ = automation.process_image(T.create_default_pipeline(), T.Config(cfg), img,
                                              out=get_output(None).derive(muted=True))
    return data


def settings(dsm_cfg):
    return dict(alpha=dsm_cfg.get('alpha', 0.5), epsilon=dsm_cfg.get('epsilon', 1.0),
                smooth_amount=dsm_cfg.get('smooth_amount', 10),
                gaussian_shape_multiplier=dsm_cfg.get('gaussian_shape_multiplier', 2),
                smooth_subsample=dsm_cfg.get('smooth_subsample', 20),
                background_margin=dsm_cfg.get('background_margin', 20))


def gaps(data, optima):
    """Each judged cluster's gap: the port's cover at the reference's
    energies against the optimum."""
    cover = data['cover']
    return {label: ref.gap(ref.cover_cost(nu, [c.footprint for c in cover.solution_by_cluster[label]],
                                          cover.beta), opt)
            for label, (nu, opt) in optima.items()}


@pytest.fixture(scope='module')
def cases():
    """Per seed: the image, the port's data, and each cluster's reference
    energies and optimum."""
    out = {}
    for seed in SEEDS:
        img = colony_image(seed)
        data = segment(img)
        adj = data['adjacencies']
        optima = {}
        for label in sorted(adj.cluster_labels):
            labels = adj.get_atoms_in_cluster(label)
            if 3 <= len(labels) <= 12:
                nu, opt, _ = ref.cluster_optimum(
                    data['y'], data['y_mask'], data['atoms'], labels,
                    {a: adj[a] for a in labels}, data['cover'].beta, settings(data['dsm_cfg']))
                optima[label] = (nu, opt)
        out[seed] = (img, data, optima)
    return out


@pytest.mark.parametrize('seed', SEEDS)
def test_port_cover_is_the_exhaustive_optimum(cases, seed):
    _, data, optima = cases[seed]
    judged = {label: v for label, v in optima.items() if ref.defined(v[0])}
    assert judged, 'no cluster of 3 to 12 atoms with a defined optimum'
    got = gaps(data, judged)
    assert max(got.values()) <= ref.TOLERANCE, got


def test_control_stopped_after_generation_one_misses(cases, monkeypatch):
    monkeypatch.setattr(globalenergymin, '_process_generation', lambda *a, **k: ([], []))
    worst = []
    for seed in SEEDS:
        img, _, optima = cases[seed]
        judged = {label: v for label, v in optima.items() if ref.defined(v[0])}
        worst.append(max(gaps(segment(img), judged).values()))
    assert max(worst) > ref.TOLERANCE, worst


def test_cover_optimum_by_enumeration():
    """The dynamic program against every family of footprints, on a path
    of four atoms with random weights."""
    rng = np.random.default_rng(3)
    adjacency = {1: {2}, 2: {1, 3}, 3: {2, 4}, 4: {3}}
    fps = ref.connected_footprints([1, 2, 3, 4], adjacency)
    assert len(fps) == 10
    weights = {fp: float(rng.uniform(1, 10)) for fp in fps}
    best = min(
        sum(weights[fps[i]] for i in range(len(fps)) if m >> i & 1)
        for m in range(1, 1 << len(fps))
        if set().union(*(fps[i] for i in range(len(fps)) if m >> i & 1)) == {1, 2, 3, 4})
    cost, cover = ref.cover_optimum([1, 2, 3, 4], weights)
    assert cost == pytest.approx(best, rel=1e-12)
    assert set().union(*cover) == {1, 2, 3, 4}
