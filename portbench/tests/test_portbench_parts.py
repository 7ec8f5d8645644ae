"""The generators, the work count and the plain reference at tiny sizes."""

import math

import numpy as np
import scipy.ndimage as ndi
import torch

from portbench import check, harness, roofline
from portbench.reference import dsm, offsets

BIG_SEED = 2 ** 31 + 977


def _params(name):
    return harness.load_json('configs', name)['assumed']


def test_fields_repeat_from_the_seed_and_differ_by_index():
    gen = harness.load_module('gen', 'fields')
    p = dict(_params('bbbc039'), height=120, width=160, nuclei=6)
    a, n = gen.make(BIG_SEED, 0, p)
    b, _ = gen.make(BIG_SEED, 0, p)
    c, _ = gen.make(BIG_SEED, 1, p)
    assert a.dtype == np.float32 and a.shape == (120, 160) and n.shape == (6, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_bbbc039_field_has_the_dataset_density():
    gen = harness.load_module('gen', 'fields')
    _, n = gen.make(BIG_SEED, 3, _params('bbbc039'))
    assert 110 <= len(n) <= 115


def test_glare_field_has_glare_and_gradient():
    gen = harness.load_module('gen', 'glare_fields')
    p = dict(_params('nih3t3'), height=200, width=260, nuclei=3, radius=20.0)
    g, n = gen.make(BIG_SEED, 0, p)
    plain = harness.load_module('gen', 'fields').make(BIG_SEED, 0, p)[0]
    assert g.max() > 2.0 > plain.max()


def test_nonzeros_per_pixel_against_brute_force():
    rng = np.random.default_rng(0)
    pts = rng.integers(0, 40, (200, 2))
    sub = rng.integers(0, 40, (15, 2))
    got = roofline.nonzeros_per_pixel(pts, sub, 7)
    want = ((np.abs(pts[:, None, 0] - sub[None, :, 0]) <= 7)
            & (np.abs(pts[:, None, 1] - sub[None, :, 1]) <= 7)).sum(1)
    assert np.array_equal(got, want)


def test_gaussian_filter_is_scipys():
    x = np.random.default_rng(1).random((37, 53))
    for sigma in (math.sqrt(2), 9.0, 40.0):
        got = offsets.gaussian_filter(torch.as_tensor(x), sigma, torch.float64).numpy()
        want = ndi.gaussian_filter(x, sigma, truncate=4.0)
        assert np.abs(got - want).max() < 1e-12


def test_newton_reaches_the_minimum_of_an_ellipse():
    rr, cc = np.indices((30, 40))
    inside = ((rr - 14) / 8.0) ** 2 + ((cc - 20) / 12.0) ** 2 <= 1
    pts = np.argwhere(np.ones((30, 40), bool))
    y = np.where(inside, 1.0, -1.0)[pts[:, 0], pts[:, 1]] \
        + np.random.default_rng(2).normal(0, 0.3, len(pts))
    region = dsm.Region(pts, (0, 0), (30, 40), y, np.zeros((0, 2)), 0.5, 1.0,
                        np.inf, 2, 'cpu')
    e, converged, _ = dsm.minimize(region)
    assert converged
    g, _ = region.grad_hess(torch.zeros(6, dtype=torch.float64))
    assert e < float(region.energy(torch.zeros(6, dtype=torch.float64)))


def test_planted_nuclei_are_where_the_image_is_bright():
    gen = harness.load_module('gen', 'fields')
    p = dict(_params('bbbc039'), height=120, width=160, nuclei=5)
    img, nuclei = gen.make(BIG_SEED, 2, p)
    r, c = np.rint(nuclei[:, :2]).astype(int).T
    assert np.all(img[r, c] > 0.5) and np.all(nuclei[:, 2] > 0)


def test_label_stats_finds_merges_misses_and_spurious_objects():
    labels = np.zeros((60, 90), np.int32)
    labels[5:15, 5:15] = 1     # nucleus a, found
    labels[20:30, 5:40] = 2    # nuclei b and c, merged
    labels[45:55, 70:80] = 3   # spurious
    labels[40:50, 5:15] = 4    # nucleus e, centroid 4 px off (radius 5)
    nuclei = np.array([[9.5, 9.5, 5], [24.5, 10, 5], [24.5, 35, 5], [9.5, 60, 5],
                       [40.5, 9.5, 5]], float)
    planted, spurious, dist = check.label_stats(labels, nuclei)
    assert (planted, spurious) == (5, 1) and len(dist) == 2
    assert np.allclose(sorted(dist), [0.0, 0.8])
    # found: a alone (e lies beyond 0.5 radii); missed: b, c, d, e; spurious 1
    assert check.label_error_share([(planted, spurious, dist)], 0.5) == 5 / 5
    assert check.label_error_share([(planted, spurious, dist)], 1.0) == 4 / 5


def test_device_ms_per_image_counts_the_union_until_the_last_image():
    from types import SimpleNamespace

    from portbench import devtrace
    trace = object.__new__(devtrace.Trace)
    # two overlapping activities, one past the last image, one before the open
    trace.device = [('a', 1.0, 1.5), ('b', 1.25, 2.0), ('c', 3.5, 4.0), ('d', 0.0, 0.5)]
    run = SimpleNamespace(trace=trace, t0=1.0, t_end=3.0,
                          done=[dict(start=1.0, end=2.0), dict(start=1.1, end=3.0)])
    read = harness.load_module('end_to_end', 'device_ms_per_image').read
    assert math.isclose(read(run), 1e3 * 1.0 / 2)
    assert read(SimpleNamespace(trace=None, done=run.done)) is None
