"""The port's renderers, colormaps and metrics against the JAX package's.

- Every render function of ``superdsm_tpu_torch.render`` on the JAX
  pipeline's result for the 120x120 field of ``tests/test_render_goldens.py``
  (carried into the port with ``interop.from_jax``), bitwise against the JAX
  function on the JAX result.
- The port's own pipeline result against the goldens in
  ``tests/regression/expected/render/`` at that file's tolerance: at most 2%
  of the pixels off by more than 2/255 (the label map: 1% off at all).
- The three carried colormaps against matplotlib at 1,000 points in
  [-0.1, 1.1], bitwise.
- ``metrics`` against the JAX functions, exactly.
"""

import pathlib

import matplotlib
import numpy as np
import pytest
import torch

import superdsm_tpu.metrics as jax_metrics
import superdsm_tpu.render as jax_render
import superdsm_tpu_torch as T
from superdsm_tpu_torch import interop
from superdsm_tpu_torch import metrics as port_metrics
from superdsm_tpu_torch import render as port_render
from superdsm_tpu_torch.io import imread

torch.set_num_threads(1)

GOLDEN_DIR = pathlib.Path(__file__).parent / 'regression' / 'expected' / 'render'
_CFG = {'AF_scale': 10, 'c2f-region-analysis': {'min_atom_radius': 6},
        'global-energy-minimization': {'beta': 0.5}}


def _field():
    rr, cc = np.indices((120, 120))
    g = sum(np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * (rad * 0.7) ** 2)))
            for r0, c0, rad in [(40, 40, 14), (40, 66, 12), (90, 90, 14)])
    g = g + np.random.RandomState(0).randn(120, 120) * 0.02
    return g.astype(np.float32)


def _sorted(result):
    for key in ('objects', 'postprocessed_objects'):
        result[key] = sorted(result[key], key=lambda obj: tuple(obj.fg_offset))
    return result


@pytest.fixture(scope='module')
def jax_data():
    from superdsm_tpu.automation import process_image
    from superdsm_tpu.config import Config
    from superdsm_tpu.output import get_output
    from superdsm_tpu.pipeline import create_default_pipeline
    result, _, _ = process_image(create_default_pipeline(), Config(_CFG), _field(),
                                 out=get_output(None).derive(muted=True))
    return _sorted(result)


@pytest.fixture(scope='module')
def carried(jax_data):
    return interop.from_jax(jax_data)


@pytest.fixture(scope='module')
def port_data():
    from superdsm_tpu_torch.output import get_output
    with T.use_device('cpu'):
        result, _, _ = T.automation.process_image(
            T.create_default_pipeline(), T.Config(_CFG), _field(),
            out=get_output(None).derive(muted=True))
    return _sorted(result)


#: name -> f(render module, data): every render function of the module
RENDERS = {
    'render_ymap': lambda R, d: R.render_ymap(d),
    'render_ymap_seismic': lambda R, d: R.render_ymap(d['y'], clim=(-0.3, 0.4),
                                                      cmap='seismic'),
    'render_atoms': lambda R, d: R.render_atoms(d, normalize_img=False),
    'render_atoms_normalized': lambda R, d: R.render_atoms(d),
    'render_foreground_clusters': lambda R, d: R.render_foreground_clusters(
        d, normalize_img=False),
    'render_adjacencies': lambda R, d: R.render_adjacencies(d, normalize_img=False),
    'render_adjacencies_over_ymap': lambda R, d: R.render_adjacencies(
        d, override_img=R.render_atoms(d, override_img=R.render_ymap(d),
                                       border_color=(0, 0, 0), border_radius=1),
        edge_color=(0, 1, 0), endpoint_color=(0, 1, 0)),
    'render_result_over_image': lambda R, d: R.render_result_over_image(
        d, normalize_img=False),
    'render_result_inner': lambda R, d: R.render_result_over_image(
        d, border_width=4, border_position='inner', color='y'),
    'render_result_outer': lambda R, d: R.render_result_over_image(
        d, border_width=4, border_position='outer', color='r'),
    'normalize_image': lambda R, d: R.normalize_image(d['g_raw']),
    'rasterize_labels': lambda R, d: R.rasterize_labels(d),
    'rasterize_labels_dilated': lambda R, d: R.rasterize_labels(
        d, dilate=2, merge_overlap_threshold=0.5),
    'rasterize_regions': lambda R, d: np.stack(R.rasterize_regions(
        d['atoms'], background_label=0, radius=2)),
    'render_regions_over_image': lambda R, d: R.render_regions_over_image(
        d['g_raw'], d['clusters'], background_label=0),
    'colorize_labels': lambda R, d: R.colorize_labels(R.rasterize_labels(d)),
    'colorize_labels_shuffled': lambda R, d: R.colorize_labels(
        R.rasterize_labels(d), shuffle=3),
    'shuffle_labels': lambda R, d: R.shuffle_labels(d['atoms'], bg_label=0, seed=1),
    'draw_line': lambda R, d: R.draw_line((10.5, 7), (80, 101.25), 3, (120, 120)),
    'contour_paint_outer': lambda R, d: R.ContourPaint(
        R.rasterize_labels(d) > 0, 3, where='outer').get_contour_mask(
            R.rasterize_labels(d) == 1),
}


@pytest.mark.parametrize('name', sorted(RENDERS))
def test_render_bitwise_against_jax(name, jax_data, carried):
    ref = np.asarray(RENDERS[name](jax_render, jax_data))
    got = np.asarray(RENDERS[name](port_render, carried))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


def _to_uint8(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    if img.dtype.kind == 'f':
        return np.clip(np.round(img * 255), 0, 255).astype(np.uint8)
    return img.astype(np.uint8)


#: golden name -> (render, share of pixels allowed off, tolerance)
GOLDENS = {
    'render_ymap': ('render_ymap', 0.02, 2),
    'render_atoms': ('render_atoms', 0.02, 2),
    'render_foreground_clusters': ('render_foreground_clusters', 0.02, 2),
    'render_adjacencies': ('render_adjacencies', 0.02, 2),
    'render_result_over_image': ('render_result_over_image', 0.02, 2),
    'normalize_image': ('normalize_image', 0.02, 2),
    'rasterize_labels': ('rasterize_labels', 0.01, 0),
    'colorize_labels': ('colorize_labels', 0.02, 2),
}


@pytest.mark.parametrize('name', sorted(GOLDENS))
def test_port_pipeline_against_render_goldens(name, port_data):
    render, max_diff_frac, tol = GOLDENS[name]
    img = _to_uint8(RENDERS[render](port_render, port_data))
    golden = imread(str(GOLDEN_DIR / f'{name}.png'), as_gray=False)
    assert golden.shape == img.shape
    frac = float((np.abs(img.astype(int) - golden.astype(int)) > tol).mean())
    assert frac <= max_diff_frac, f'{name}: {100 * frac:.2f}% of pixels off'


@pytest.mark.parametrize('cmap', ['bwr', 'seismic', 'gist_rainbow'])
def test_colormaps_bitwise_against_matplotlib(cmap):
    x = np.linspace(-0.1, 1.1, 1000)
    ref = matplotlib.colormaps[cmap]
    got = port_render.get_cmap(cmap)
    assert np.array_equal(got(x), ref(x))
    assert np.array_equal(got(x.astype(np.float32)), ref(x.astype(np.float32)))
    assert np.array_equal(got(np.array([np.nan, 0.0, 1.0])),
                          ref(np.array([np.nan, 0.0, 1.0])), equal_nan=True)
    assert np.array_equal(got(np.arange(-2, 260)), ref(np.arange(-2, 260)))


def test_other_colormaps_come_from_matplotlib():
    x = np.linspace(0, 1, 50)
    cmap = port_render.get_cmap('viridis')
    assert cmap.name == 'viridis'
    assert np.array_equal(cmap(x), matplotlib.colormaps['viridis'](x))


def _label_maps(seed):
    rng = np.random.RandomState(seed)
    a = np.zeros((60, 60), int)
    b = np.zeros((60, 60), int)
    for label in range(1, 7):
        r, c = rng.randint(5, 50, 2)
        a[r:r + 9, c:c + 9] = label
        dr, dc = rng.randint(-2, 3, 2)
        b[r + dr:r + dr + 8, c + dc:c + dc + 10] = label + 10 * (label % 2)
    return a, b


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_metrics_equal_jax(seed):
    a, b = _label_maps(seed)
    assert port_metrics.dice(a, b) == jax_metrics.dice(a, b)
    assert port_metrics.seg_score(a, b) == jax_metrics.seg_score(a, b)
    assert port_metrics.object_based_f1(a, b, 0.3) == \
        jax_metrics.object_based_f1(a, b, 0.3)
