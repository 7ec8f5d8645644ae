"""The port's scale estimation against the JAX package's, on the CPU.

The same images go through ``superdsm_tpu.ops.blob.blob_doh`` /
``superdsm_tpu.automation._estimate_scale`` (JAX on the CPU) and their
counterparts in ``superdsm_tpu_torch`` (torch on the CPU): the blob field of
``tests/test_automation.py``, the real NIH3T3 crop and bench seeds 0 and 1.
Stated tolerances: blob coordinates and sigmas equal, responses to
rtol 1e-4 (float32 convolutions summed in different orders); the estimated
scale exactly equal (it is a mean of sigma-grid radii, so any detection
difference would show); the configuration equal entry for entry.
"""

import math
import os

import numpy as np
import PIL.Image
import jax
import jax.numpy as jnp
import pytest
import torch

from bench import make_image
from superdsm_tpu import automation as jauto
from superdsm_tpu.config import Config as JConfig
from superdsm_tpu.ops import blob as jblob
from superdsm_tpu.pipeline import create_default_pipeline as j_pipeline

import superdsm_tpu_torch as T
from superdsm_tpu_torch import automation as tauto
from superdsm_tpu_torch.ops import blob as tblob

torch.set_num_threads(1)

NIH3T3 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'regression', 'data', 'nih3t3-glare.png')

#: The JAX estimator's scales: 30 sqrt(2) on the NIH3T3 crop, and one ulp
#: below 10 sqrt(2) (the mean of equal sigma-grid radii) on bench seeds 0-1.
SCALE_NIH3T3 = 42.426406871192846
SCALE_BENCH = 14.14213562373095


@pytest.fixture(autouse=True)
def _cpu_device():
    with T.use_device('cpu'):
        yield


def _blob_field(radius, n=9, H=400, W=400, seed=0):
    rng = np.random.RandomState(seed)
    rr, cc = np.indices((H, W))
    g = np.zeros((H, W), np.float32)
    grid = np.linspace(60, 340, 3).astype(int)
    for r0 in grid:
        for c0 in grid:
            g += np.exp(-(((rr - r0) ** 2 + (cc - c0) ** 2) / (2 * (radius * 0.6) ** 2)))
    g += rng.randn(H, W).astype(np.float32) * 0.02
    return g


def _image(name):
    if name == 'nih3t3':
        return np.array(PIL.Image.open(NIH3T3))
    if name == 'blob-field':
        return _blob_field(30)
    return make_image(int(name[-1]))[0]


def _normalized(img):
    g = img.astype(np.float64) - img.min()
    return g / g.max()


@pytest.mark.parametrize('name', ['blob-field', 'nih3t3'])
def test_blob_doh_matches_jax(name):
    g = _normalized(_image(name))
    sigmas = jauto._detection_sigmas(20, 200, 10)
    ref = jblob.blob_doh(g, sigmas, threshold=0.01)
    out = tblob.blob_doh(g, sigmas, threshold=0.01)
    assert len(ref) > 0
    np.testing.assert_array_equal(out[:, :3], ref[:, :3])
    np.testing.assert_allclose(out[:, 3], ref[:, 3], rtol=1e-4)


@pytest.mark.parametrize('name,expected', [
    ('nih3t3', SCALE_NIH3T3), ('seed0', SCALE_BENCH), ('seed1', SCALE_BENCH),
    ('blob-field', None)])
def test_estimate_scale_equals_jax(name, expected):
    img = _image(name)
    scale, detections, inliers = tauto._estimate_scale(img)
    ref_scale, ref_detections, ref_inliers = jauto._estimate_scale(img)
    assert scale == ref_scale
    np.testing.assert_array_equal(detections[:, :3], ref_detections[:, :3])
    np.testing.assert_array_equal(inliers, ref_inliers)
    if expected is not None:
        assert scale == expected
    if name == 'nih3t3':
        assert (len(detections), int(inliers.sum())) == (4, 3)
        assert scale == pytest.approx(30 * math.sqrt(2), rel=1e-15)


def test_blob_free_image_raises():
    flat = np.full((256, 256), 0.5, np.float32)
    with pytest.raises(ValueError, match='scale estimation failed'):
        tauto._estimate_scale(flat)


def test_create_config_without_scale_matches_jax():
    img = _image('nih3t3')
    cfg, scale = tauto.create_config(T.create_default_pipeline(), T.Config(), img)
    ref_cfg, ref_scale = jauto.create_config(j_pipeline(), JConfig(), img)
    assert scale == ref_scale == SCALE_NIH3T3
    assert cfg.entries == ref_cfg.entries


def test_process_image_estimates_scale_like_jax():
    """A reduced bench field through the default entry point with no
    ``AF_scale``: the JAX package's scale and object count."""
    from superdsm_tpu.automation import process_image
    from superdsm_tpu.output import get_output as j_output
    from superdsm_tpu_torch.output import get_output
    g, n = make_image(0, H=200, W=260, n_nuclei=8)
    ref, ref_cfg, _ = process_image(j_pipeline(), JConfig(), g,
                                    out=j_output(None).derive(muted=True))
    data, cfg, _ = T.automation.process_image(
        T.create_default_pipeline(), T.Config(), g,
        out=get_output(None).derive(muted=True))
    assert cfg.entries == ref_cfg.entries
    assert cfg['dsm/alpha'] == pytest.approx(0.0005 * SCALE_BENCH ** 2)
    assert len(data['postprocessed_objects']) == \
        len(ref['postprocessed_objects']) == n


@pytest.mark.parametrize('shape', [(3, 7, 9), (5, 13, 6)])
def test_neighborhood_max_zero_pads_every_axis(shape):
    """The 3x3x3 maximum pads with 0.0 on every axis, the sigma axis too,
    as the JAX package's ``jnp.pad`` + ``reduce_window``: a negative border
    value never is its own neighborhood maximum."""
    cube = np.random.RandomState(shape[1]).randn(*shape).astype(np.float32)
    padded = jnp.pad(jnp.asarray(cube), 1, constant_values=0.0)
    ref = jax.lax.reduce_window(padded, -jnp.inf, jax.lax.max, (3, 3, 3),
                                (1, 1, 1), 'VALID')
    out = tblob._neighborhood_max(torch.from_numpy(cube)).numpy()
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert (out >= 0).all()


@pytest.mark.parametrize('src,dst', [((13, 7), (27, 15)), ((26, 35), (53, 71)),
                                     ((65, 86), (261, 347)), ((7, 9), (30, 31))])
def test_nearest_resize_matches_jax(src, dst):
    """The octave levels' nearest upsampling picks the pixels that
    ``jax.image.resize(..., 'nearest')`` picks, at odd sizes."""
    x = np.random.RandomState(src[0]).rand(*src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, 'nearest'))
    out = tblob._resize_nearest(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(out, ref)


def test_doh_response_matches_jax_across_octaves():
    """The response and LoG cubes, with sigmas on the full-resolution level
    and on two octaves (sigma > 10 and > 20), agree to rtol 1e-4 of the
    cube's largest magnitude."""
    g = _normalized(_blob_field(24, H=150, W=173)).astype(np.float32)
    sigmas = (3.0, 9.5, 14.0, 27.0)
    ref_doh, ref_log = jblob._doh_response(jnp.asarray(g), sigmas)
    doh, log = tblob._doh_response(torch.from_numpy(g), sigmas)
    for out, ref in ((doh, ref_doh), (log, ref_log)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
