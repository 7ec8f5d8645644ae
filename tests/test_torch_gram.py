"""The port's Newton gram against the JAX package's Pallas kernels.

The same inputs, made from a numpy seed, go through the JAX package's
``pallas_kernels.fused_grad_hess_batched`` (Pallas in interpret mode on the
CPU, one case per TPU kernel route: B1 full dense at n = 128, B2 triangle at
n = 256, B3 banded at n = 512) and through the port's dispatcher
``superdsm_tpu_torch.dsm.gram.fused_grad_hess_batched``, which on CPU
tensors runs its plain PyTorch version. Tolerance: rtol = atol = 1e-4 (the
JAX package sums the float32 products over up to 2048 pixels in float32,
the port in float64).

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernel_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from superdsm_tpu.dsm import pallas_kernels as pk
from superdsm_tpu.dsm.smooth import build_smooth_matrix, subsample_grid
from superdsm_tpu.dsm.solver import _poly_basis

from superdsm_tpu_torch.dsm import gram

torch.set_num_threads(1)

RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret_mode():
    prev = pk._FORCE_INTERPRET
    pk._FORCE_INTERPRET = True
    pk.fused_grad_hess_batched.clear_cache()
    yield
    pk._FORCE_INTERPRET = prev
    pk.fused_grad_hess_batched.clear_cache()


def _band_problem(seed=0, P=2048, K=506, side=94, stride=4, sigma=2.0,
                  cutoff=8, lanes=2):
    """A padded batch with a real band-structured G (row-major disk mask),
    one lane per seed offset; returns numpy arrays plus the JAX band table."""
    rr, cc = np.mgrid[:side, :side]
    mask = (rr - side // 2) ** 2 + (cc - side // 2) ** 2 <= (side // 2 - 1) ** 2
    pts = np.argwhere(mask)[:P]
    npix = len(pts)
    sub = np.argwhere(subsample_grid(mask, stride) & mask)[:K]
    k = len(sub)
    PIX = np.zeros((P, 2), np.float32)
    PIX[:npix] = pts
    W = np.zeros((P,), np.float32)
    W[:npix] = 1.0
    SUB = np.full((K, 2), -10.0 * (cutoff + 1), np.float32)
    SUB[:k] = sub
    KM = np.zeros((K,), np.float32)
    KM[:k] = 1.0
    Q = np.asarray(_poly_basis(jnp.asarray(PIX / np.float32(side))))
    G = np.asarray(build_smooth_matrix(jnp.asarray(PIX), jnp.asarray(SUB),
                                       sigma, cutoff, jnp.asarray(KM)))
    Bf1 = np.concatenate([Q, G], axis=1).astype(np.float32)
    rng = np.random.RandomState(seed)
    Bf = np.stack([Bf1] * lanes)
    yv = (rng.randn(lanes, P) * W).astype(np.float32)
    s = (rng.randn(lanes, P) * 0.5).astype(np.float32)
    w = np.stack([W] * lanes)
    n = 6 + K
    cb, fits = pk.compute_band_blocks(
        jnp.asarray(np.stack([PIX[:, 0]] * lanes)), jnp.asarray(w),
        jnp.asarray(np.stack([SUB[:, 0]] * lanes)),
        jnp.asarray(np.stack([KM] * lanes)), float(cutoff), n,
        pk._tile_rows(P, n))
    assert bool(fits)
    return Bf, s, yv, w, cb, fits


def _dense_problem(seed, B, P, n):
    rng = np.random.RandomState(seed)
    Bf = (rng.rand(B, P, n) - 0.5).astype(np.float32)
    s = rng.randn(B, P).astype(np.float32)
    yv = np.sign(rng.randn(B, P)).astype(np.float32)
    w = (rng.rand(B, P) < 0.8).astype(np.float32)
    return Bf, s, yv, w


def _port(Bf, s, yv, w, active=None, band=None):
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in (Bf, s, yv, w)]
    act = None if active is None else torch.as_tensor(np.asarray(active), dtype=torch.int32)
    g, H = gram.fused_grad_hess_batched(*t, active=act, band=band)
    return g.numpy(), H.numpy()


@pytest.mark.parametrize('n', [128, 256], ids=['B1-dense-n128', 'B2-triangle-n256'])
def test_dense_routes_match_pallas(n):
    Bf, s, yv, w = _dense_problem(n, 2, 512, n)
    assert gram.route_for(n, banded=False) == ('dense' if n == 128 else 'triangle')
    g_ref, H_ref = pk.fused_grad_hess_batched(*map(jnp.asarray, (Bf, s, yv, w)))
    g, H = _port(Bf, s, yv, w)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(H, np.asarray(H_ref), rtol=RTOL, atol=ATOL)


def test_banded_route_matches_pallas():
    Bf, s, yv, w, cb, fits = _band_problem()
    args = tuple(map(jnp.asarray, (Bf, s, yv, w)))
    g_ref, H_ref = pk.fused_grad_hess_batched(*args, cb=cb, fits=fits)
    band = gram.band_ranges(torch.from_numpy(Bf), torch.from_numpy(w))
    g, H = _port(Bf, s, yv, w, band=band)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(H, np.asarray(H_ref), rtol=RTOL, atol=ATOL)


def test_frozen_lanes_give_zeros_like_pallas():
    Bf, s, yv, w, cb, fits = _band_problem(seed=3)
    Bf[1] *= 0.5
    s[1] *= -0.7
    active = np.asarray([0, 1], np.int32)
    g_ref, H_ref = pk.fused_grad_hess_batched(
        *map(jnp.asarray, (Bf, s, yv, w)), cb=cb, fits=fits,
        active=jnp.asarray(active))
    g, H = _port(Bf, s, yv, w, active=active)
    assert not np.any(g[0]) and not np.any(H[0])
    assert not np.any(np.asarray(g_ref)[0]) and not np.any(np.asarray(H_ref)[0])
    np.testing.assert_allclose(g[1], np.asarray(g_ref)[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(H[1], np.asarray(H_ref)[1], rtol=RTOL, atol=ATOL)


def test_band_ranges_cover_every_nonzero_column():
    Bf, s, yv, w, _, _ = _band_problem()
    B, P, n = Bf.shape
    band = gram.band_ranges(torch.from_numpy(Bf), torch.from_numpy(w)).numpy()
    assert band.shape == (B, P // gram.ROWS, 3)
    narrow = 0
    for b in range(B):
        for c in range(P // gram.ROWS):
            rows = slice(c * gram.ROWS, (c + 1) * gram.ROWS)
            valid = Bf[b, rows][w[b, rows] > 0]
            cols = np.nonzero(np.any(valid != 0, axis=0))[0]
            tiles = cols // gram.TILE
            t0, lo, hi = band[b, c]
            covered = ((tiles == 0) & (t0 != 0)) | ((tiles >= lo) & (tiles <= hi))
            assert covered.all(), (b, c, cols[~covered])
            narrow += (hi - lo + 1) < n // gram.TILE - 1
    # the band is a real saving: most chunks skip some column tiles
    assert narrow > 0


def test_kernel_refuses_cpu_tensors():
    Bf, s, yv, w = (torch.from_numpy(a) for a in _dense_problem(0, 1, 64, 128))
    with pytest.raises(ValueError):
        gram.grad_hess_kernel(Bf, s, yv, w, torch.ones(1, dtype=torch.int32))
