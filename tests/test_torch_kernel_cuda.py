"""The gram kernel (``superdsm_tpu_torch/csrc/gram_grad_hess.cu``) against
its plain PyTorch version on the card.

These tests need a CUDA device (the kernel has no CPU mode) and skip
without one. The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed::

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance against the plain version: rtol = atol = 1e-4 (both sum float32
products in float64, in different orders). The banded mode must equal the
dense mode bitwise, two runs must be bitwise equal, and frozen lanes give
exact zeros.
"""

import numpy as np
import pytest
import torch

from superdsm_tpu_torch.dsm import gram
from superdsm_tpu_torch.dsm.smooth import build_smooth_matrix, subsample_grid
from superdsm_tpu_torch.dsm.solver import _poly_basis

RTOL = ATOL = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the gram kernel has no CPU mode)')
    return torch.device('cuda')


def _dense_problem(seed, B, P, n, dev):
    rng = np.random.RandomState(seed)
    arrays = ((rng.rand(B, P, n) - 0.5), rng.randn(B, P),
              np.sign(rng.randn(B, P)), (rng.rand(B, P) < 0.8))
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in arrays)


def _band_problem(dev, P=2048, K=506, side=94, stride=4, sigma=2.0, cutoff=8):
    """Two lanes over a real band-structured G (row-major disk mask)."""
    rr, cc = np.mgrid[:side, :side]
    mask = (rr - side // 2) ** 2 + (cc - side // 2) ** 2 <= (side // 2 - 1) ** 2
    pts = np.argwhere(mask)[:P]
    sub = np.argwhere(subsample_grid(mask, stride) & mask)[:K]
    PIX = np.zeros((P, 2), np.float32)
    PIX[:len(pts)] = pts
    SUB = np.full((K, 2), -10.0 * (cutoff + 1), np.float32)
    SUB[:len(sub)] = sub
    KM = np.zeros(K, np.float32)
    KM[:len(sub)] = 1.0
    W = np.zeros(P, np.float32)
    W[:len(pts)] = 1.0
    t = lambda a: torch.as_tensor(a, device=dev)
    Bf1 = torch.cat([_poly_basis(t(PIX / np.float32(side))),
                     build_smooth_matrix(t(PIX), t(SUB), sigma, cutoff, t(KM))], dim=1)
    rng = np.random.RandomState(0)
    Bf = torch.stack([Bf1, Bf1 * 0.5]).contiguous()
    w = t(np.stack([W, W]))
    yv = t((rng.randn(2, P) * W).astype(np.float32))
    s = t((rng.randn(2, P) * 0.5).astype(np.float32))
    return Bf, s, yv, w


@pytest.mark.cuda
@pytest.mark.parametrize('n', [128, 256, 512])
def test_kernel_matches_plain(n):
    dev = _cuda()
    Bf, s, yv, w = _dense_problem(n, 3, 1024, n, dev)
    active = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    g, H = gram.fused_grad_hess_batched(Bf, s, yv, w, active=active)
    g2, H2 = gram.fused_grad_hess_batched(Bf, s, yv, w, active=active)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(H, H2)
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active)
    torch.testing.assert_close(g, g_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(H, H_ref, rtol=RTOL, atol=ATOL)
    assert not g[1].any() and not H[1].any()


@pytest.mark.cuda
def test_banded_mode_bitwise_equals_dense():
    dev = _cuda()
    Bf, s, yv, w = _band_problem(dev)
    active = torch.ones(2, dtype=torch.int32, device=dev)
    band = gram.band_ranges(Bf, w)
    g_b, H_b = gram.grad_hess_kernel(Bf, s, yv, w, active, band)
    g_d, H_d = gram.grad_hess_kernel(Bf, s, yv, w, active)
    torch.cuda.synchronize()
    assert torch.equal(g_b, g_d) and torch.equal(H_b, H_d)
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active)
    torch.testing.assert_close(H_b, H_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_launch_counts_by_route():
    dev = _cuda()
    gram.reset_launch_counts()
    for n in (128, 256, 2048):
        gram.fused_grad_hess_batched(*_dense_problem(n, 1, 64, n, dev))
    Bf, s, yv, w = _band_problem(dev)
    gram.fused_grad_hess_batched(Bf, s, yv, w, band=gram.band_ranges(Bf, w))
    torch.cuda.synchronize()
    assert gram.LAUNCHES == {'dense': 2, 'triangle': 1, 'banded': 1}
