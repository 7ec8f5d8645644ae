"""The gram kernels (``superdsm_tpu_torch/csrc/gram_grad_hess.cu`` and
``gram_grad_hess_bf16.cu``) against their plain PyTorch version on the card.

These tests need a CUDA device (the kernel has no CPU mode) and skip
without one. The file imports neither JAX nor the JAX package, so it also
runs where only the port is installed::

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerance against the plain version: rtol = atol = 1e-4 (both sum float32
products in float64, in different orders). The banded mode must equal the
dense mode bitwise, two runs must be bitwise equal, and frozen lanes give
exact zeros.

The bf16 kernel is held against ``grad_hess_plain(passes=...)`` with the
same operand rounding: 3 passes to rtol = atol = 1e-4; 1 pass within
bf16's unit roundoff elementwise (``|dH| <= 2^-7 (|Bf|^T diag(kappa) |Bf|)
+ 1e-4``: a one-ulp difference in kappa between ``expf`` and
``torch.sigmoid`` can flip single bf16 roundings) and within
rtol = atol = 1e-4 on at least 99% of the entries. Its banded mode equals
its triangle mode bitwise, and its g equals the float32 kernel's bitwise
(the same code).
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
    assert {k: v for k, v in gram.LAUNCHES.items() if v} == \
        {'dense': 2, 'triangle': 1, 'banded': 1}


def _assert_bf16_close(H, H_ref, Bf, s, yv, w, passes):
    if passes == 3:
        torch.testing.assert_close(H, H_ref, rtol=RTOL, atol=ATOL)
        return
    _, kappa = gram._logistic_weights(s, yv, w)
    absBf = Bf.abs().double()
    bound = 2.0 ** -7 * (absBf * kappa.double()[..., None]).transpose(1, 2) @ absBf
    diff = (H - H_ref).abs().double()
    assert bool((diff <= bound + 1e-4).all())
    within = (diff <= ATOL + RTOL * H_ref.abs().double()).double().mean()
    assert float(within) >= 0.99, float(within)


@pytest.mark.cuda
@pytest.mark.parametrize('passes', [3, 1])
@pytest.mark.parametrize('n,mode', [(128, 'full'), (256, 'full'),
                                    (256, 'triangle'), (512, 'triangle')])
def test_bf16_kernel_matches_plain(n, mode, passes):
    dev = _cuda()
    Bf, s, yv, w = _dense_problem(n + passes, 3, 1024, n, dev)
    active = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    full = mode == 'full'
    g, H = gram.grad_hess_kernel(Bf, s, yv, w, active, passes=passes, full=full)
    g2, H2 = gram.grad_hess_kernel(Bf, s, yv, w, active, passes=passes, full=full)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(H, H2)
    assert not g[1].any() and not H[1].any()
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active, passes=passes,
                                        mirror=not full)
    torch.testing.assert_close(g, g_ref, rtol=RTOL, atol=ATOL)
    _assert_bf16_close(H, H_ref, Bf, s, yv, w, passes)
    if not full:
        g32, _ = gram.grad_hess_kernel(Bf, s, yv, w, active)
        torch.cuda.synchronize()
        assert torch.equal(g, g32)


@pytest.mark.cuda
@pytest.mark.parametrize('passes', [3, 1])
def test_bf16_banded_bitwise_equals_triangle(passes):
    dev = _cuda()
    Bf, s, yv, w = _band_problem(dev)
    active = torch.ones(2, dtype=torch.int32, device=dev)
    band = gram.band_ranges(Bf, w)
    g_b, H_b = gram.grad_hess_kernel(Bf, s, yv, w, active, band, passes=passes)
    g_t, H_t = gram.grad_hess_kernel(Bf, s, yv, w, active, passes=passes)
    torch.cuda.synchronize()
    assert torch.equal(g_b, g_t) and torch.equal(H_b, H_t)
    _, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active, passes=passes,
                                    mirror=True)
    _assert_bf16_close(H_b, H_ref, Bf, s, yv, w, passes)


@pytest.mark.cuda
def test_knob_routes_launch_the_bf16_kernel(monkeypatch):
    """Each knob setting reaches its route through the dispatcher, and no
    knob path falls back to the float32 kernel."""
    dev = _cuda()
    Bf, s, yv, w = _band_problem(dev)
    band = gram.band_ranges(Bf, w)
    gram.reset_launch_counts()
    for passes in (3, 1):
        monkeypatch.setattr(gram, 'GRAM_PASSES', passes)
        for n in (128, 256, 2048):
            gram.fused_grad_hess_batched(*_dense_problem(n, 1, 64, n, dev))
        gram.fused_grad_hess_batched(Bf, s, yv, w, band=band)
    gram.fused_grad_hess_batched(Bf, s, yv, w, band=band, cheap=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in gram.LAUNCHES.items() if v} == {
        'dense-3pass': 2, 'triangle-3pass': 1, 'banded-3pass': 1,
        'dense-1pass': 3, 'triangle-1pass': 1, 'banded-1pass': 1}


@pytest.mark.cuda
def test_bf16_library_refuses_bad_arguments():
    dev = _cuda()
    Bf, s, yv, w = _dense_problem(0, 1, 64, 128, dev)
    active = torch.ones(1, dtype=torch.int32, device=dev)
    lib = gram._load(gram._BF16_SRC)
    g = torch.empty((1, 128), device=dev)
    H = torch.empty((1, 128, 128), device=dev)
    ptrs = [t.data_ptr() for t in (Bf, s, yv, w, active)] + [None] + \
        [g.data_ptr(), H.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.sdsm_gram_bf16_grad_hess(*ptrs, 1, 64, 128, 2, 0, stream) != 0
    assert lib.sdsm_gram_bf16_grad_hess(*ptrs, 1, 64, 128, 3, 2, stream) != 0
    with pytest.raises(ValueError):
        gram.grad_hess_kernel(Bf[..., :64].contiguous(), s, yv, w, active,
                              passes=3)


#: GPU clock cycles of about a second on an H100 (1.98 GHz boost clock)
_SECOND_OF_CYCLES = 2_000_000_000


@pytest.mark.cuda
def test_fetch_with_deadline_waits_for_the_callers_stream():
    """The deadline's copy thread copies on the caller's (non-blocking)
    stream: it waits for a producer still busy there — and times out under
    a short deadline — instead of reading the buffer before it is written."""
    from superdsm_tpu_torch.dsm import batching
    dev = _cuda()
    stream = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(stream):
        x = torch.full((1 << 16,), 1.0, device=dev)
    stream.synchronize()
    cycles = _SECOND_OF_CYCLES
    with torch.cuda.stream(stream):
        torch.cuda._sleep(cycles)  # about a second of a busy producer
        x.fill_(7.0)
        with pytest.raises(batching.SolveTimeout):
            batching._fetch_with_deadline([x], 0.1)
    stream.synchronize()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(cycles // 2)
        x.fill_(9.0)
        (host,) = batching._fetch_with_deadline([x], 60)
    assert (host == 9.0).all()
