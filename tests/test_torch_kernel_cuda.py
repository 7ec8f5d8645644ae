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
its triangle mode bitwise, and its g equals the float32 kernel's to 1e-6
relative (the same float32 products; the two kernels may split the pixels
into other segments). The bf16 kernel splits the pixel loop as the float32
one does (its own tile pairs counted) and writes H itself at one segment:
both paths, and few-lane launches of the hybrid schedule's 1-pass full
gram, are held to the same checks.

The float32 kernel splits the pixel loop of few-lane launches across
blocks (split-P); those launches are held to the same checks, and one
launch at two segment counts agrees to 1e-6 relative. A Bf with one
nonzero row per chunk holds the kernel's own mapping of segments to chunks
(every chunk counted once) at one segment and at many.

The solver's lane kernels (``csrc/lane_ops.cu``) are held within the
float32 bound of an exact sum of their L terms (L u sum|terms|, u =
2^-24), with a lane alone bitwise equal to the same lane in the batch; a
solve replayed as a CUDA graph equals the eager loop bitwise.
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


def _band_problem(dev, P=2048, K=506, side=94, stride=4, sigma=2.0, cutoff=8,
                  lanes=2):
    """Two lanes (or one) over a real band-structured G (row-major disk
    mask)."""
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
    Bf = torch.stack([Bf1, Bf1 * 0.5][:lanes]).contiguous()
    w = t(np.stack([W] * lanes))
    yv = t((rng.randn(lanes, P) * W).astype(np.float32))
    s = t((rng.randn(lanes, P) * 0.5).astype(np.float32))
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


def _check_f32(Bf, s, yv, w, active, band=None):
    """The float32 kernel against the plain version: reproducible, frozen
    lanes zero, within rtol = atol = 1e-4; banded equal to unbanded."""
    g, H = gram.grad_hess_kernel(Bf, s, yv, w, active, band)
    g2, H2 = gram.grad_hess_kernel(Bf, s, yv, w, active, band)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(H, H2)
    frozen = active == 0
    assert not g[frozen].any() and not H[frozen].any()
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active)
    torch.testing.assert_close(g, g_ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(H, H_ref, rtol=RTOL, atol=ATOL)
    if band is not None:
        g_d, H_d = gram.grad_hess_kernel(Bf, s, yv, w, active)
        torch.cuda.synchronize()
        assert torch.equal(g, g_d) and torch.equal(H, H_d)
    return g, H


@pytest.mark.cuda
@pytest.mark.parametrize('B,P,n,n_active', [(1, 8192, 128, 1), (1, 4096, 256, 1),
                                             (64, 8192, 128, 4), (3, 1056, 128, 2)])
def test_kernel_few_lanes_split_p(B, P, n, n_active):
    """Few-lane launches split the pixel loop (two passes); the odd chunk
    count (1056 = 33 x 32) ends in a short segment."""
    dev = _cuda()
    assert gram.split_plan(B, P, n)[1] > 1
    Bf, s, yv, w = _dense_problem(B + P + n, B, P, n, dev)
    active = torch.zeros(B, dtype=torch.int32, device=dev)
    active[torch.randperm(B, generator=torch.Generator().manual_seed(B))[:n_active]
           .to(dev)] = 1
    _check_f32(Bf, s, yv, w, active)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [512, 1024])
def test_banded_single_lane_split_p(n):
    """B = 1 banded launches (the canonical re-solve) at n = 512 and 1024:
    split across segments, banded still equal to unbanded bitwise."""
    dev = _cuda()
    if n == 512:
        Bf, s, yv, w = _band_problem(dev, P=8192, K=506, side=98, lanes=1)
    else:
        Bf, s, yv, w = _band_problem(dev, P=16384, K=1018, side=140, lanes=1)
    assert gram.split_plan(*Bf.shape)[1] > 1
    band = gram.band_ranges(Bf, w)
    _check_f32(Bf, s, yv, w, torch.ones(1, dtype=torch.int32, device=dev), band)


@pytest.mark.cuda
def test_segment_count_changes_only_the_last_bits(monkeypatch):
    """The same launch with one segment and with many agrees to 1e-6
    relative (only the float64 sums split)."""
    dev = _cuda()
    Bf, s, yv, w = _dense_problem(5, 2, 8192, 256, dev)
    active = torch.ones(2, dtype=torch.int32, device=dev)
    assert gram.split_plan(2, 8192, 256)[1] > 1
    g_split, H_split = gram.grad_hess_kernel(Bf, s, yv, w, active)
    monkeypatch.setattr(gram, 'TARGET_ITEMS', 1)
    assert gram.split_plan(2, 8192, 256)[1] == 1
    g_one, H_one = gram.grad_hess_kernel(Bf, s, yv, w, active)
    torch.cuda.synchronize()
    scale = float(H_one.abs().max())
    torch.testing.assert_close(H_split, H_one, rtol=1e-6, atol=1e-6 * scale)
    torch.testing.assert_close(g_split, g_one, rtol=1e-6,
                               atol=1e-6 * float(g_one.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('B,P,n', [(1, 8192, 128), (3, 1056, 128), (2, 4096, 256)])
def test_every_chunk_counted_once_at_any_segment_count(monkeypatch, B, P, n):
    """Bf is zero but for one row per 32-row chunk, with positive entries:
    every chunk adds about 1 / nchunks of each entry of H, so a chunk that
    the kernel's own segment mapping skips or counts twice moves H far
    beyond the 1e-6 relative the check allows (and g too). Held at one
    segment, at the default plan and at the shortest segments."""
    dev = _cuda()
    rng = np.random.RandomState(B + P + n)
    nchunks = P // gram.ROWS
    rows = np.arange(nchunks) * gram.ROWS + (np.arange(nchunks) * 7) % gram.ROWS
    Bf_np = np.zeros((B, P, n), np.float32)
    Bf_np[:, rows] = rng.uniform(1.0, 2.0, (B, nchunks, n))
    Bf = torch.as_tensor(Bf_np, device=dev)
    s = torch.as_tensor(rng.randn(B, P).astype(np.float32), device=dev)
    yv = torch.as_tensor(np.sign(rng.randn(B, P)).astype(np.float32), device=dev)
    w = torch.ones((B, P), device=dev)
    active = torch.ones(B, dtype=torch.int32, device=dev)
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active)
    segments = []
    for target in (1, gram.TARGET_ITEMS, 10 ** 9):
        monkeypatch.setattr(gram, 'TARGET_ITEMS', target)
        if target == 10 ** 9:
            monkeypatch.setattr(gram, 'MAX_SEGMENTS', 10 ** 9)
        segments.append(gram.split_plan(B, P, n)[1])
        g, H = gram.grad_hess_kernel(Bf, s, yv, w, active)
        torch.cuda.synchronize()
        torch.testing.assert_close(H, H_ref, rtol=1e-6,
                                   atol=1e-6 * float(H_ref.abs().max()))
        torch.testing.assert_close(g, g_ref, rtol=1e-6,
                                   atol=1e-6 * float(g_ref.abs().max()))
    assert segments[0] == 1 and segments[0] < segments[1] <= segments[2], segments


@pytest.mark.cuda
def test_f32_library_refuses_bad_arguments():
    dev = _cuda()
    Bf, s, yv, w = _dense_problem(0, 1, 8192, 128, dev)
    active = torch.ones(1, dtype=torch.int32, device=dev)
    lib = gram._load(gram._F32_SRC)
    g = torch.empty((1, 128), device=dev)
    H = torch.empty((1, 128, 128), device=dev)
    ptrs = [t.data_ptr() for t in (Bf, s, yv, w, active)] + [None] + \
        [g.data_ptr(), H.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    # every launch needs scratch, and several segments an even length
    assert lib.sdsm_gram_grad_hess(*ptrs, None, 1, 8192, 128, 8, stream) != 0
    assert lib.sdsm_gram_grad_hess(*ptrs, None, 1, 8192, 128, 256, stream) != 0
    part = torch.empty(gram.scratch_entries(1, 8192, 128), dtype=torch.float64,
                       device=dev)
    assert lib.sdsm_gram_grad_hess(*ptrs, part.data_ptr(), 1, 8192, 128, 7,
                                   stream) != 0
    assert lib.sdsm_gram_grad_hess(*ptrs, part.data_ptr(), 1, 8192, 96, 256,
                                   stream) != 0
    buf = torch.zeros(8192 + 4, device=dev)
    s_misaligned = buf[1:8193].view(1, 8192)
    assert s_misaligned.is_contiguous()
    with pytest.raises(ValueError, match='aligned'):
        gram.grad_hess_kernel(Bf, s_misaligned, yv, w, active)


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
        # the same float32 products of g, summed in other float64 groupings
        g32, _ = gram.grad_hess_kernel(Bf, s, yv, w, active)
        torch.cuda.synchronize()
        torch.testing.assert_close(g, g32, rtol=1e-6,
                                   atol=1e-6 * float(g32.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('passes', [3, 1])
def test_bf16_banded_bitwise_equals_triangle(passes, monkeypatch):
    """At the default plan (16 segments) and at one segment (the direct
    write)."""
    dev = _cuda()
    Bf, s, yv, w = _band_problem(dev)
    active = torch.ones(2, dtype=torch.int32, device=dev)
    band = gram.band_ranges(Bf, w)
    _, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active, passes=passes,
                                    mirror=True)
    segments = []
    for target in (gram.TARGET_ITEMS, 1):
        monkeypatch.setattr(gram, 'TARGET_ITEMS', target)
        segments.append(gram.split_plan(*Bf.shape, passes)[1])
        g_b, H_b = gram.grad_hess_kernel(Bf, s, yv, w, active, band, passes=passes)
        g_t, H_t = gram.grad_hess_kernel(Bf, s, yv, w, active, passes=passes)
        torch.cuda.synchronize()
        assert torch.equal(g_b, g_t) and torch.equal(H_b, H_t)
        _assert_bf16_close(H_b, H_ref, Bf, s, yv, w, passes)
    assert segments[0] > 1 and segments[1] == 1, segments


@pytest.mark.cuda
@pytest.mark.parametrize('B,P,n', [(1, 8192, 128), (1, 32768, 512),
                                   (64, 8192, 128)])
def test_bf16_few_lanes_full_1pass(B, P, n, monkeypatch):
    """The hybrid schedule's cheap gram (1 pass, full mode) at few-lane
    launches: B = 1 re-solves and a batch with 4 lanes left, split across
    many segments; reproducible, frozen lanes zero, within the 1-pass
    tolerance of the plain version, and within 1e-6 relative of the same
    launch at one segment (only the float64 sums regroup)."""
    dev = _cuda()
    assert gram.split_plan(B, P, n, 1, True)[1] > 1
    Bf, s, yv, w = _dense_problem(B + P + n, B, P, n, dev)
    active = torch.zeros(B, dtype=torch.int32, device=dev)
    active[::max(1, B // 4)] = 1
    g, H = gram.grad_hess_kernel(Bf, s, yv, w, active, passes=1, full=True)
    g2, H2 = gram.grad_hess_kernel(Bf, s, yv, w, active, passes=1, full=True)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(H, H2)
    frozen = active == 0
    assert not g[frozen].any() and not H[frozen].any()
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active, passes=1)
    torch.testing.assert_close(g, g_ref, rtol=RTOL, atol=ATOL)
    _assert_bf16_close(H, H_ref, Bf, s, yv, w, 1)
    monkeypatch.setattr(gram, 'TARGET_ITEMS', 1)
    g1, H1 = gram.grad_hess_kernel(Bf, s, yv, w, active, passes=1, full=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(H, H1, rtol=1e-6, atol=1e-6 * float(H1.abs().max()))
    torch.testing.assert_close(g, g1, rtol=1e-6, atol=1e-6 * float(g1.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('passes', [3, 1])
@pytest.mark.parametrize('B,P,n,full', [(1, 8192, 128, True), (3, 1056, 256, False),
                                        (2, 4096, 256, True)])
def test_bf16_every_chunk_counted_once_at_any_segment_count(monkeypatch, B, P,
                                                            n, full, passes):
    """The float32 kernel's coverage test for the bf16 kernel: Bf is zero
    but for one row per 32-row chunk, with entries in [1, 2], and s = 0,
    y = +-1, w = 1, so that kappa = 1/4 and term1 = -+1/2 are exact and the
    bf16 operands round alike in the kernel and the plain version. Every
    chunk adds about 1 / nchunks of each entry of H, so a chunk that the
    kernel's segment mapping skips or counts twice, or a fragment that
    lands on a wrong entry, moves H far beyond the 1e-6 relative allowed.
    Held at one segment (the direct write), at the default plan and at the
    shortest segments, in full and triangle mode (mirrored blocks)."""
    dev = _cuda()
    rng = np.random.RandomState(B + P + n + passes)
    nchunks = P // gram.ROWS
    rows = np.arange(nchunks) * gram.ROWS + (np.arange(nchunks) * 7) % gram.ROWS
    Bf_np = np.zeros((B, P, n), np.float32)
    Bf_np[:, rows] = rng.uniform(1.0, 2.0, (B, nchunks, n))
    Bf = torch.as_tensor(Bf_np, device=dev)
    s = torch.zeros((B, P), device=dev)
    yv = torch.as_tensor(np.sign(rng.randn(B, P)).astype(np.float32), device=dev)
    w = torch.ones((B, P), device=dev)
    active = torch.ones(B, dtype=torch.int32, device=dev)
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active, passes=passes,
                                        mirror=not full)
    segments = []
    for target in (1, gram.TARGET_ITEMS, 10 ** 9):
        monkeypatch.setattr(gram, 'TARGET_ITEMS', target)
        segments.append(gram.split_plan(B, P, n, passes, full)[1])
        g, H = gram.grad_hess_kernel(Bf, s, yv, w, active, passes=passes, full=full)
        torch.cuda.synchronize()
        torch.testing.assert_close(H, H_ref, rtol=1e-6,
                                   atol=1e-6 * float(H_ref.abs().max()))
        torch.testing.assert_close(g, g_ref, rtol=1e-6,
                                   atol=1e-6 * float(g_ref.abs().max()))
    assert segments[0] == 1 and segments[0] < segments[1] <= segments[2], segments


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
    Bf, s, yv, w = _dense_problem(0, 1, 8192, 128, dev)
    active = torch.ones(1, dtype=torch.int32, device=dev)
    lib = gram._load(gram._BF16_SRC)
    g = torch.empty((1, 128), device=dev)
    H = torch.empty((1, 128, 128), device=dev)
    ptrs = [t.data_ptr() for t in (Bf, s, yv, w, active)] + [None] + \
        [g.data_ptr(), H.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    part = torch.empty(gram.scratch_entries(1, 8192, 128, 1, True),
                       dtype=torch.float64, device=dev)
    # passes 1 or 3; banded mode needs a band table
    assert lib.sdsm_gram_bf16_grad_hess(*ptrs, part.data_ptr(), 1, 8192, 128,
                                        8, 2, 0, stream) != 0
    assert lib.sdsm_gram_bf16_grad_hess(*ptrs, part.data_ptr(), 1, 8192, 128,
                                        8, 3, 2, stream) != 0
    # several segments need scratch and an even length; triangle mode n % 128
    assert lib.sdsm_gram_bf16_grad_hess(*ptrs, None, 1, 8192, 128, 8, 1, 0,
                                        stream) != 0
    assert lib.sdsm_gram_bf16_grad_hess(*ptrs, part.data_ptr(), 1, 8192, 128,
                                        7, 1, 0, stream) != 0
    assert lib.sdsm_gram_bf16_grad_hess(*ptrs, part.data_ptr(), 1, 8192, 64,
                                        8, 1, 1, stream) != 0
    # one segment takes no scratch (the direct write)
    assert lib.sdsm_gram_bf16_grad_hess(*ptrs, None, 1, 8192, 128, 256, 1, 0,
                                        stream) == 0
    torch.cuda.synchronize()
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active, passes=1)
    _assert_bf16_close(H, H_ref, Bf, s, yv, w, 1)
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


_FIRST_LINALG_FROM_THREADS = '''
import threading, torch
from superdsm_tpu_torch.dsm import solver
barrier = threading.Barrier(8)
errors = []
def first_solve():
    Q = torch.rand((2, 64, 6), device='cuda')
    yv = torch.randn((2, 64), device='cuda')
    w = torch.ones((2, 64), device='cuda')
    barrier.wait(timeout=60)
    try:
        solver._lsq_init(Q, yv, w)
        torch.cuda.synchronize()
    except RuntimeError as error:
        errors.append(str(error))
threads = [threading.Thread(target=first_solve) for _ in range(8)]
for t in threads: t.start()
for t in threads: t.join(timeout=120)
assert not any(t.is_alive() for t in threads)
assert not errors, errors
'''


@pytest.mark.cuda
def test_first_linalg_calls_from_threads():
    """A fresh process whose first CUDA linear-algebra calls come from 8
    threads at once (a forked batch task's file stream) solves in every
    thread: PyTorch's lazy load of its linalg library is serialized."""
    import os
    import subprocess
    import sys
    _cuda()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', _FIRST_LINALG_FROM_THREADS],
                          cwd=repo, capture_output=True, text=True, timeout=300,
                          env={**os.environ, 'PYTHONPATH': repo})
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize('B,P,n', [(5, 8192, 6), (3, 2048, 512), (2, 16384, 1024),
                                   (4, 2048, 8), (4, 2048, 32), (3, 4099, 1)])
def test_lane_matvec_kernel(B, P, n):
    """The lane product (``csrc/lane_ops.cu``) within the float32 bound of
    an exact sum of n terms (n u sum|terms|, u = 2^-24), a lane alone
    bitwise equal to the same lane in the batch, and at n <= 8 (one thread
    a row) bitwise equal to the warp-per-row kernel."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    rng = np.random.RandomState(B + P + n)
    A = torch.as_tensor(rng.randn(B, P, n).astype(np.float32), device=dev)
    x = torch.as_tensor(rng.randn(B, n).astype(np.float32), device=dev)
    out = lane.matvec(A, x)
    exact = (A.double() @ x.double()[..., None])[..., 0]
    bound = n * 2.0 ** -24 * (A.double().abs() @ x.double().abs()[..., None])[..., 0]
    assert bool(((out.double() - exact).abs() <= bound).all())
    for b in range(B):
        assert torch.equal(lane.matvec(A[b:b + 1], x[b:b + 1])[0], out[b])
    if n <= 8:
        warp = lane.matvec_kernel(A, x, warp_rows=True)
        assert torch.equal(out.view(torch.int32), warp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dim,positive', [
    ((16, 32768, 12), 1, False), ((3, 524288), -1, False), ((5, 6), -1, False),
    ((3, 5000, 12), 1, True), ((4, 32767), -1, True)])
def test_lane_sum_kernel(shape, dim, positive):
    """The lane sum bitwise equal to its order replayed on the host
    (``lane.lane_sum_in_kernel_order``), within sqrt(L) u sum|terms| of the
    exact sum and of the plain version (one term dropped or counted twice
    exceeds that, on the positive softplus terms the solver sums), and a
    lane alone bitwise equal to the same lane in the batch."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    rng = np.random.RandomState(len(shape))
    host = rng.randn(*shape).astype(np.float32)
    if positive:
        host = np.logaddexp(host, 0.0).astype(np.float32)
    x = torch.as_tensor(host, device=dev)
    out = lane.lane_sum(x, dim)
    L = shape[dim]
    rows = np.moveaxis(host, dim, -1)
    ordered = lane.lane_sum_in_kernel_order(rows.reshape(-1, L)).reshape(rows.shape[:-1])
    assert np.array_equal(out.cpu().numpy().view(np.int32), ordered.view(np.int32))
    bound = np.sqrt(L) * 2.0 ** -24 * x.double().abs().sum(dim)
    assert bool(((out.double() - x.double().sum(dim)).abs() <= bound).all())
    assert bool(((out.double() - lane.lane_sum_plain(x, dim).double()).abs()
                 <= bound).all())
    for b in (0, shape[0] - 1):
        assert torch.equal(lane.lane_sum(x[b:b + 1], dim)[0], out[b])


@pytest.mark.cuda
@pytest.mark.parametrize('K', [0, 122])
def test_device_loop_equals_eager_loop(K):
    """A solve replayed as a CUDA graph equals the same solve run op by op
    (``solver.eager_loop``) bitwise, and each lane alone equals it in the
    batch."""
    from superdsm_tpu_torch.dsm import solver
    dev = _cuda()
    B, P = 4, 2048
    rng = np.random.RandomState(K)
    pts = np.argwhere(np.ones((40, 40), bool)).astype(np.float32)
    PIX = np.zeros((P, 2), np.float32)
    PIX[:len(pts)] = pts
    W = np.zeros((B, P), np.float32)
    W[:, :len(pts)] = 1.0
    yv = np.zeros((B, P), np.float32)
    rr, cc = np.indices((40, 40))
    for b in range(B):
        disk = (rr - 20 - b) ** 2 + (cc - 19) ** 2 <= (8 + 2 * b) ** 2
        yv[b, :len(pts)] = (disk - 0.5 + rng.randn(40, 40) * 0.4).ravel()
    t = lambda a: torch.as_tensor(a, device=dev)
    pix = t(np.stack([PIX] * B))
    Q = _poly_basis((pix + 40.0) / 199.0)
    kmask = torch.ones((B, K), device=dev)
    G = build_smooth_matrix(pix, t(np.stack([pts[::len(pts) // K][:K]] * B)),
                            4.0, 16, kmask) if K else None
    args = (torch.zeros((B, 6 + K), device=dev), Q, G, t(yv), t(W),
            torch.full((B,), 0.05, device=dev), 1.0, kmask, 30, 1e-5)
    solver.reset_loop_stats()
    graph = solver._solve_batch_impl(*args)
    assert solver.LOOP_STATS['graphs'] == 1 and solver.LOOP_STATS['replays'] > 0
    with solver.eager_loop():
        eager = solver._solve_batch_impl(*args)
    for x, y in zip(graph, eager):
        assert torch.equal(x, y)
    for b in range(B):
        alone = solver._solve_batch_impl(*(a[b:b + 1] if isinstance(a, torch.Tensor)
                                          else a for a in args))
        assert torch.equal(alone[1][0], graph[1][b])
        assert torch.equal(alone[0][0], graph[0][b])
        assert torch.equal(alone[5][0], graph[5][b])
