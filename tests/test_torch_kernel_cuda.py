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
solve replayed as a CUDA graph equals the eager loop bitwise. Their
variants compute the same order and are held to each other bitwise: the
one-thread-a-row product (n <= 32) to the warp-per-row one, a strided sum
read in place to its order replayed on the host, and each fused sum (``lane_dot``,
``softplus_energies``) to the op-by-op chain it replaces; the softplus
device function equals ``torch.logaddexp(x, 0)`` bitwise, and
``softplus_energies`` equals its order replayed on the host in every mode
and tile width, with non-finite inputs. ``lane_pcg``, the whole of PCG in
one launch, is held bitwise to the chain it replaces (``lane.pcg_chain``
on the card) on both of its routes (H in registers at n <= 512, in
shared memory above), a lane alone to the lane in the batch, a captured
graph's replay to the eager launch, and its frozen and NaN lanes to the
chain's. ``lane_cholesky``, the Newton direction by Cholesky in one
launch, is held bitwise to its order written op by op
(``lane.cholesky_chain`` on the card) on each of its routes (one block a
lane in shared memory, a cluster of 8 blocks a lane, a cluster of 16 with
its panels in shared memory or in the global scratch, up to n = 2048), a
lane alone to the lane in the batch, a captured graph's replay to the
eager launch, and its NaN lanes to the chain's. ``lane_lm_system``
and ``lane_step_guard``, the damped Newton system and the step guard in
one launch each, are held bitwise to the chains they replace
(``lane.lm_system_plain`` and ``lane.step_guard_plain`` on the card) at
the main path's shapes, with non-finite damping, directions and energies,
a lane alone to the lane in the batch. The direction launch
(``lane.newton_direction``: the damped system, the direction and its
guard in one launch of the direction kernel's step variant, or the guard
alone on a damped system) is held bitwise to the three launches it
replaced and to its plain version, with a lane of infinite damping, one
not positive definite and one all padded, a lane alone to the lane in the
batch, a captured graph's replay to the eager launch; it raises on what
it does not take; ``solver._newton_step`` makes one direction launch and
no ``lane_lm_system``, ``lane_step_guard`` or ``lane_dot`` launch. ``lane_step_pick`` and ``lane_step_tail``,
the line search's pick and the rest of the step with the loop's freeze
writes, are held bitwise to their chains (``lane.step_pick_plain`` and
``lane.step_tail_plain`` on the card) at the main path's shapes, with
NaN, infinite and tied candidates, in both of the tail's modes (a lane
already converged keeps every bit of its state), a lane alone to the lane
in the batch; ``solver._newton_step`` launches each once and no
``lane_sum``. ``lane_step_sweep``, the pick, the scale sweep's sums and
the tail with the freeze writes in one launch (the loop's step), writes
bitwise the state the three launches it replaces write and its plain
version on the card, at 1, 2 and 4 tiles a lane forced, a lane alone as in
its batch, over two graph replays in a row (its arrival counters back at
0) and from two threads each capturing its own graph;
``solver._newton_step`` given the loop's state launches it once and no
``lane_step_pick`` or ``lane_step_tail``. A lane alone is
held bitwise to the lane in its batch for the bf16 kernel (whose plan no
longer reads B) and for the sharded solvers on a mesh of the card twice.

The narrow kernel (``csrc/gram_narrow.cu``, n = 6, 32, 64, float64 products
and sums) is held to the plain version within 2 float32 ulps of each
lane's largest entry of g and of H, its frozen lanes to exact zeros, a lane
alone, in a batch of 2 and with the other lanes frozen bitwise to the lane
in its batch, a captured graph's replay to the eager launch, and NaN in its
chunks of zero weight to the finite values there (they are skipped); it
raises on what it does not take, and pads a P that is no whole number of
its chunks.
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
    bitwise equal to the same lane in the batch, and at n <= 32 (one thread
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
    if n <= 32:
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


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['n=6 table', 'n=1', 'n=8', 'n=9', 'n=17', 'n=32',
                                  'n=30 unaligned', 'n=6 unaligned', 'underflow n=6',
                                  'underflow n=20'])
def test_lane_matvec_row_kernel_equals_warp_kernel(case):
    """The one-thread-a-row product (rows staged in shared memory) bitwise
    equal to the warp-per-row kernel: P not a multiple of 256 (a block's
    rows in two lanes), A not 16-byte aligned (scalar staging), products
    that underflow to -0 (the slots' +0 adds)."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    rng = np.random.RandomState(len(case))
    n = int(case.split('n=')[1].split()[0])
    B, P = (64, 8192) if 'table' in case else (3, 1000 + 7 * n)
    if 'unaligned' in case:
        flat = torch.as_tensor(rng.randn(B * P * n + 1).astype(np.float32), device=dev)
        A = flat[1:].view(B, P, n)
        assert A.data_ptr() % 16 != 0
    elif 'underflow' in case:
        A = torch.full((B, P, n), -1e-30, device=dev)
        A[:, :, 1] = 0.0
        A[:, ::3, 2] = 1e-30
    else:
        A = torch.as_tensor(rng.randn(B, P, n).astype(np.float32), device=dev)
    x = torch.as_tensor((rng.randn(B, n) * (1e-30 if 'underflow' in case else 1))
                        .astype(np.float32), device=dev)
    out = lane.matvec_kernel(A, x)
    assert torch.equal(_bits(out), _bits(lane.matvec_kernel(A, x, warp_rows=True)))
    for b in (0, B - 1):
        assert torch.equal(_bits(lane.matvec_kernel(A[b:b + 1], x[b:b + 1])[0]),
                           _bits(out[b]))


def _strided_sum_cases():
    return {
        'candidates (B, P, S) over P': ((16, 12, 32768), lambda x: x.transpose(1, 2), 1),
        'B = 1 re-solve': ((1, 12, 16384), lambda x: x.transpose(1, 2), 1),
        'L not a multiple of 256': ((3, 12, 5001), lambda x: x.transpose(1, 2), 1),
        'regularizer (B, K, S)': ((16, 506, 12), lambda x: x, 1),
        'rows (B, S, P)': ((4, 12, 32767), lambda x: x, 2),
        'one long row': ((1, 32768), lambda x: x, 1),
        'diagonal view': ((6, 300, 300), lambda x: torch.diagonal(x, dim1=-2, dim2=-1), 1),
        'positive terms': ((3, 12, 5000), lambda x: torch.logaddexp(x, torch.zeros(())
                                                                      .to(x)).transpose(1, 2), 1),
    }


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(_strided_sum_cases()))
def test_lane_sum_strided_in_place(case):
    """A strided lane sum, read in place, bitwise equal to its order
    replayed on the host on the moved-axis copy; a lane alone bitwise equal
    to it in the batch."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    shape, view, dim = _strided_sum_cases()[case]
    rng = np.random.RandomState(sum(shape))
    x = view(torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev))
    out = lane.lane_sum(x, dim)
    rows = x.movedim(dim, -1).reshape(-1, x.shape[dim]).cpu().numpy()
    ordered = lane.lane_sum_in_kernel_order(rows).reshape(tuple(out.shape))
    assert np.array_equal(out.cpu().numpy().view(np.int32), ordered.view(np.int32))
    for b in (0, x.shape[0] - 1):
        assert torch.equal(_bits(lane.lane_sum(x[b:b + 1], dim)[0]), _bits(out[b]))


def _fused_inputs(B, P, dev, seed=0):
    rng = np.random.RandomState(seed + B + P)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    return (t(rng.randn(B, P) * 3), t(rng.randn(B, P) * 2), t(rng.randn(B, P)),
            t((rng.rand(B, P) < 0.9) * rng.rand(B, P)))


@pytest.mark.cuda
@pytest.mark.parametrize('B,P', [(16, 32768), (1, 16384), (2, 16384), (3, 5001), (64, 8192)])
@pytest.mark.parametrize('mode', ['line_search', 'scale_sweep', 'energy', 'dot'])
def test_fused_lane_sums_equal_the_unfused_chain(mode, B, P):
    """Each fused entry point bitwise equal to the chain it replaces on the
    card (the op-by-op terms, then ``lane_sum``), its ``*_plain`` version
    within sqrt(L) u sum|terms| (the CPU's order), and a lane alone bitwise
    equal to it in the batch."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    s, u, y, w = _fused_inputs(B, P, dev)
    if mode == 'dot':
        fused = lambda s, u, y, w: lane.lane_dot(s, u)
        chain = lambda s, u, y, w: lane.lane_sum(s * u)
        plain = lane.lane_dot_plain(s.cpu(), u.cpu())
        magnitude = (s * u).double().abs().sum(-1)
    else:
        c = {'line_search': 0.5 ** torch.arange(solver.LS_STEPS, dtype=torch.float32),
             'scale_sweep': torch.tensor(solver.SCALES)}.get(mode)
        c = None if c is None else c.to(dev)
        uu = u if mode == 'line_search' else None
        fused = lambda s, u, y, w: lane.softplus_energies(
            s, y, w, c, u if mode == 'line_search' else None)
        chain = lambda s, u, y, w: lane.lane_sum(*lane.softplus_terms(
            s, y, w, c, u if mode == 'line_search' else None))
        plain = lane.softplus_energies_plain(s.cpu(), y.cpu(), w.cpu(),
                                             None if c is None else c.cpu(),
                                             None if uu is None else uu.cpu())
        terms, dim = lane.softplus_terms(s, y, w, c, uu)
        magnitude = terms.double().abs().sum(dim)
    out = fused(s, u, y, w)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(chain(s, u, y, w)))
    bound = np.sqrt(P) * 2.0 ** -24 * magnitude.cpu()
    assert bool(((out.double().cpu() - plain.double()).abs() <= bound).all())
    for b in (0, B - 1):
        one = [t[b:b + 1] for t in (s, u, y, w)]
        assert torch.equal(_bits(fused(*one)[0]), _bits(out[b]))


@pytest.mark.cuda
def test_softplus_device_function_equals_logaddexp():
    """The softplus of the fused sums (``lane.softplus_kernel``) bitwise
    ``torch.logaddexp(x, 0)`` on the card, over every 257th float32 bit
    pattern and the special values (``chip_smoke.py`` checks all 2^32)."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    bits = torch.arange(0, 2 ** 32, 257, dtype=torch.int64, device=dev)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    specials = torch.tensor([0.0, -0.0, float('inf'), -float('inf'), float('nan'),
                             88.7, -88.7, 1e-30, -1e-30, 17.0, -17.0], device=dev)
    for x in (bits.view(torch.float32), specials):
        ref = lane.softplus_plain(x)
        got = lane.softplus_kernel(x)
        same = (_bits(ref) == _bits(got)) | (torch.isnan(ref) & torch.isnan(got))
        assert bool(same.all())


@pytest.mark.cuda
@pytest.mark.parametrize('B,P', [(1, 100), (64, 300), (2, 12288)])
@pytest.mark.parametrize('mode,S', [('line_search', 1), ('line_search', 3), ('line_search', 12),
                                    ('line_search', 16), ('scale_sweep', 1), ('scale_sweep', 3),
                                    ('scale_sweep', 12), ('scale_sweep', 16), ('energy', 1)])
def test_softplus_energies_kernel_equals_its_order(mode, S, B, P):
    """``softplus_energies`` bitwise its order (``lane.softplus_terms``, ATen's
    ops on the card, summed by ``lane.lane_sum_in_kernel_order`` on the
    host) in each mode at S = 1, 3, 12 and 16 outputs (tiles of every
    width), P below 256 and not a multiple of 256, B = 1 and 64, with +inf,
    -inf, NaN and -0 in s (a NaN sum against any NaN); a lane alone bitwise
    equal to the same lane in the batch."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    s, u, y, w = _fused_inputs(B, P, dev, seed=S)
    s[0, :4] = torch.tensor([float('inf'), -float('inf'), -0.0, float('nan')])
    s[B - 1, P - 1] = -0.0
    c = {'line_search': 0.5 ** torch.arange(S, dtype=torch.float32),
         'scale_sweep': torch.linspace(0.5, 2.0, S)}.get(mode)
    c = None if c is None else c.to(dev)
    uu = u if mode == 'line_search' else None
    out = lane.softplus_energies_kernel(s, y, w, c, uu)
    torch.cuda.synchronize()
    terms, dim = lane.softplus_terms(s, y, w, c, uu)
    terms = terms.movedim(dim, -1).contiguous().cpu().numpy()
    want = lane.lane_sum_in_kernel_order(terms.reshape(-1, P)).reshape(tuple(out.shape))
    assert _same_bits(out.cpu(), torch.from_numpy(want))
    assert bool(torch.isnan(out[0]).all()) and bool(torch.isfinite(out[1:]).all())
    for k in (0, B - 1):
        one = lane.softplus_energies_kernel(s[k:k + 1], y[k:k + 1], w[k:k + 1], c,
                                            None if uu is None else uu[k:k + 1])
        assert _same_bits(one[0], out[k])


def _pcg_systems(B, n, dev, seed=0):
    """``B`` SPD systems ``A A^T + d I`` (A with N(0, 1/n) entries) on the
    card, the damping d of lane k cycling through 0.2, 1, 5, 50, 0.05 and
    0.02 (lanes that stop after a few steps, after 20 to 50, and at
    ``CG_MAX_ITERS``), with right-hand sides."""
    rng = np.random.RandomState(seed + B + n)
    A = torch.as_tensor((rng.randn(B, n, n) / np.sqrt(n)).astype(np.float32), device=dev)
    damping = torch.tensor([(0.2, 1.0, 5.0, 50.0, 0.05, 0.02)[k % 6] for k in range(B)],
                           device=dev)
    H = A @ A.transpose(1, 2) + damping[:, None, None] * torch.eye(n, device=dev)
    b = torch.as_tensor(rng.randn(B, n).astype(np.float32), device=dev)
    return H.contiguous(), b


def _same_bits(a, b):
    return bool(((_bits(a) == _bits(b)) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.cuda
@pytest.mark.parametrize('B,n', [(1, 512), (2, 512), (16, 512), (2, 1024), (1, 2048),
                                 (3, 384)])
def test_lane_pcg_equals_the_chain(B, n):
    """``lane_pcg`` (one launch) bitwise equal to the chain it replaces on
    the card (``lane.pcg_chain``: the lane kernels and ATen's elementwise
    ops), its early exit and its full run; a lane alone bitwise equal to the
    same lane in the batch; ``solver._pcg_solve`` launches it once."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    H, b = _pcg_systems(B, n, dev)
    iters, rtol = solver.CG_MAX_ITERS, solver.CG_RTOL
    lane.reset_launch_counts()
    out = solver._pcg_solve(H, b)
    torch.cuda.synchronize()
    assert lane.LAUNCHES['lane_pcg'] == 1 and lane.LAUNCHES['lane_dot'] == 0
    assert bool(torch.isfinite(out).all())
    assert torch.equal(_bits(out), _bits(lane.pcg_chain(H, b, iters, rtol, early_exit=False)))
    assert torch.equal(_bits(out), _bits(lane.pcg_chain(H, b, iters, rtol)))
    for k in (0, B - 1):
        assert torch.equal(_bits(lane.pcg_kernel(H[k:k + 1], b[k:k + 1], iters, rtol)[0]),
                           _bits(out[k]))
    for steps in (0, 1, 7):
        assert torch.equal(_bits(lane.pcg_kernel(H, b, steps, rtol)),
                           _bits(lane.pcg_chain(H, b, steps, rtol, early_exit=False)))


@pytest.mark.cuda
@pytest.mark.parametrize('B,n', [(8, 1024), (2, 510), (3, 511), (2, 512), (3, 513), (2, 1022),
                                 (17, 512), (1, 6), (4, 300)])
def test_lane_pcg_routes_equal_the_chain(B, n):
    """Both of ``lane_pcg``'s routes (H in the cluster's registers at n <=
    ``lane.PCG_REG_MAX_N``, in shared memory and L2 above; the route from n
    alone) bitwise equal to the chain at n on either side of the threshold,
    n not a multiple of 4 (the shared-memory route's scalar load of H), more
    lanes than the card holds clusters at once, and at 0, 1, 5 and all
    steps (lanes that stop at different steps); a lane alone bitwise equal
    to the same lane in the batch."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    H, b = _pcg_systems(B, n, dev)
    rtol = solver.CG_RTOL
    for iters in (0, 1, 5, solver.CG_MAX_ITERS):
        out = lane.pcg_kernel(H, b, iters, rtol)
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(lane.pcg_chain(H, b, iters, rtol, early_exit=False)))
    for k in (0, B - 1):
        assert torch.equal(_bits(lane.pcg_kernel(H[k:k + 1], b[k:k + 1], iters, rtol)[0]),
                           _bits(out[k]))


@pytest.mark.cuda
def test_lane_pcg_graph_replay_equals_eager():
    """``lane_pcg`` captured in a CUDA graph and replayed (on new inputs
    copied into the captured ones) bitwise equal to the eager launch."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    H, b = _pcg_systems(4, 512, dev)
    H2, b2 = _pcg_systems(4, 512, dev, seed=1)
    eager = lane.pcg_kernel(H, b, solver.CG_MAX_ITERS, solver.CG_RTOL)
    eager2 = lane.pcg_kernel(H2, b2, solver.CG_MAX_ITERS, solver.CG_RTOL)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lane.pcg_kernel(H, b, solver.CG_MAX_ITERS, solver.CG_RTOL)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(eager))
    H.copy_(H2)
    b.copy_(b2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(eager2))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [512, 6, 513, 300])
def test_lane_pcg_frozen_and_nan_lanes(n):
    """Lanes the chain never steps (a NaN in H off or on the diagonal, a zero
    right-hand side) and lanes that stop early come out of the kernel as the
    chain leaves them, bitwise (a NaN against any NaN), at n = 512, 300 and
    6 (fewer rows than the cluster has blocks) on the register route and n =
    513 on the shared-memory one."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    H, b = _pcg_systems(6, n, dev)
    H[1, 3, 5] = float('nan')
    H[3, 4, 4] = float('nan')
    b[2] = 0.0
    b[4, 0] = float('inf')
    for iters in (0, 3, solver.CG_MAX_ITERS):
        out = lane.pcg_kernel(H, b, iters, solver.CG_RTOL)
        chain = lane.pcg_chain(H, b, iters, solver.CG_RTOL, early_exit=False)
        assert _same_bits(out, chain)
    assert bool((out[2] == 0).all()) and bool(torch.isnan(out[3, 4]))
    assert _same_bits(out[1], b[1] * (1.0 / torch.diagonal(H[1])))


def _chol_systems(B, n, dev, seed=0):
    """Damped SPD systems ``M M^T / n + d I`` (d from 1e-3 to 10 across the
    lanes) and right-hand sides, on ``dev``."""
    rng = np.random.RandomState(seed + B + n)
    M = rng.randn(B, n, n).astype(np.float32)
    d = np.logspace(-3, 1, B).astype(np.float32)
    H = M @ M.transpose(0, 2, 1) / np.float32(n) + d[:, None, None] * np.eye(n, dtype=np.float32)
    return (torch.as_tensor(H.astype(np.float32), device=dev),
            torch.as_tensor(rng.randn(B, n).astype(np.float32), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize('B,n', [(64, 6), (64, 32), (32, 33), (8, 64), (64, 128), (16, 128),
                                 (4, 256), (1, 256), (40, 256), (1, 300), (3, 335), (2, 336),
                                 (2, 384), (1, 807), (20, 807), (2, 808), (8, 1024),
                                 (16, 1024), (2, 1063), (2, 1064), (2, 2048)])
def test_lane_cholesky_equals_the_chain(B, n):
    """``lane_cholesky`` (one launch) bitwise equal to its order written op
    by op on the card (``lane.cholesky_chain``) on each route: one block a
    lane up to ``CHOL_ONE_BLOCK_MAX_N`` (and at n = 33 and 128 with more
    lanes than the card holds clusters at once), a cluster of 8 a lane up
    to ``CHOL_CLUSTER_MAX_N`` (807: its largest n, at B = 1 and at 20 lanes,
    more clusters than the card holds at once), a cluster of 16 with its
    panels in shared memory up to ``CHOL_WIDE_MAX_N`` (1063; n = 1024 at 8
    and 16 lanes, more than the card holds at once), and in the global
    scratch above (1064, and 2048, the largest DSM bucket); a lane alone
    bitwise equal to the same lane in the batch; ``_cholesky_direction``
    launches it once and no library call."""
    from superdsm_tpu_torch.dsm import lane, solver
    assert (lane.CHOL_CLUSTER_MAX_N, lane.CHOL_WIDE_MAX_N) == (807, 1063)
    dev = _cuda()
    if n > 807:
        assert lane.cholesky_route(B, n) == (2 if n <= 1063 else 3)
    H, g = _chol_systems(B, n, dev)
    lane.reset_launch_counts()
    out = solver._cholesky_direction(H, g)
    torch.cuda.synchronize()
    assert lane.LAUNCHES['lane_cholesky'] == 1
    assert bool(torch.isfinite(out).all())
    assert torch.equal(_bits(out), _bits(lane.cholesky_chain(H, g)))
    for k in sorted({0, B // 2, B - 1}):
        assert torch.equal(_bits(lane.cholesky_kernel(H[k:k + 1], g[k:k + 1])[0]),
                           _bits(out[k]))
    exact = -torch.linalg.solve(H.double(), g.double()[..., None])[..., 0]
    rel = float(((out.double() - exact).norm(dim=1) / exact.norm(dim=1)).max())
    assert rel < 1e-3, rel


@pytest.mark.cuda
@pytest.mark.parametrize('n', [32, 128, 384, 807, 808, 1024, 1064])
def test_lane_cholesky_graph_replay_equals_eager(n):
    """``lane_cholesky`` captured in a CUDA graph and replayed (on new inputs
    copied into the captured ones) bitwise equal to the eager launch, on
    the one-block route, the cluster route of 8 (to its largest n) and the
    two of 16 (panels in shared memory, in the global scratch)."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    H, g = _chol_systems(4, n, dev)
    H2, g2 = _chol_systems(4, n, dev, seed=1)
    eager = lane.cholesky_kernel(H, g)
    eager2 = lane.cholesky_kernel(H2, g2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lane.cholesky_kernel(H, g)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(eager))
    H.copy_(H2)
    g.copy_(g2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(eager2))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [6, 128, 384, 807, 808, 1024, 1064])
def test_lane_cholesky_nan_lanes(n):
    """NaN lanes exactly where the chain has them, bitwise (a NaN against
    any NaN): a lane that is not positive definite, a zero lane, a NaN in
    the lower triangle, an infinite pivot, a pivot that fails inside a
    panel of the cluster route; a NaN in the upper triangle is never read,
    a NaN in g stays in the entries it reaches."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    H, g = _chol_systems(8, n, dev)
    k = min(n // 2 + 3, n - 2)  # inside a panel of 8 columns
    H[7, k, k] = -(n + 1.0)
    H[0] -= 20.0 * torch.eye(n, device=dev)
    H[1] = 0.0
    H[2, n - 1, n // 2] = float('nan')
    H[3, 0, n - 1] = float('nan')
    H[4, n // 2, n // 2] = float('inf')
    g[5, n - 1] = float('nan')
    out = lane.cholesky_kernel(H, g)
    chain = lane.cholesky_chain(H, g)
    torch.cuda.synchronize()
    assert _same_bits(out, chain)
    assert bool(torch.isnan(out[:3]).all()) and bool(torch.isfinite(out[3]).all())
    assert bool(torch.isfinite(out[6]).all()) and bool(torch.isnan(out[5]).any())
    assert bool(torch.isnan(out[7]).all())
    _, info = torch.linalg.cholesky_ex(H[:2])
    assert bool((info != 0).all())


@pytest.mark.cuda
def test_lane_cholesky_refuses_bad_arguments():
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    H, g = _chol_systems(2, 32, dev)
    with pytest.raises(ValueError):
        lane.cholesky_kernel(H.double(), g.double())
    with pytest.raises(ValueError):
        lane.cholesky_kernel(H[:, :16, :16], g)
    with pytest.raises(ValueError):
        lane.cholesky_kernel(H.cpu(), g.cpu())
    lib = gram._load(gram.LANE_SRC)
    out = torch.empty_like(g)
    stream = torch.cuda.current_stream().cuda_stream
    # the cluster routes need their scratch
    for n in (400, 808, 1064):
        H5, g5 = _chol_systems(1, n, dev)
        out5 = torch.empty_like(g5)
        assert lib.sdsm_lane_cholesky(H5.data_ptr(), g5.data_ptr(), out5.data_ptr(), None,
                                      1, n, stream) != 0
    assert lib.sdsm_lane_cholesky(H.data_ptr(), g.data_ptr(), out.data_ptr(), None,
                                  -1, 32, stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize('route', ['dense-1pass', 'banded-3pass'])
def test_bf16_lane_alone_equals_lane_in_batch(route):
    """The bf16 kernel plans its pixel segments from (P, n) alone: a lane
    alone gives bitwise its g and H in the batch (frozen lanes beside it
    included)."""
    dev = _cuda()
    if route == 'dense-1pass':
        Bf, s, yv, w = _dense_problem(5, 4, 8192, 128, dev)
        band, passes, full = None, 1, True
    else:
        Bf, s, yv, w = _band_problem(dev)
        band, passes, full = gram.band_ranges(Bf, w), 3, False
    B = Bf.shape[0]
    active = torch.ones(B, dtype=torch.int32, device=dev)
    active[-1] = 0 if B > 2 else 1
    g, H = gram.grad_hess_kernel(Bf, s, yv, w, active, band, passes=passes, full=full)
    gram.reset_launch_counts()
    for k in range(B):
        one = lambda t: t[k:k + 1].contiguous()
        g1, H1 = gram.grad_hess_kernel(one(Bf), one(s), one(yv), one(w), one(active),
                                       None if band is None else one(band),
                                       passes=passes, full=full)
        torch.cuda.synchronize()
        assert torch.equal(_bits(g1[0]), _bits(g[k])) and torch.equal(_bits(H1[0]), _bits(H[k]))
    assert gram.LAUNCHES[route] == B


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['poly', 'dsm'])
def test_sharded_lane_alone_equals_lane_in_batch_on_the_card(kind):
    """The sharded solver on a (1, 2) mesh of the card twice: a lane alone
    gives bitwise its params, energy and convergence flag in a batch of
    four; its directions and guards are ``lane_chol_step`` launches (the
    Cholesky kernel with the guard in its epilogue), with no
    ``lane_cholesky`` or ``lane_step_guard`` launch of their own."""
    from superdsm_tpu_torch.dsm import lane
    from superdsm_tpu_torch.parallel import mesh as pm
    from superdsm_tpu_torch.parallel.newton import (make_sharded_dsm_solver,
                                                    make_sharded_poly_solver)
    dev = _cuda()
    rng = np.random.RandomState(0)
    B, side, K = 4, 64, 122
    rr, cc = np.indices((side, side))
    pix = np.stack([rr, cc], -1).reshape(-1, 2).astype(np.float32)
    coords = np.tile((pix / (side - 1))[None], (B, 1, 1))
    Y = np.stack([(((rr - rng.randint(20, 44)) ** 2 + (cc - rng.randint(20, 44)) ** 2 < 150)
                   .astype(np.float32) - 0.5).reshape(-1) + rng.randn(side * side).astype(
                       np.float32) * 0.1 for _ in range(B)])
    Wt = np.ones_like(Y)
    card = torch.device('cuda:0')
    mesh = pm.make_mesh(1, 2, [card, card])
    if kind == 'poly':
        solve = make_sharded_poly_solver(mesh)
        args = (np.zeros((B, 6), np.float32), coords, Y, Wt)
    else:
        solve = make_sharded_dsm_solver(mesh, sigma=4.0, cutoff=16)
        sub = rng.randint(0, side, (B, K, 2)).astype(np.float32)
        args = (np.zeros((B, 6 + K), np.float32), coords, np.tile(pix[None], (B, 1, 1)),
                sub, np.ones((B, K), np.float32), Y, Wt, np.full(B, 0.5, np.float32))
    lane.reset_launch_counts()
    batch = [t.cpu().numpy() for t in solve(*args)]
    assert lane.LAUNCHES['lane_chol_step'] > 0
    assert lane.LAUNCHES['lane_cholesky'] == lane.LAUNCHES['lane_step_guard'] == 0
    assert np.isfinite(batch[1]).all()
    for b in (0, B - 1):
        alone = [t.cpu().numpy() for t in solve(*(a[b:b + 1] for a in args))]
        for x, x1 in zip(batch, alone):
            assert np.array_equal(x[b:b + 1], x1)


def _step_systems(B, n, dev, seed=0):
    """A Newton step's ``(params, mu, alpha, kmask, g, H)`` on ``dev``:
    SPD H of the gram's scale, g and params of a few units, kmask with
    padded dimensions (all of the last lane's, at B >= 3), alpha 0.05 to
    0.5, mu from 1e-6 up to 1e-1 across the lanes (inf in lane 1 at B >=
    4: a damping that is not finite)."""
    rng = np.random.RandomState(seed + 7 * B + n)
    K = max(n - 6, 0)
    M = rng.randn(B, n, n).astype(np.float32)
    H = M @ M.transpose(0, 2, 1) / np.float32(n)
    kmask = (rng.rand(B, K) < 0.8).astype(np.float32)
    if B >= 3:
        kmask[-1] = 0.0
    mu = np.logspace(-6, -1, B).astype(np.float32)
    if B >= 4:
        mu[1] = np.inf
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return (t(rng.randn(B, n) * 2), t(mu), t(rng.uniform(0.05, 0.5, B) if K else np.zeros(B)),
            t(kmask), t(rng.randn(B, n) * 3), t(H))


#: ``lane_lm_system``'s main-path shapes (B, n), as chip_smoke.py phase 3.
LM_SHAPES = [(16, 256), (8, 256), (16, 128), (2, 512), (32, 6), (16, 6), (1, 1024), (5, 38)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,n', LM_SHAPES)
def test_lane_lm_system_equals_the_chain(B, n):
    """``lane_lm_system`` (one launch) bitwise equal to the chain it
    replaces on the card (``lane.lm_system_plain``: ATen's ops and the
    ``lane_sum`` kernel), with a lane of infinite damping (NaN off its
    diagonal) and one all-padded kmask; a lane alone bitwise equal to the
    lane in the batch."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    params, mu, alpha, kmask, g, H = _step_systems(B, n, dev)
    lane.reset_launch_counts()
    got = lane.lm_system(params, mu, alpha, 1.0, kmask, g, H)
    torch.cuda.synchronize()
    assert lane.LAUNCHES['lane_lm_system'] == 1 and lane.LAUNCHES['lane_sum'] == 0
    want = lane.lm_system_plain(params, mu, alpha, 1.0, kmask, g, H)
    for x, y in zip(got, want):
        assert _same_bits(x, y)
    for k in sorted({0, B // 2, B - 1}):
        alone = lane.lm_system_kernel(*(a[k:k + 1] for a in (params, mu, alpha)), 1.0,
                                      *(a[k:k + 1] for a in (kmask, g, H)))
        for x, y in zip(alone, got):
            assert _same_bits(x[0], y[k])


#: ``lane_step_guard``'s main-path shapes (B, n), as chip_smoke.py phase 3.
GUARD_SHAPES = [(2, 512), (16, 256), (8, 256), (2, 6), (1, 1024), (5, 38)]


@pytest.mark.cuda
@pytest.mark.parametrize('negate', [False, True])
@pytest.mark.parametrize('B,n', GUARD_SHAPES)
def test_lane_step_guard_equals_the_chain(B, n, negate):
    """``lane_step_guard`` (one launch) bitwise equal to the chain it
    replaces on the card (``lane.step_guard_plain``: ATen's ops, the
    ``lane_dot`` and ``lane_sum`` kernels), negated (PCG's solution) or
    not, with a NaN direction in lane 0 and an infinite f0 in the last
    lane; a lane alone bitwise equal to the lane in the batch."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    params, _, alpha, kmask, g, _ = _step_systems(B, n, dev, seed=1)
    rng = np.random.RandomState(n + B)
    direction = torch.as_tensor((rng.randn(B, n) * 0.5).astype(np.float32), device=dev)
    direction[0, n // 2] = float('nan')
    f0 = torch.as_tensor((rng.rand(B) * 1e3).astype(np.float32), device=dev)
    f0[-1] = float('inf')
    steps = 0.5 ** torch.arange(solver.LS_STEPS, dtype=torch.float32, device=dev)
    args = (direction, g, params, alpha, 1.0, kmask, steps, f0, solver.ARMIJO_C, negate)
    lane.reset_launch_counts()
    got = lane.step_guard(*args)
    torch.cuda.synchronize()
    assert lane.LAUNCHES['lane_step_guard'] == 1 and lane.LAUNCHES['lane_dot'] == 0
    want = lane.step_guard_plain(*args)
    assert (got[2] is None) == (want[2] is None) == (n <= 6)
    for x, y in zip(got, want):
        assert x is None or _same_bits(x, y)
    assert bool(torch.isfinite(got[0]).all())
    for k in sorted({0, B // 2, B - 1}):
        one = [a[k:k + 1] if isinstance(a, torch.Tensor) and a is not steps else a
               for a in args]
        for x, y in zip(lane.step_guard_kernel(*one), got):
            assert x is None or _same_bits(x[0], y[k])


#: The direction launch's shapes (B, n), as chip_smoke.py phase 3 (the
#: damped system's prologue; PCG above ``CHOLESKY_MAX_N``), and a few more
#: (a lane of n = 38, many lanes at n = 128 on the one-block route, the
#: first n of the routes of 16 blocks, the largest DSM bucket).
DIRECTION_SHAPES = [(16, 256), (2, 512), (8, 256), (16, 128), (32, 6), (16, 6), (8, 6),
                    (2, 256), (2, 6), (16, 512), (2, 1024), (5, 38), (64, 128), (2, 808)]
#: The guard alone (the sharded solver's), Cholesky at every n.
GUARD_ONLY_SHAPES = [(8, 128), (5, 38), (2, 6), (8, 1024), (1, 2048)]


def _three_launches(params, mu, alpha, epsilon, kmask, g, H, steps, f0, armijo_c, pcg=None):
    from superdsm_tpu_torch.dsm import lane
    if mu is not None:
        g, H = lane.lm_system_kernel(params, mu, alpha, epsilon, kmask, g, H)
    direction = lane.pcg_kernel(H, g, *pcg) if pcg else lane.cholesky_kernel(H, g)
    return lane.step_guard_kernel(direction, g, params, alpha, epsilon, kmask, steps, f0,
                                  armijo_c, pcg is not None)


def _same_outputs_or_none(x, y):
    return all(u is None and v is None or (u is not None and v is not None and _same_bits(u, v))
               for u, v in zip(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize('damped,B,n', [(True, B, n) for B, n in DIRECTION_SHAPES]
                         + [(False, B, n) for B, n in GUARD_ONLY_SHAPES])
def test_newton_direction_equals_the_chain(damped, B, n):
    """The direction launch (``lane.newton_direction``: the damped system,
    the direction and its guard in one launch; ``damped`` False: the guard
    alone on a system the caller damped) bitwise equal to the three launches
    it replaced (``lane_lm_system``, ``lane_cholesky`` or ``lane_pcg``,
    whose solution the guard negates, and ``lane_step_guard``) and, up to n
    = 512, to its plain version on the card; with a lane of infinite
    damping, a lane that is not positive definite, an all-padded kmask and
    an infinite f0; a lane alone bitwise the lane in the batch; a captured
    graph's replay bitwise the eager launch."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    params, mu, alpha, kmask, g, H = _step_systems(B, n, dev, seed=4)
    if B >= 2:
        H[B // 2] = -H[B // 2]  # not positive definite: the guard's gradient step
    if not damped:
        mu = None
    rng = np.random.RandomState(n + 3 * B)
    f0 = torch.as_tensor((rng.rand(B) * 1e3).astype(np.float32), device=dev)
    f0[-1] = float('inf')
    steps = solver._steps(torch.float32, dev)
    pcg = (solver.CG_MAX_ITERS, solver.CG_RTOL) if damped and n > solver.CHOLESKY_MAX_N \
        else None
    args = (params, mu, alpha, 1.0, kmask, g, H, steps, f0, solver.ARMIJO_C, pcg)
    lane.reset_launch_counts()
    got = lane.newton_direction(*args)
    torch.cuda.synchronize()
    name = 'lane_pcg_step' if pcg else 'lane_chol_step'
    assert lane.LAUNCHES[name] == 1
    assert lane.LAUNCHES['lane_lm_system'] == int(bool(pcg) and n > lane.PCG_REG_MAX_N)
    assert lane.LAUNCHES['lane_step_guard'] == lane.LAUNCHES['lane_cholesky'] == \
        lane.LAUNCHES['lane_pcg'] == lane.LAUNCHES['lane_dot'] == 0
    assert (got[2] is None) == (n <= 6)
    assert _same_outputs_or_none(got, _three_launches(*args))
    if n <= 512:
        assert _same_outputs_or_none(got, lane.newton_direction_plain(*args))
    assert bool(torch.isfinite(got[0]).all())
    for k in sorted({0, B // 2, B - 1}):
        one = [a[k:k + 1] if isinstance(a, torch.Tensor) and a is not steps else a
               for a in args]
        for x, y in zip(lane.newton_direction_kernel(*one), got):
            assert x is None or _same_bits(x[0], y[k])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = lane.newton_direction_kernel(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert _same_outputs_or_none(captured, got)


@pytest.mark.cuda
def test_newton_direction_refuses_bad_arguments():
    """The direction launch raises on what its kernels do not take (never
    falls back to the three launches or the plain version): a CPU tensor
    beside CUDA ones, a wrong shape, more line-search steps than the guard
    holds."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    params, mu, alpha, kmask, g, H = _step_systems(2, 38, dev)
    f0 = torch.zeros(2, device=dev)
    steps = solver._steps(torch.float32, dev)
    ok = (params, mu, alpha, 1.0, kmask, g, H, steps, f0, solver.ARMIJO_C)
    lane.newton_direction_kernel(*ok)
    bad = [dict(g=g.cpu()), dict(H=H[:, :, :37].contiguous()),
           dict(steps=torch.ones(17, device=dev))]
    names = ('params', 'mu', 'alpha', 'epsilon', 'kmask', 'g', 'H', 'steps', 'f0', 'armijo_c')
    for change in bad:
        args = [change.get(k, v) for k, v in zip(names, ok)]
        with pytest.raises((ValueError, RuntimeError)):
            lane.newton_direction_kernel(*args)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [6, 128, 512])
def test_newton_step_launches_the_step_kernels(n, monkeypatch):
    """``solver._newton_step`` on the card makes one direction launch (the
    damped system, the direction and its guard: ``lane_chol_step``, or
    ``lane_pcg_step`` at n > ``CHOLESKY_MAX_N``) and no ``lane_lm_system``,
    ``lane_step_guard``, ``lane_cholesky``, ``lane_pcg`` or ``lane_dot``
    launch; its result is bitwise the same step with the plain version in
    its place."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    B, P = 4, 2048
    params, mu, alpha, kmask, g, H = _step_systems(B, n, dev, seed=2)
    mu = torch.full_like(mu, 1e-3)
    rng = np.random.RandomState(n)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    Bf, yv, w = t(rng.randn(B, P, n) * 0.1), t(np.sign(rng.randn(B, P))), t(rng.rand(B, P) < 0.9)
    s = lane.matvec(Bf, params)
    f0 = solver._energy_from_surface(s, params[:, 6:], yv, w, alpha, 1.0, kmask)
    args = (params, mu, s, f0, g, H, Bf, yv, w, alpha, 1.0, kmask, 1e-5)
    lane.reset_launch_counts()
    out = solver._newton_step(*args)
    torch.cuda.synchronize()
    name = 'lane_pcg_step' if n > solver.CHOLESKY_MAX_N else 'lane_chol_step'
    assert lane.LAUNCHES[name] == 1
    assert not any(lane.LAUNCHES[k] for k in ('lane_lm_system', 'lane_step_guard',
                                              'lane_cholesky', 'lane_pcg', 'lane_dot'))
    monkeypatch.setattr(lane, 'newton_direction', lane.newton_direction_plain)
    for x, y in zip(out, solver._newton_step(*args)):
        assert torch.equal(x, y)


def _tail_inputs(B, P, n, dev, seed=0):
    """A step's pick and tail inputs on ``dev``: energies around f0 (1e3 to
    1e4), and by lane b % 6: as drawn; no passing step with tied least
    candidates; a NaN candidate; every candidate +inf; a NaN scale
    candidate; every scale candidate -inf. mu spans MU_MIN to MU_MAX; conv
    is set in lanes b % 3 == 2, which hold a NaN of their own payload and
    -0 in params and s."""
    from superdsm_tpu_torch.dsm import solver
    rng = np.random.RandomState(seed + B + P + n)
    S, SC, K = solver.LS_STEPS, len(solver.SCALES), max(n - 6, 0)
    steps = solver._steps(torch.float32, dev)
    f0 = rng.uniform(1e3, 1e4, B)
    dec = rng.uniform(0, 50, B)
    thr = f0[:, None] - solver.ARMIJO_C * steps.cpu().numpy() * dec[:, None]
    data = f0[:, None] + rng.randn(B, S) * 20
    data_sc = f0[:, None] + rng.randn(B, SC) * 20
    for b in range(B):
        if b % 6 == 1:
            data[b] = f0[b] + 5 + rng.rand(S)
            data[b, 2] = data[b, 9] = f0[b] + 4
        elif b % 6 == 2:
            data[b, 4] = np.nan
        elif b % 6 == 3:
            data[b] = np.inf
        elif b % 6 == 4:
            data_sc[b, 5] = np.nan
        elif b % 6 == 5:
            data_sc[b] = -np.inf
    mu = np.clip(10.0 ** rng.uniform(-11, 7, B), solver.MU_MIN, solver.MU_MAX)
    conv = np.arange(B) % 3 == 2
    params = (rng.randn(B, n) * 0.1).astype(np.float32)
    s = (rng.randn(B, P) * 3).astype(np.float32)
    params[conv, :2] = [np.uint32(0x7fc01234).view(np.float32), -0.0]
    if P:
        s[conv, :2] = params[conv, :2]
    kmask = (rng.rand(B, K) < 0.8).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=dev).to(dt)
    return dict(data_cand=t(data), reg_cand=t(rng.uniform(0, 2, (B, S))) if n > 6 else None,
                armijo_f=t(thr), f0=t(f0), steps=steps, params=t(params),
                delta=t(rng.randn(B, n) * 0.2), s=t(s), u=t(rng.randn(B, P)), data_sc=t(data_sc),
                mu=t(mu), decrement=t(dec), alpha=t(np.full(B, 0.5)), kmask=t(kmask),
                scales=solver._scales(torch.float32, dev), conv=t(conv, torch.bool),
                it_lane=t(rng.randint(0, 5, B), torch.int32), it_dev=t(5, torch.int32))


def _pick(fn, a, lanes=slice(None)):
    L = lambda x: None if x is None else x[lanes]
    return fn(L(a['data_cand']), L(a['reg_cand']), L(a['armijo_f']), L(a['f0']), a['steps'],
              L(a['params']), L(a['delta']), L(a['s']), L(a['u']))


def _tail(fn, a, pick, lanes=slice(None), state=None):
    from superdsm_tpu_torch.dsm import solver
    L = lambda x: None if x is None else x[lanes]
    return fn(L(a['data_sc']), *(L(x) for x in pick[1:]), L(a['mu']), L(a['f0']),
              L(a['decrement']), L(a['alpha']), 1.0, L(a['kmask']), a['scales'],
              solver.DEFAULT_TOL, solver.MU_MIN, solver.MU_MAX, state)


def _same_outputs(x, y):
    return all(u is None and v is None or (
        torch.equal(u, v) if u.dtype == torch.bool else _same_bits(u, v)) for u, v in zip(x, y))


#: ``lane_step_pick``'s and ``lane_step_tail``'s main-path shapes (B, P, n),
#: as chip_smoke.py phase 3, and two more (a wide n, no surface).
TAIL_SHAPES = [(2, 16384, 512), (8, 12288, 256), (16, 8192, 256), (16, 6144, 128),
               (32, 16384, 6), (1, 2048, 1024), (7, 0, 38)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,P,n', TAIL_SHAPES)
def test_lane_step_pick_and_tail_equal_the_chains(B, P, n):
    """``lane_step_pick`` and ``lane_step_tail`` (one launch each) bitwise
    equal to the chains they replace on the card, a NaN against any NaN;
    a lane alone bitwise the lane in the batch; the tail in the loop's mode
    (f0 the loop's fval, mu the loop's, both written in place) bitwise the
    chain's freeze on a copy of the state, its converged lanes' state
    untouched to the bit."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    a = _tail_inputs(B, P, n, dev)
    if P == 0:
        a['s'] = a['u'] = None
    lane.reset_launch_counts()
    pick = _pick(lane.step_pick, a)
    out = _tail(lane.step_tail, a, pick)
    torch.cuda.synchronize()
    assert lane.LAUNCHES['lane_step_pick'] == lane.LAUNCHES['lane_step_tail'] == 1
    assert lane.LAUNCHES['lane_sum'] == 0
    assert _same_outputs(pick, _pick(lane.step_pick_plain, a))
    assert _same_outputs(out, _tail(lane.step_tail_plain, a, pick))
    for b in sorted({0, B // 2, B - 1}):
        one = _pick(lane.step_pick_kernel, a, slice(b, b + 1))
        assert _same_outputs([x[0] for x in one if x is not None],
                             [x[b] for x in pick if x is not None])
        one = _tail(lane.step_tail_kernel, a, pick, slice(b, b + 1))
        assert _same_outputs([x[0] for x in one if x is not None],
                             [x[b] for x in out if x is not None])
    keys = ('params', 's', 'f0', 'it_lane', 'it_dev', 'conv', 'mu')
    states = []
    for fn in (lane.step_tail_kernel, lane.step_tail_plain):
        st = {k: None if a[k] is None else a[k].clone() for k in keys}
        _tail(fn, dict(a, mu=st['mu'], f0=st['f0']), pick, state=lane.FreezeState(
            st['params'], st['s'], st['f0'], st['it_lane'], st['it_dev'], st['conv']))
        states.append(st)
    assert _same_outputs([states[0][k] for k in keys], [states[1][k] for k in keys])
    frozen = a['conv']
    for k in ('params', 's', 'f0', 'mu', 'it_lane'):
        if a[k] is not None:
            assert torch.equal(states[0][k][frozen].view(torch.int32),
                               a[k][frozen].view(torch.int32))
    assert bool(states[0]['conv'][frozen].all())


@pytest.mark.cuda
@pytest.mark.parametrize('n', [6, 128, 512])
def test_newton_step_launches_the_tail_kernels(n, monkeypatch):
    """``solver._newton_step`` on the card launches ``lane_step_pick`` and
    ``lane_step_tail`` once each and no ``lane_sum``; its result is bitwise
    the same step with their chains in their place, and its loop mode
    bitwise its return mode followed by the former freeze writes."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    B, P = 4, 2048
    params, mu, alpha, kmask, g, H = _step_systems(B, n, dev, seed=3)
    mu = torch.full_like(mu, 1e-3)
    rng = np.random.RandomState(n + 1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    Bf, yv, w = t(rng.randn(B, P, n) * 0.1), t(np.sign(rng.randn(B, P))), t(rng.rand(B, P) < 0.9)
    s = lane.matvec(Bf, params)
    f0 = solver._energy_from_surface(s, params[:, 6:], yv, w, alpha, 1.0, kmask)
    args = (params, mu, s, f0, g, H, Bf, yv, w, alpha, 1.0, kmask, 1e-5)
    lane.reset_launch_counts()
    out = solver._newton_step(*args)
    torch.cuda.synchronize()
    assert lane.LAUNCHES['lane_step_pick'] == lane.LAUNCHES['lane_step_tail'] == 1
    assert lane.LAUNCHES['lane_sum'] == 0
    conv = torch.tensor([False, True, False, True], device=dev)
    it_lane, it_dev = torch.zeros(B, dtype=torch.int32, device=dev), torch.ones((), dtype=torch.int32, device=dev)
    state = [x.clone() for x in (params, s, f0, mu)]
    c = conv.clone()
    solver._newton_step(state[0], state[3], state[1], state[2], *args[4:],
                        state=lane.FreezeState(state[0], state[1], state[2], it_lane, it_dev, c))
    keep = conv[:, None]
    for x, y in ((state[0], torch.where(keep, params, out[0])),
                 (state[1], torch.where(keep, s, out[1])), (state[2], torch.where(conv, f0, out[2])),
                 (state[3], torch.where(conv, mu, out[4])), (c, conv | out[3]),
                 (it_lane, torch.where(conv, 0, it_dev).int())):
        assert torch.equal(x, y)
    monkeypatch.setattr(lane, 'step_pick', lane.step_pick_plain)
    monkeypatch.setattr(lane, 'step_tail', lane.step_tail_plain)
    for x, y in zip(out, solver._newton_step(*args)):
        assert _same_bits(x, y) if x.dtype != torch.bool else torch.equal(x, y)


def _sweep_case(B, P, n, dev, seed=0):
    """:func:`_tail_inputs` with the scale sweep's labels and weights (10%
    padding), lanes b % 6 == 4 holding a NaN label (NaN scale candidates)
    and b % 6 == 5 a -inf weight (-inf ones)."""
    a = _tail_inputs(B, P, n, dev, seed)
    rng = np.random.RandomState(seed + B + P + n + 1)
    yv = np.sign(rng.randn(B, P)).astype(np.float32)
    w = ((rng.rand(B, P) < 0.9) * rng.rand(B, P)).astype(np.float32)
    for b in range(B):
        if b % 6 == 4:
            yv[b, 1] = np.nan
        elif b % 6 == 5:
            w[b, 1] = -np.inf
    a['yv'], a['w'] = (torch.as_tensor(x, device=dev) for x in (yv, w))
    return a


#: The loop's state that the step writes in place, and mu.
_SWEEP_STATE = ('params', 's', 'f0', 'it_lane', 'it_dev', 'conv', 'mu')


def _sweep_state(a):
    return {k: a[k].clone() for k in _SWEEP_STATE}


def _sweep(fn, a, st, lanes=slice(None), scratch=None, **kw):
    """``fn`` (``lane.step_sweep_kernel`` or a chain of the same arguments)
    on :func:`_sweep_case`'s inputs, writing lanes ``lanes`` of the state
    ``st`` in place."""
    from superdsm_tpu_torch.dsm import lane, solver
    L = lambda x: None if x is None else x[lanes]
    state = lane.FreezeState(L(st['params']), L(st['s']), L(st['f0']), L(st['it_lane']),
                             st['it_dev'], L(st['conv']), scratch)
    return fn(L(a['data_cand']), L(a['reg_cand']), L(a['armijo_f']), a['steps'], L(a['delta']),
              L(a['u']), L(a['yv']), L(a['w']), L(st['mu']), L(a['decrement']), L(a['alpha']),
              1.0, L(a['kmask']), a['scales'], solver.DEFAULT_TOL, solver.MU_MIN,
              solver.MU_MAX, state, **kw)


def _three_launches_sweep(data_cand, reg_cand, armijo_f, steps, delta, u, yv, w, mu, decrement,
                          alpha, epsilon, kmask, scales, tol, mu_min, mu_max, state):
    """The three launches ``lane_step_sweep`` replaces: ``lane_step_pick``,
    the sweep's ``softplus_energies`` and ``lane_step_tail`` given the
    state."""
    from superdsm_tpu_torch.dsm import lane
    _, new_params, new_s, new_f, improved, full_step = lane.step_pick_kernel(
        data_cand, reg_cand, armijo_f, state.fval, steps, state.params, delta, state.s, u)
    data_sc = lane.softplus_energies_kernel(new_s, yv, w, scales)
    lane.step_tail_kernel(data_sc, new_params, new_s, new_f, improved, full_step, mu, state.fval,
                          decrement, alpha, epsilon, kmask, scales, tol, mu_min, mu_max,
                          lane.FreezeState(*state[:6]))


def _same_state(x, y, lanes=slice(None)):
    return _same_outputs([x[k][lanes] if x[k].dim() else x[k] for k in _SWEEP_STATE],
                         [y[k][lanes] if y[k].dim() else y[k] for k in _SWEEP_STATE])


#: ``lane_step_sweep``'s shapes: :data:`TAIL_SHAPES` with a surface (the
#: loop's step always has one).
SWEEP_SHAPES = [shape for shape in TAIL_SHAPES if shape[1]]


@pytest.mark.cuda
@pytest.mark.parametrize('B,P,n', SWEEP_SHAPES)
def test_lane_step_sweep_equals_the_three_launches(B, P, n):
    """``lane_step_sweep`` (one launch: the pick, the scale sweep's sums and
    the tail with the freeze writes) writes bitwise the state the three
    launches it replaces write, and its plain version on the card, a NaN
    against any NaN; at 1, 2 and 4 tiles a lane forced; a lane alone
    bitwise the lane in its batch; converged lanes untouched to the bit;
    the arrival counters back at 0."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    a = _sweep_case(B, P, n, dev)
    states = [_sweep_state(a) for _ in range(3)]
    scratch = lane.sweep_scratch(B, a['scales'].numel(), dev)
    lane.reset_launch_counts()
    _sweep(lane.step_sweep_kernel, a, states[0], scratch=scratch)
    torch.cuda.synchronize()
    assert lane.LAUNCHES['lane_step_sweep'] == 1
    assert not any(v for k, v in lane.LAUNCHES.items() if k != 'lane_step_sweep')
    assert not scratch.arrivals.any()
    _sweep(_three_launches_sweep, a, states[1])
    _sweep(lane.step_sweep_plain, a, states[2])
    assert _same_state(states[0], states[1]) and _same_state(states[0], states[2])
    for tiles in (1, 2, 4):
        st = _sweep_state(a)
        _sweep(lane.step_sweep_kernel, a, st, scratch=scratch, k_tiles=tiles)
        assert _same_state(st, states[0]), tiles
        assert not scratch.arrivals.any()
    for b in sorted({0, B // 2, B - 1}):
        st = _sweep_state(a)
        _sweep(lane.step_sweep_kernel, a, st, slice(b, b + 1))
        assert _same_state(st, states[0], slice(b, b + 1)), b
    frozen = a['conv']
    for k in ('params', 's', 'f0', 'mu', 'it_lane'):
        assert torch.equal(states[0][k][frozen].view(torch.int32), a[k][frozen].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('B,P,n', SWEEP_SHAPES[:2] + SWEEP_SHAPES[4:5])
def test_lane_step_sweep_over_graph_replays(B, P, n):
    """A CUDA graph of one ``lane_step_sweep`` launch (the solve's scratch
    kept across replays) replayed twice in a row writes bitwise what the
    three launches write run twice: the first replay leaves every arrival
    counter at 0 for the second."""
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    a = _sweep_case(B, P, n, dev, seed=1)
    scratch = lane.sweep_scratch(B, a['scales'].numel(), dev)
    _sweep(lane.step_sweep_kernel, a, _sweep_state(a), scratch=scratch)  # loads, plans
    st, want = _sweep_state(a), _sweep_state(a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _sweep(lane.step_sweep_kernel, a, st, scratch=scratch)
    for _ in range(2):
        graph.replay()
        _sweep(_three_launches_sweep, a, want)
        torch.cuda.synchronize()
        assert _same_state(st, want)
        assert not scratch.arrivals.any()


@pytest.mark.cuda
def test_lane_step_sweep_from_two_threads():
    """Two threads, each on its own stream with its own state and scratch,
    each capturing its own graph of ``lane_step_sweep`` and replaying it
    twice, write bitwise what the three launches write run twice."""
    import threading
    from superdsm_tpu_torch.dsm import lane
    dev = _cuda()
    B, P, n = 8, 12288, 256
    a = _sweep_case(B, P, n, dev, seed=2)
    _sweep(lane.step_sweep_kernel, a, _sweep_state(a))  # loads, plans
    want = _sweep_state(a)
    for _ in range(2):
        _sweep(_three_launches_sweep, a, want)
    torch.cuda.synchronize()
    results, errors = [None, None], []

    def run(i):
        try:
            stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(stream):
                st = _sweep_state(a)
                scratch = lane.sweep_scratch(B, a['scales'].numel(), dev)
                stream.synchronize()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(capture_error_mode='thread_local')
                _sweep(lane.step_sweep_kernel, a, st, scratch=scratch)
                graph.capture_end()
                for _ in range(2):
                    graph.replay()
                stream.synchronize()
                results[i] = (st, scratch)
        except Exception as e:  # reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and all(r is not None for r in results), errors
    for st, scratch in results:
        assert _same_state(st, want)
        assert not scratch.arrivals.any()


@pytest.mark.cuda
@pytest.mark.parametrize('n', [6, 128, 512])
def test_newton_step_in_the_loop_launches_the_sweep(n, monkeypatch):
    """``solver._newton_step`` given the loop's state launches
    ``lane_step_sweep`` once and no ``lane_step_pick``, ``lane_step_tail``
    or scale-sweep ``softplus_energies``; the state it writes is bitwise
    that of the same step with its plain version, and with the three
    launches, in its place."""
    from superdsm_tpu_torch.dsm import lane, solver
    dev = _cuda()
    B, P = 4, 2048
    params, mu, alpha, kmask, g, H = _step_systems(B, n, dev, seed=4)
    mu = torch.full_like(mu, 1e-3)
    rng = np.random.RandomState(n + 2)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    Bf, yv, w = t(rng.randn(B, P, n) * 0.1), t(np.sign(rng.randn(B, P))), t(rng.rand(B, P) < 0.9)
    s = lane.matvec(Bf, params)
    f0 = solver._energy_from_surface(s, params[:, 6:], yv, w, alpha, 1.0, kmask)
    conv = torch.tensor([False, True, False, False], device=dev)

    def step():
        st = [x.clone() for x in (params, s, f0, mu)]
        it_lane = torch.zeros(B, dtype=torch.int32, device=dev)
        it_dev = torch.ones((), dtype=torch.int32, device=dev)
        c = conv.clone()
        solver._newton_step(st[0], st[3], st[1], st[2], g, H, Bf, yv, w, alpha, 1.0, kmask, 1e-5,
                            state=lane.FreezeState(st[0], st[1], st[2], it_lane, it_dev, c,
                                                   lane.sweep_scratch(B, 8, dev)))
        return st + [it_lane, c]
    lane.reset_launch_counts()
    got = step()
    torch.cuda.synchronize()
    assert lane.LAUNCHES['lane_step_sweep'] == 1
    assert lane.LAUNCHES['lane_step_pick'] == lane.LAUNCHES['lane_step_tail'] == 0
    assert lane.LAUNCHES['softplus_energies'] == 1  # the line search's
    for replacement in (lane.step_sweep_plain, _three_launches_sweep):
        monkeypatch.setattr(lane, 'step_sweep', replacement)
        assert _same_outputs(got, step())


def _decode_rows(B, pb, seed):
    """(B, pb // 2) MSB-first masks from a seed: random densities, and in
    the first rows an empty row, ``cnt`` below and above the set bits, more
    set bits than ``pb`` and a row whose bits end in its last byte."""
    rng = np.random.RandomState(seed)
    nbits = pb * 4
    bits = rng.rand(B, nbits) < rng.uniform(0.01, 0.3, (B, 1))
    cnt = np.minimum(bits.sum(1), pb).astype(np.int32)
    edges = [np.zeros(nbits, bool), rng.rand(nbits) < 0.1, rng.rand(nbits) < 0.1,
             rng.rand(nbits) < 0.6, np.arange(nbits) >= nbits - 3]
    for j, row in enumerate(edges[:B]):
        bits[j] = row
        cnt[j] = min(int(row.sum()), pb)
    if B > 2:
        cnt[0], cnt[1], cnt[2] = 4, max(cnt[1] - 5, 0), min(cnt[2] + 9, pb)
    wd = rng.randint(1, 200, B).astype(np.int32)
    return np.packbits(bits, axis=1), wd, cnt


@pytest.mark.cuda
@pytest.mark.parametrize('B,pb', [(5, 128), (7, 24), (64, 24576), (16, 16384), (2, 131072)])
def test_mask_decode_kernel_is_mask_to_pix(B, pb):
    """The decode kernel (``csrc/mask_ops.cu``, one launch) gives
    ``solver._mask_to_pix``'s coordinates bitwise on the card, on random
    rows and the edge rows of :func:`_decode_rows`, and ``_decode_mask``
    launches it once for CUDA tensors."""
    from superdsm_tpu_torch.dsm import mask, solver
    dev = _cuda()
    mb, wd, cnt = (torch.as_tensor(a, device=dev) for a in _decode_rows(B, pb, B + pb))
    want = solver._mask_to_pix(mb, wd, cnt, pb)
    mask.reset_launch_counts()
    got = solver._decode_mask(mb, wd, cnt, pb)
    torch.cuda.synchronize()
    assert mask.LAUNCHES['mask_to_pix'] == 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    # a row length that is no multiple of 16 bytes, and a misaligned row
    odd = mb[:, 1:].contiguous()
    assert torch.equal(mask.mask_to_pix_kernel(odd, wd, cnt, pb // 2),
                       solver._mask_to_pix(odd, wd, cnt, pb // 2))


@pytest.mark.cuda
def test_mask_decode_kernel_raises_on_what_it_does_not_take():
    """The decode kernel's wrapper raises on CPU tensors and bad shapes; it
    never takes the plain version."""
    from superdsm_tpu_torch.dsm import mask
    dev = _cuda()
    mb = torch.zeros((3, 64), dtype=torch.uint8, device=dev)
    wd, cnt = torch.ones(3, dtype=torch.int32, device=dev), torch.zeros(3, dtype=torch.int32,
                                                                         device=dev)
    for args in ((mb.cpu(), wd, cnt, 128), (mb, wd[:2], cnt, 128), (mb, wd.long(), cnt, 128),
                 (mb[0], wd, cnt, 128), (mb, wd, cnt, -1)):
        with pytest.raises(ValueError):
            mask.mask_to_pix_kernel(*args)


def _narrow_problem(seed, B, P, n, dev):
    """Random features, weights 1 on the first 10% to 95% of each lane's
    pixels (0 after, with intensity 0), every fourth lane frozen."""
    rng = np.random.RandomState(seed)
    Bf = rng.rand(B, P, n) - 0.5
    s = rng.randn(B, P) * 2.0
    w = np.zeros((B, P))
    for b in range(B):
        w[b, :int(P * rng.uniform(0.1, 0.95))] = 1.0
    yv = np.sign(rng.randn(B, P)) * rng.uniform(0.05, 1.0, (B, P)) * w
    active = np.ones(B, np.int32)
    active[::4] = 0 if B > 1 else 1
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (Bf, s, yv, w)) \
        + (torch.as_tensor(active, device=dev),)


def _ulps(x, ref):
    top = ref.abs().flatten(1).amax(dim=1).double().clamp_min(1e-30)
    return (x - ref).abs().flatten(1).amax(dim=1).double() / \
        torch.exp2(torch.floor(torch.log2(top)) - 23)


@pytest.mark.cuda
@pytest.mark.parametrize('B,P,n', [(32, 16384, 6), (64, 2048, 32), (16, 8192, 64),
                                   (1, 2048, 32), (2, 6144, 64), (3, 2080, 6)])
def test_narrow_kernel_matches_plain(B, P, n):
    dev = _cuda()
    Bf, s, yv, w, active = _narrow_problem(B + n, B, P, n, dev)
    g, H = gram.narrow_kernel(Bf, s, yv, w, active)
    g2, H2 = gram.narrow_kernel(Bf, s, yv, w, active)
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(H, H2)
    on = active != 0
    assert not g[~on].any() and not H[~on].any()
    assert float(_ulps(H[on], H_ref[on]).max()) <= 2.0
    assert float(_ulps(g[on], g_ref[on]).max()) <= 2.0
    assert torch.equal(H, H.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [6, 32, 64])
def test_narrow_lane_alone_as_in_its_batch(n):
    """A lane's bits alone, in a batch of 2, with the other lanes frozen and
    in a captured graph's replay are those of the lane in its batch of 8."""
    dev = _cuda()
    Bf, s, yv, w, active = _narrow_problem(n, 8, 6144, n, dev)
    g, H = gram.narrow_kernel(Bf, s, yv, w, active)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for b in (1, 7):
        lane = [x[b:b + 1] for x in (Bf, s, yv, w)]
        g1, H1 = gram.narrow_kernel(*lane, one)
        gp, Hp = gram.narrow_kernel(*[torch.cat([x, x]) for x in lane], torch.cat([one, one]))
        alone = torch.zeros_like(active)
        alone[b] = 1
        gf, Hf = gram.narrow_kernel(Bf, s, yv, w, alone)
        for gx, Hx, i in ((g1, H1, 0), (gp, Hp, 1), (gf, Hf, b)):
            assert torch.equal(gx[i], g[b]) and torch.equal(Hx[i], H[b])
    graph = torch.cuda.CUDAGraph()
    gram.narrow_kernel(Bf, s, yv, w, active)
    torch.cuda.synchronize()
    gram.reset_launch_counts()
    with gram.recording_launches() as records, torch.cuda.graph(graph):
        out = gram.narrow_kernel(Bf, s, yv, w, active)
    for _ in range(2):
        graph.replay()
        gram.count_replayed(records)
    torch.cuda.synchronize()
    assert torch.equal(out[0], g) and torch.equal(out[1], H)
    assert gram.LAUNCHES['narrow'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('n', [6, 32, 64])
def test_narrow_kernel_skips_zero_weight_chunks(n):
    """The kernel neither reads nor sums a chunk whose weights are all 0
    (whole segments of them included): NaN in such chunks' features,
    surface and intensities leaves every lane's g and H bitwise those of the
    finite values there."""
    dev = _cuda()
    B, P = 8, 6144
    Bf, s, yv, w, active = _narrow_problem(n + 3, B, P, n, dev)
    rows = gram.NARROW_ROWS[n]
    dead = ~(w.view(B, -1, rows) != 0).any(dim=2)
    seg_chunks = gram.narrow_plan(P, n)[0]
    assert dead.any() and not dead.all()
    assert dead.view(B, -1, seg_chunks).all(dim=2).any()
    pix = dead.repeat_interleave(rows, dim=1)
    nan = float('nan')
    g, H = gram.narrow_kernel(Bf, s, yv, w, active)
    gn, Hn = gram.narrow_kernel(Bf.masked_fill(pix[..., None], nan), s.masked_fill(pix, nan),
                                yv.masked_fill(pix, nan), w, active)
    torch.cuda.synchronize()
    assert torch.isfinite(gn).all() and torch.isfinite(Hn).all()
    assert torch.equal(gn, g) and torch.equal(Hn, H)


@pytest.mark.cuda
def test_narrow_library_refuses_bad_arguments():
    dev = _cuda()
    Bf, s, yv, w, active = _narrow_problem(0, 1, 2048, 32, dev)
    lib = gram._load(gram.NARROW_SRC)
    g = torch.empty((1, 32), device=dev)
    H = torch.empty((1, 32, 32), device=dev)
    ptrs = [t.data_ptr() for t in (Bf, s, yv, w, active, g, H)]
    stream = torch.cuda.current_stream().cuda_stream
    # several segments need scratch and counters; n outside {6, 32, 64},
    # P no whole number of chunks and too long a segment are refused
    assert lib.sdsm_gram_narrow_grad_hess(*ptrs, None, None, 1, 2048, 32, 16, stream) != 0
    assert lib.sdsm_gram_narrow_grad_hess(*ptrs, None, None, 1, 2048, 16, 64, stream) != 0
    assert lib.sdsm_gram_narrow_grad_hess(*ptrs, None, None, 1, 2040, 32, 64, stream) != 0
    assert lib.sdsm_gram_narrow_grad_hess(*ptrs, None, None, 1, 2048, 32, 2048, stream) != 0
    with pytest.raises(ValueError):
        gram.narrow_kernel(Bf[..., :16].contiguous(), s, yv, w, active)
    with pytest.raises(ValueError):
        gram.narrow_kernel(Bf, s, yv, w, active.long())
