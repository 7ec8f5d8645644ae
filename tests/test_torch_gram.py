"""The port's Newton gram against the JAX package's Pallas kernels.

The same inputs, made from a numpy seed, go through the JAX package's
``pallas_kernels.fused_grad_hess_batched`` (Pallas in interpret mode on the
CPU, one case per TPU kernel route: B1 full dense at n = 128, B2 triangle at
n = 256, B3 banded at n = 512) and through the port's dispatcher
``superdsm_tpu_torch.dsm.gram.fused_grad_hess_batched``, which on CPU
tensors runs its plain PyTorch version. Tolerance: rtol = atol = 1e-4 (the
JAX package sums the float32 products over up to 2048 pixels in float32,
the port in float64).

The reduced-precision bodies (B1′) are held against the JAX kernel bodies
in interpret mode, called directly with their gram dots (the JAX package's
knobs stay untouched), while the port's knob :data:`gram.GRAM_PASSES` or
``cheap=True`` selects the route:

- 3 passes (bf16 hi/lo split): rtol = atol = 1e-4, since the hi/lo parts
  hold each operand to ~2^-16 whatever a one-ulp difference in kappa does;
- 1 pass: a one-ulp difference in kappa between the two sigmoids can flip
  the bf16 rounding of single products, so the error is bounded
  elementwise by bf16's unit roundoff, ``|dH| <= 2^-7 (|Bf|^T diag(kappa)
  |Bf|) + 1e-4``; and, since that bound would also pass a float32 (6-pass)
  result, the port's H must lie within rtol = atol = 1e-4 of the JAX 1-pass
  H on at least 99% of the entries, where the 6-pass result misses on more
  than half of them.

The CUDA kernels themselves are held against the plain version on the card
by ``tests/test_torch_kernel_cuda.py``.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from superdsm_tpu.dsm import pallas_kernels as pk
from superdsm_tpu.dsm.smooth import build_smooth_matrix, subsample_grid
from superdsm_tpu.dsm.solver import _poly_basis

from superdsm_tpu_torch.dsm import batching, gram

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


# ---------------------------------------------------------------------------
# B1′: the reduced-precision gram bodies behind the knobs
# ---------------------------------------------------------------------------

#: 1 pass: least share of entries within rtol = atol = 1e-4 of the JAX
#: 1-pass H (flips of single bf16 roundings are rare), and the share the
#: 6-pass result must stay below.
ONE_PASS_MIN_SHARE = 0.99
SIX_PASS_MAX_SHARE = 0.5


def _aux(s, yv, w):
    return jnp.stack([jnp.asarray(s), jnp.asarray(yv), jnp.asarray(w)], axis=1)


def _port_knob(monkeypatch, passes, Bf, s, yv, w, cheap=False):
    monkeypatch.setattr(gram, 'GRAM_PASSES', passes)
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in (Bf, s, yv, w)]
    g, H = gram.fused_grad_hess_batched(*t, cheap=cheap)
    return g.numpy(), H.numpy()


def _within(H, H_ref):
    return np.abs(H - H_ref) <= ATOL + RTOL * np.abs(H_ref)


def _assert_1pass(H, H_jax, H6, Bf, s, yv, w, significant=0.0):
    """The 1-pass bounds of the module docstring; ``significant`` limits
    the 6-pass share to entries above it (a band problem's H is mostly
    exact zeros, which every precision gets right)."""
    sig = 1.0 / (1.0 + np.exp(yv.astype(np.float64) * s))
    kappa = w * yv.astype(np.float64) ** 2 * sig * (1.0 - sig)
    absBf = np.abs(Bf.astype(np.float64))
    bound = 2.0 ** -7 * np.einsum('bpi,bp,bpj->bij', absBf, kappa, absBf) + 1e-4
    assert np.all(np.abs(H - H_jax) <= bound)
    share = _within(H, H_jax).mean()
    assert share >= ONE_PASS_MIN_SHARE, share
    big = np.abs(H_jax) > significant
    share6 = _within(H6, H_jax)[big].mean()
    assert share6 < SIX_PASS_MAX_SHARE, share6


@pytest.mark.parametrize('n', [128, 256])
def test_cheap_gram_matches_pallas_1pass_full(monkeypatch, n):
    """B1′-1: ``cheap`` takes the full dense 1-pass gram at every n (no
    triangle at n = 256), whatever GRAM_PASSES says."""
    Bf, s, yv, w = _dense_problem(n + 1, 2, 512, n)
    g_ref, H_ref = pk._fused_grad_hess_call(
        jnp.asarray(Bf), _aux(s, yv, w), jnp.ones(2, jnp.int32),
        pk._grad_hess_kernel_1pass)
    g, H = _port_knob(monkeypatch, 6, Bf, s, yv, w, cheap=True)
    _, H6 = _port_knob(monkeypatch, 6, Bf, s, yv, w)
    np.testing.assert_allclose(g, np.asarray(g_ref)[:, 0], rtol=RTOL, atol=ATOL)
    _assert_1pass(H, np.asarray(H_ref), H6, Bf, s, yv, w)
    assert gram.route_for(n, False, 1, full=True) == 'dense-1pass'


def test_3pass_full_matches_pallas(monkeypatch):
    """B1′-3 on the dense route (n = 128)."""
    Bf, s, yv, w = _dense_problem(7, 2, 512, 128)
    g_ref, H_ref = pk._fused_grad_hess_call(
        jnp.asarray(Bf), _aux(s, yv, w), jnp.ones(2, jnp.int32),
        pk._make_grad_hess_kernel(pk._dot_rows_3pass))
    g, H = _port_knob(monkeypatch, 3, Bf, s, yv, w)
    np.testing.assert_allclose(g, np.asarray(g_ref)[:, 0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(H, np.asarray(H_ref), rtol=RTOL, atol=ATOL)
    assert gram.route_for(128, False, 3) == 'dense-3pass'


def test_3pass_triangle_matches_pallas(monkeypatch):
    Bf, s, yv, w = _dense_problem(8, 2, 512, 256)
    g_ref, H_ref = pk._tri_grad_hess_call(
        jnp.asarray(Bf), _aux(s, yv, w), jnp.ones(2, jnp.int32),
        gram_dot=pk._dot_rows_3pass)
    g, H = _port_knob(monkeypatch, 3, Bf, s, yv, w)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(H, np.asarray(H_ref), rtol=RTOL, atol=ATOL)
    assert gram.route_for(256, False, 3) == 'triangle-3pass'


def test_1pass_triangle_matches_pallas(monkeypatch):
    """B1′-1t: the mirrored 128-blocks carry kappa on the other operand,
    so the port mirrors them too (a straight product misses on ~1/4 of the
    entries)."""
    Bf, s, yv, w = _dense_problem(9, 2, 512, 256)
    g_ref, H_ref = pk._tri_grad_hess_call(
        jnp.asarray(Bf), _aux(s, yv, w), jnp.ones(2, jnp.int32),
        gram_dot=pk._gram_dot_1pass)
    g, H = _port_knob(monkeypatch, 1, Bf, s, yv, w)
    _, H6 = _port_knob(monkeypatch, 6, Bf, s, yv, w)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=RTOL, atol=ATOL)
    _assert_1pass(H, np.asarray(H_ref), H6, Bf, s, yv, w)
    _, H_straight = _port_knob(monkeypatch, 1, Bf, s, yv, w, cheap=True)
    assert _within(H_straight, np.asarray(H_ref)).mean() < ONE_PASS_MIN_SHARE


@pytest.mark.parametrize('passes', [3, 1])
def test_reduced_banded_matches_pallas(monkeypatch, passes):
    """B1′ on the banded route (n = 512, a real band-structured G)."""
    Bf, s, yv, w, cb, fits = _band_problem(seed=passes)
    n = Bf.shape[2]
    nband = pk._NBAND_BY_N[n]
    dot = pk._dot_rows_3pass if passes == 3 else pk._gram_dot_1pass
    g_ref, H_ref = pk._banded_grad_hess_call(
        jnp.asarray(Bf), _aux(s, yv, w), cb, jnp.ones(2, jnp.int32), nband,
        pk._make_banded_kernel(dot, nband, n // 128))
    g, H = _port_knob(monkeypatch, passes, Bf, s, yv, w)
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=RTOL, atol=ATOL)
    if passes == 3:
        np.testing.assert_allclose(H, np.asarray(H_ref), rtol=RTOL, atol=ATOL)
    else:
        _, H6 = _port_knob(monkeypatch, 6, Bf, s, yv, w)
        _assert_1pass(H, np.asarray(H_ref), H6, Bf, s, yv, w, significant=1.0)
    assert gram.route_for(n, True, passes) == f'banded-{passes}pass'


@pytest.mark.parametrize('passes', [3, 1])
@pytest.mark.parametrize('n', [6, 64])
def test_plain_rounding_matches_jax_dots(passes, n):
    """The plain path (n = 6, 32, 64) rounds as the TPU's GRAM_PRECISION
    does, held against ``_dot_rows_3pass`` / ``_gram_dot_1pass`` on the same
    float32 operands (JAX treats the precision itself as a no-op on the
    CPU). bf16 products are exact, so only the sums' order differs:
    rtol = atol = 1e-4."""
    Bf, s, yv, w = (torch.from_numpy(a) for a in _dense_problem(n, 2, 700, n))
    g, H = gram.grad_hess_plain(Bf, s, yv, w, passes=passes)
    g6, _ = gram.grad_hess_plain(Bf, s, yv, w)
    _, kappa = gram._logistic_weights(s, yv, w)
    a = (Bf * kappa[..., None]).numpy()
    dot = pk._dot_rows_3pass if passes == 3 else pk._gram_dot_1pass
    H_ref = np.stack([np.asarray(dot(jnp.asarray(a[b]), jnp.asarray(Bf.numpy()[b])))
                      for b in range(2)])
    np.testing.assert_allclose(H.numpy(), H_ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(g, g6)  # g keeps full precision


def test_knobs_read_from_environment():
    code = ('from superdsm_tpu_torch.dsm import gram\n'
            'print(gram.GRAM_PASSES, gram.HYBRID_ITERS, sorted(gram.LAUNCHES))\n')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(**env):
        return subprocess.run([sys.executable, '-c', code], cwd=repo,
                              env={**os.environ, **env}, capture_output=True,
                              text=True, timeout=120)

    proc = run(SDSM_GRAM_PASSES='3', SDSM_GRAM_HYBRID_ITERS='16')
    assert proc.returncode == 0, proc.stderr
    passes, hybrid, routes = proc.stdout.split(' ', 2)
    assert (passes, hybrid) == ('3', '16')
    assert routes.strip() == str(sorted(
        f'{r}{p}' for r in ('dense', 'triangle', 'banded')
        for p in ('', '-3pass', '-1pass')))
    proc = run(SDSM_GRAM_PASSES='2')
    assert proc.returncode != 0 and 'SDSM_GRAM_PASSES' in proc.stderr


# The float32 kernel's split of the pixel loop across blocks (split-P). The
# plan is Python in gram.py; the kernel takes it as it is.

#: (B, P, n, splits): launches of many lanes (which split as one lane does),
#: the table shapes and few-lane launches the main path makes (B = 1
#: re-solves, small tail chunks), an odd chunk count (1056 = 33 x 32 rows: a
#: short last segment), and a pixel loop too short to split.
SPLIT_SHAPES = [(64, 8192, 512, True), (8, 2048, 2048, True),
                (64, 8192, 128, True), (16, 32768, 512, True),
                (1, 8192, 128, True), (1, 32768, 512, True),
                (3, 1056, 128, True), (1, 2048, 1024, True),
                (4, 128, 128, False)]


@pytest.mark.parametrize('B,P,n,splits', SPLIT_SHAPES)
def test_split_plan_covers_every_chunk_once_in_pixel_order(B, P, n, splits):
    """The plan as the kernel reads it: segment ``seg`` (``blockIdx.y``)
    walks chunks ``[seg * seg_chunks, min(seg * seg_chunks + seg_chunks,
    nchunks))`` in order, and ``nsegs = ceil(nchunks / seg_chunks)``. The
    segments tile the chunks with none empty. The kernel's own mapping is
    held on the card (``tests/test_torch_kernel_cuda.py``)."""
    seg_chunks, nsegs = gram.split_plan(B, P, n)
    nchunks = P // gram.ROWS
    assert (nsegs > 1) == splits
    assert nsegs == -(-nchunks // seg_chunks)
    # planned as for one lane: a lane's sums split alike in every batch
    assert all(gram.split_plan(b, P, n) == (seg_chunks, nsegs) for b in (1, 2, 5, 64))
    if splits:
        # one lane's items split until they fill the card, in at most
        # MAX_SEGMENTS segments; segments start on a float32 partial's
        # first chunk
        assert gram.tile_pairs(n) < gram.TARGET_ITEMS
        assert nsegs <= gram.MAX_SEGMENTS
        assert seg_chunks % gram.FLUSH_CHUNKS == 0
        assert seg_chunks >= gram.MIN_SEG_CHUNKS
        # the bound of the scratch (SCRATCH_CAP_BYTES): lanes launch in
        # groups, the largest that fit
        group = gram.lanes_per_launch(B, P, n)
        assert 1 <= group <= B
        assert group == 1 or gram.scratch_entries(group, P, n) * 8 <= gram.SCRATCH_CAP_BYTES
        assert group == B or gram.scratch_entries(group + 1, P, n) * 8 > gram.SCRATCH_CAP_BYTES
    else:
        assert seg_chunks == nchunks
        assert gram.lanes_per_launch(B, P, n) == B
    chunks = [c for seg in range(nsegs)
              for c in range(seg * seg_chunks, min(seg * seg_chunks + seg_chunks,
                                                   nchunks))]
    assert chunks == list(range(nchunks))
    assert (nsegs - 1) * seg_chunks < nchunks
    assert gram.scratch_entries(B, P, n) == \
        nsegs * B * (gram.tile_pairs(n) * gram.TILE ** 2 + n)


@pytest.mark.parametrize('flush', [2, 3, 4])
def test_split_segments_are_whole_flush_groups(monkeypatch, flush):
    """A split segment is a multiple of FLUSH_CHUNKS chunks at any flush
    length, so the float32 partials do not depend on the split."""
    monkeypatch.setattr(gram, 'FLUSH_CHUNKS', flush)
    for B, P, n in [(1, 8192, 128), (1, 32768, 512), (3, 1056, 128),
                    (16, 8192, 256), (1, 2048, 1024)]:
        seg_chunks, nsegs = gram.split_plan(B, P, n)
        assert nsegs > 1 and seg_chunks % flush == 0, (B, P, n, seg_chunks)


def _segmented_grad_hess(Bf, s, yv, w, active):
    """Plain-torch emulation of the float32 kernel's sums: float32 products
    summed in float32 over each partial of FLUSH_CHUNKS chunks, the
    partials in float64 per pixel segment, the segments in order."""
    B, P, n = Bf.shape
    term1, kappa = gram._logistic_weights(s, yv, w)
    seg_chunks, nsegs = gram.split_plan(B, P, n)
    rows = gram.ROWS * gram.FLUSH_CHUNKS
    g = torch.zeros((B, n), dtype=torch.float64)
    H = torch.zeros((B, n, n), dtype=torch.float64)
    for seg in range(nsegs):
        lo, hi = seg * seg_chunks * gram.ROWS, min(P, (seg + 1) * seg_chunks * gram.ROWS)
        g_seg, H_seg = torch.zeros_like(g), torch.zeros_like(H)
        for p0 in range(lo, hi, rows):
            A = Bf[:, p0:min(p0 + rows, hi)]
            k, t = kappa[:, p0:p0 + A.shape[1]], term1[:, p0:p0 + A.shape[1]]
            H_seg += ((A * k[..., None]).transpose(1, 2) @ A).double()
            g_seg += (A.transpose(1, 2) @ t[..., None])[..., 0].double()
        g, H = g + g_seg, H + H_seg
    keep = (active != 0).double()
    return (g * keep[:, None]).float(), (H * keep[:, None, None]).float()


@pytest.mark.parametrize('B,P,n', [(1, 8192, 128), (3, 1056, 128), (2, 4096, 256)])
def test_segmented_sums_agree_with_plain(B, P, n):
    """The split changes only the grouping of the float64 sums: the
    emulation agrees with the plain version to 1e-6 relative (max norm)."""
    assert gram.split_plan(B, P, n)[1] > 1
    Bf, s, yv, w = (torch.from_numpy(a) for a in _dense_problem(B + n, B, P, n))
    active = torch.ones(B, dtype=torch.int32)
    active[-1] = 0 if B > 1 else 1
    g, H = _segmented_grad_hess(Bf, s, yv, w, active)
    g_ref, H_ref = gram.grad_hess_plain(Bf, s, yv, w, active)
    assert float((H - H_ref).abs().max()) <= 1e-6 * float(H_ref.abs().max())
    assert float((g - g_ref).abs().max()) <= 1e-6 * float(g_ref.abs().max())
    assert not H[active == 0].any() and H_ref.abs().max() > 0


def test_split_scratch_stays_under_its_cap():
    """Every (P, K) bucket the kernels serve, at every batch size up to its
    GPU cap: a split launch (a float32 gram's group of lanes) needs at most
    SCRATCH_CAP_BYTES of float64 scratch, a float32 launch of one segment
    at most 1.5 times the bytes of its float32 H (none at these buckets:
    every float32 gram splits, as one lane does), and a bf16 launch of one
    segment none (in full mode its partials would take twice the bytes of
    H: the kernel writes H itself). The bf16 kernel is planned in full mode
    and, at n >= 256, in triangle mode."""
    worst = {}
    worst_ratio = (0, None)
    for P in batching.P_BUCKETS:
        for K in batching.K_BUCKETS[1:]:
            n = 6 + K
            if n % 128:
                continue
            plans = [(6, False), (1, True)] + ([(1, False)] if n >= 256 else [])
            for B in range(1, batching.B_CAP_GPU[P] + 1):
                for passes, full in plans:
                    group = gram.lanes_per_launch(B, P, n, passes, full)
                    nbytes = gram.scratch_entries(group, P, n, passes, full) * 8
                    if gram.split_plan(B, P, n, passes, full)[1] > 1:
                        worst[passes] = max(worst.get(passes, (0, None)),
                                            (nbytes, (B, P, n, full)))
                    elif passes == 6:
                        worst_ratio = max(worst_ratio,
                                          (nbytes / (B * n * n * 4), (B, P, n)))
                    else:
                        assert nbytes == 0, (B, P, n, full)
    for passes in (6, 1):
        assert 0 < worst[passes][0] <= gram.SCRATCH_CAP_BYTES, worst
    assert gram.SCRATCH_CAP_BYTES <= 2 ** 28
    assert worst_ratio[0] <= 1.5, worst_ratio
    # the one-segment traffic the bf16 kernel's direct write avoids
    assert gram.tile_pairs(2048, 1, True) * gram.TILE ** 2 * 8 == 2 * 2048 ** 2 * 4


#: (B, P, n, full, splits) of the bf16 kernel's plan: the phase-3 table
#: shapes (full at n = 128, triangle and banded above), the few-lane launches
#: of the hybrid schedule's 1-pass full gram (B = 1 re-solves), launches of
#: many lanes at n = 1024 and 2048, which split as one lane does, and plans
#: of one segment: a lane whose tile pairs reach the target (triangle mode
#: at n = 4096) and a pixel loop too short to split.
BF16_SPLIT_SHAPES = [(64, 8192, 128, True, True), (32, 12288, 256, False, True),
                     (16, 32768, 512, False, True), (1, 8192, 128, True, True),
                     (1, 32768, 512, True, True), (32, 12288, 256, True, True),
                     (8, 16384, 1024, True, True), (64, 2048, 2048, True, True),
                     (8, 131072, 2048, False, True), (1, 2048, 4096, False, False),
                     (8, 128, 1024, True, False)]


@pytest.mark.parametrize('B,P,n,full,splits', BF16_SPLIT_SHAPES)
def test_bf16_split_plan_counts_its_own_tile_pairs(B, P, n, full, splits):
    """The bf16 kernel's plan counts its own work items (every tile pair in
    full mode, four per upper-triangle 128-block pair otherwise), as for one
    lane; its segments tile the chunks in order, start on a flush group and
    are at most MAX_SEGMENTS, and its lanes launch in groups whose scratch
    fits the cap, as the float32 kernel's do."""
    nt, nb = n // gram.TILE, n // gram.MIRROR_BLOCK
    pairs = gram.tile_pairs(n, 1, full)
    assert pairs == (nt * nt if full else 4 * nb * (nb + 1) // 2)
    assert gram.tile_pairs(n, 3, full) == pairs
    seg_chunks, nsegs = gram.split_plan(B, P, n, 1, full)
    assert gram.split_plan(B, P, n, 3, full) == (seg_chunks, nsegs)
    nchunks = P // gram.ROWS
    assert (nsegs > 1) == splits
    assert (pairs < gram.TARGET_ITEMS and nchunks > gram.MIN_SEG_CHUNKS) == splits
    assert nsegs == -(-nchunks // seg_chunks)
    chunks = [c for seg in range(nsegs)
              for c in range(seg * seg_chunks, min((seg + 1) * seg_chunks, nchunks))]
    assert chunks == list(range(nchunks))
    group = gram.lanes_per_launch(B, P, n, 1, full)
    if splits:
        assert seg_chunks % gram.FLUSH_CHUNKS == 0
        assert seg_chunks >= gram.MIN_SEG_CHUNKS
        assert nsegs <= gram.MAX_SEGMENTS
        assert gram.scratch_entries(B, P, n, 1, full) == \
            nsegs * B * (pairs * gram.TILE ** 2 + n)
        assert 1 <= group <= B
        assert group == 1 or \
            gram.scratch_entries(group, P, n, 1, full) * 8 <= gram.SCRATCH_CAP_BYTES
        assert group == B or \
            gram.scratch_entries(group + 1, P, n, 1, full) * 8 > gram.SCRATCH_CAP_BYTES
    else:
        assert gram.scratch_entries(B, P, n, 1, full) == 0
        assert group == B


@pytest.mark.parametrize('B,P,n,splits', SPLIT_SHAPES)
@pytest.mark.parametrize('passes,full', [(6, False), (3, False), (3, True), (1, False),
                                         (1, True)])
def test_split_plan_does_not_read_the_batch(B, P, n, splits, passes, full):
    """Every kernel's plan, the float32 one's and the bf16 one's in both
    modes, is the same for a batch of 1, 2, 16 and 64 lanes: a lane's pixel
    segments, and so the order of its float64 sums, do not depend on its
    batch."""
    plans = {gram.split_plan(b, P, n, passes, full) for b in (1, 2, 16, 64)}
    assert len(plans) == 1, plans
