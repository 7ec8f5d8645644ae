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
        [f'{r}{p}' for r in ('dense', 'triangle', 'banded')
         for p in ('', '-3pass', '-1pass')] + ['narrow']))
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


# ---------------------------------------------------------------------------
# The narrow kernel (n = 6, 32, 64): its plan and the order of its float64
# sums. The kernel runs only on the card (tests/test_torch_kernel_cuda.py
# holds it to the plain version, tests its skip of zero-weight chunks on
# NaN and its lanes bitwise alone and in batches); here a plain-torch model
# of its segments, chunks, warps and lanes. The cases on the model check
# the plan and the model only: nothing here runs the kernel, and the model
# departs from it where the docstring of _narrow_emulation says.
# ---------------------------------------------------------------------------

#: (B, P, n): one lane at the largest shared poly bucket and at the smallest
#: DSM bucket, the canonical re-solves' pairs, and a bucket's full batch.
NARROW_CASES = [(1, 32768, 6), (2, 6144, 6), (64, 2048, 6),
                (1, 2048, 32), (2, 8192, 32), (64, 2048, 32),
                (1, 32768, 64), (2, 6144, 64), (64, 2048, 64)]


def _narrow_problem(seed, B, P, n):
    """B lanes of a narrow gram: random features, weights 1 on the first
    10% to 95% of the pixels and 0 on the padded tail (where the solver's
    intensities are 0 too), the last lane frozen from B = 2."""
    rng = np.random.RandomState(seed)
    Bf = (rng.rand(B, P, n) - 0.5).astype(np.float32)
    s = (rng.randn(B, P) * 2.0).astype(np.float32)
    yv = (np.sign(rng.randn(B, P)) * rng.uniform(0.05, 1.0, (B, P))).astype(np.float32)
    w = np.zeros((B, P), np.float32)
    for b in range(B):
        w[b, :int(P * rng.uniform(0.1, 0.95))] = 1.0
    yv *= w
    active = np.ones(B, np.int32)
    active[-1] = 0 if B > 1 else 1
    return tuple(torch.from_numpy(a) for a in (Bf, s, yv, w, active))


def _shuffle_tree(x, lanes):
    """``v += __shfl_down_sync(v, off)`` for off = lanes / 2, ..., 1 along
    axis 2 of ``x``: lane 0's sum."""
    while lanes > 1:
        lanes //= 2
        x = x[:, :, :lanes] + x[:, :, lanes:2 * lanes]
    return x[:, :, 0]


def _narrow_emulation(Bf, s, yv, w, active, skip=True):
    """The narrow kernel's float64 sums in its order: per lane and pixel
    segment (``gram.narrow_plan``), the chunks in pixel order, skipping
    (``skip``) a lane's chunks whose weights are all 0. At n = 6 a thread
    per row of a chunk, a warp's 32 threads in the kernel's shuffle tree;
    at n = 32, 64 warp w takes the 4-row k-steps w and w + 8 of a chunk,
    in that order, each k-step's 4 products summed in pixel order (the
    tensor core's own order inside a k-step is not emulated), g by rows of
    the k-steps, then (r0 + r2) + (r1 + r3). Then the 8 warps in order and
    the segments in order. H's upper triangle mirrored. Each product is
    rounded on its own (the kernel's fused multiply-adds round product and
    sum once)."""
    B, P, n = Bf.shape
    rows = gram.NARROW_ROWS[n]
    pad = -P % rows
    if pad:
        Bf = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
        s, yv, w = (torch.nn.functional.pad(t, (0, pad)) for t in (s, yv, w))
        P += pad
    seg_chunks, nsegs = gram.narrow_plan(P, n)
    term1, kappa = gram._logistic_weights(s, yv, w)
    Bd = Bf.double()
    A = Bd * kappa.double()[..., None]
    T = term1.double()
    nchunks = P // rows
    live = (w.view(B, nchunks, rows) != 0).any(dim=2) if skip else \
        torch.ones((B, nchunks), dtype=torch.bool)
    H = torch.zeros((B, n, n), dtype=torch.float64)
    g = torch.zeros((B, n), dtype=torch.float64)
    for seg in range(nsegs):
        chunks = range(seg * seg_chunks, min((seg + 1) * seg_chunks, nchunks))
        if n == 6:
            accH, accg = torch.zeros((B, rows, n, n), dtype=torch.float64), \
                torch.zeros((B, rows, n), dtype=torch.float64)
        else:
            accH, accg = torch.zeros((B, 8, n, n), dtype=torch.float64), \
                torch.zeros((B, 8, 4, n), dtype=torch.float64)
        for c in chunks:
            a, b, t = (x[:, c * rows:(c + 1) * rows] for x in (A, Bd, T))
            on = live[:, c]
            if n == 6:
                steps = [(a[..., :, None] * b[..., None, :], b * t[..., None])]
            else:
                a, b, t = (x.reshape(B, rows // 32, 8, 4, *x.shape[2:]) for x in (a, b, t))
                steps = []
                for ks in range(rows // 32):
                    ak, bk, tk = a[:, ks], b[:, ks], t[:, ks]
                    dH = ak[:, :, 0, :, None] * bk[:, :, 0, None, :]
                    for k in range(1, 4):
                        dH = dH + ak[:, :, k, :, None] * bk[:, :, k, None, :]
                    steps.append((dH, bk * tk[..., None]))
            for dH, dg in steps:
                accH = torch.where(on.view(B, *[1] * (accH.dim() - 1)), accH + dH, accH)
                accg = torch.where(on.view(B, *[1] * (accg.dim() - 1)), accg + dg, accg)
        if n == 6:
            wH = _shuffle_tree(accH.view(B, 8, 32, n, n), 32)
            wg = _shuffle_tree(accg.view(B, 8, 32, n), 32)
        else:
            wH = accH
            wg = (accg[:, :, 0] + accg[:, :, 2]) + (accg[:, :, 1] + accg[:, :, 3])
        segH, segg = torch.zeros_like(H), torch.zeros_like(g)
        for wp in range(8):
            segH, segg = segH + wH[:, wp], segg + wg[:, wp]
        H, g = H + segH, g + segg
    H = torch.triu(H) + torch.triu(H, 1).transpose(1, 2)
    keep = (active != 0).double()
    return (g * keep[:, None]).float(), (H * keep[:, None, None]).float()


_NARROW_RUNS = {}


def _narrow_run(B, P, n):
    """The problem of a case, the emulation and the plain version (once a
    case per process)."""
    key = (B, P, n)
    if key not in _NARROW_RUNS:
        Bf, s, yv, w, active = _narrow_problem(B * P + n, B, P, n)
        _NARROW_RUNS[key] = ((Bf, s, yv, w, active), _narrow_emulation(Bf, s, yv, w, active),
                             gram.grad_hess_plain(Bf, s, yv, w, active))
    return _NARROW_RUNS[key]


def _ulps(x, ref):
    """Per lane: the largest ``|x - ref|`` in float32 ulps of the lane's
    largest ``|ref|``."""
    top = ref.abs().flatten(1).amax(dim=1).double().clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 23)
    return (x - ref).abs().flatten(1).amax(dim=1).double() / ulp


@pytest.mark.parametrize('B,P,n', NARROW_CASES)
def test_narrow_emulation_agrees_with_plain(B, P, n):
    """The model's order of float64 sums changes g and H by at most 2
    float32 ulps of each lane's largest entry against the plain version
    (the limit the card holds the kernel to; the model, not the kernel)."""
    (_, _, _, _, active), (g, H), (g_ref, H_ref) = _narrow_run(B, P, n)
    on = active != 0
    assert float(_ulps(H[on], H_ref[on]).max()) <= 2.0
    assert float(_ulps(g[on], g_ref[on]).max()) <= 2.0
    assert H_ref[on].abs().max() > 0 and torch.equal(H, H.transpose(1, 2))


@pytest.mark.parametrize('B,P,n', [c for c in NARROW_CASES if c[0] > 1])
def test_narrow_frozen_lanes_give_zeros(B, P, n):
    """A frozen lane's g and H are exact zeros in the model, as in the plain
    version."""
    (_, _, _, _, active), (g, H), (g_ref, H_ref) = _narrow_run(B, P, n)
    off = active == 0
    assert off.any()
    assert not g[off].any() and not H[off].any()
    assert not g_ref[off].any() and not H_ref[off].any()


@pytest.mark.parametrize('n', gram.NARROW_N)
def test_narrow_skipping_zero_weight_chunks_keeps_the_bits(n):
    """Chunks whose weights are all 0 add exact zeros to sums that start at
    +0: in the model, skipping them, as the kernel does, gives the same bits
    as summing them (the kernel's skip itself is tested on the card)."""
    Bf, s, yv, w, active = _narrow_problem(n, 3, 6144, n)
    rows = gram.NARROW_ROWS[n]
    dead = ~(w.view(3, -1, rows) != 0).any(dim=2)
    assert dead.any() and not dead.all()
    skipped = _narrow_emulation(Bf, s, yv, w, active)
    summed = _narrow_emulation(Bf, s, yv, w, active, skip=False)
    assert all(torch.equal(x, y) for x, y in zip(skipped, summed))


@pytest.mark.parametrize('n', gram.NARROW_N)
def test_narrow_lane_sums_do_not_depend_on_the_batch(n):
    """Each lane of a batch of 3, emulated alone and in batches of 2 with
    another lane, gets the same bits: the model's order of sums reads
    nothing of the lanes beside it (the kernel's lanes are held alone and in
    batches on the card)."""
    Bf, s, yv, w, _ = _narrow_problem(n + 1, 3, 2048 if n == 6 else 6144, n)
    active = torch.ones(3, dtype=torch.int32)
    g, H = _narrow_emulation(Bf, s, yv, w, active)
    for b in range(3):
        for others in ([], [(b + 1) % 3]):
            idx = [b] + others
            g1, H1 = _narrow_emulation(*(x[idx] for x in (Bf, s, yv, w)), active[idx])
            assert torch.equal(g1[0], g[b]) and torch.equal(H1[0], H[b])


@pytest.mark.parametrize('n', gram.NARROW_N)
@pytest.mark.parametrize('P', sorted(set(batching.P_BUCKETS) | {2080, 6000}))
def test_narrow_plan_reads_only_p_and_n(P, n):
    """The narrow plan takes (P, n) alone (no batch, no active lanes: a
    lane's segments are the same in every batch); its segments tile P
    (padded up to whole chunks) in pixel order, none empty, at most
    NARROW_MAX_SEGMENTS of at most NARROW_MAX_SEG_CHUNKS chunks, none
    shorter than NARROW_SEG_PIXELS unless there is one."""
    import inspect
    assert list(inspect.signature(gram.narrow_plan).parameters) == ['P', 'n']
    seg_chunks, nsegs = gram.narrow_plan(P, n)
    rows = gram.NARROW_ROWS[n]
    nchunks = -(-P // rows)
    assert nsegs == -(-nchunks // seg_chunks) and (nsegs - 1) * seg_chunks < nchunks
    assert nsegs <= gram.NARROW_MAX_SEGMENTS
    assert seg_chunks <= gram.NARROW_MAX_SEG_CHUNKS
    assert nsegs == 1 or seg_chunks * rows >= gram.NARROW_SEG_PIXELS[n]
    chunks = [c for seg in range(nsegs)
              for c in range(seg * seg_chunks, min((seg + 1) * seg_chunks, nchunks))]
    assert chunks == list(range(nchunks))


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the dispatcher's route
    of a CUDA tensor, with the kernels replaced by spies."""

    @property
    def device(self):
        return torch.device('cuda', 0)

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize('n', gram.NARROW_N)
def test_dispatcher_routes_narrow_sizes(monkeypatch, n):
    """At n = 6, 32, 64 a CUDA tensor takes the narrow kernel at 6 passes
    and the plain version, unmirrored, under the reduced-precision knobs
    and ``cheap`` (the JAX package's XLA path there), and a CPU tensor the
    plain version; n = 128 on the card keeps the tiled kernel."""
    calls = []
    plain = gram.grad_hess_plain
    monkeypatch.setattr(gram, 'narrow_kernel', lambda *a: calls.append(('narrow', a[0].shape)))
    monkeypatch.setattr(gram, 'grad_hess_kernel',
                        lambda *a, **k: calls.append(('tiled', a[0].shape)))
    Bf, s, yv, w, active = _narrow_problem(n, 2, 2048, n)
    g, H = gram.fused_grad_hess_batched(Bf, s, yv, w, active)
    assert calls == []
    g_ref, H_ref = plain(Bf, s, yv, w, active)
    assert torch.equal(g, g_ref) and torch.equal(H, H_ref)
    card = [x.as_subclass(_OnCard) for x in (Bf, s, yv, w)]
    gram.fused_grad_hess_batched(*card, active)
    assert calls == [('narrow', (2, 2048, n))]
    monkeypatch.setattr(gram, 'grad_hess_plain', lambda *a, **k: calls.append(
        ('plain', a[0].shape, k['passes'], k['mirror'])))
    for passes, cheap in ((3, False), (1, False), (6, True)):
        monkeypatch.setattr(gram, 'GRAM_PASSES', passes)
        gram.fused_grad_hess_batched(*card, active, cheap=cheap)
        assert calls[-1] == ('plain', (2, 2048, n), 1 if cheap else passes, False)
    monkeypatch.setattr(gram, 'GRAM_PASSES', 6)
    del calls[1:]
    Bf128, s128, yv128, w128 = (torch.from_numpy(a) for a in _dense_problem(0, 2, 2048, 128))
    gram.fused_grad_hess_batched(*(x.as_subclass(_OnCard) for x in (Bf128, s128, yv128, w128)),
                                 active)
    assert calls[1:] == [('tiled', (2, 2048, 128))]


def test_narrow_kernel_refuses_cpu_tensors():
    Bf, s, yv, w, active = _narrow_problem(0, 1, 2048, 6)
    with pytest.raises(ValueError):
        gram.narrow_kernel(Bf, s, yv, w, active)


def test_cpu_solver_keeps_the_plain_gram_at_narrow_sizes(monkeypatch):
    """On the CPU the Newton loop at n = 6 asks the dispatcher, which takes
    the plain version at 6 passes; the narrow kernel is never called."""
    from superdsm_tpu_torch.dsm import solver

    def refuse(*args, **kwargs):
        raise AssertionError('the narrow kernel was called for a CPU gram')
    plain, calls = gram.grad_hess_plain, []

    def counted(Bf, *args, **kwargs):
        calls.append((tuple(Bf.shape), kwargs['passes']))
        return plain(Bf, *args, **kwargs)
    monkeypatch.setattr(gram, 'narrow_kernel', refuse)
    monkeypatch.setattr(gram, 'grad_hess_plain', counted)
    Bf, s, yv, w, _ = _narrow_problem(5, 2, 2048, 6)
    B = 2
    out = solver._solve_batch_impl(torch.zeros((B, 6)), Bf, None, yv, w, torch.zeros(B), 1.0,
                                   torch.zeros((B, 0)), 3, 1e-5)
    assert torch.isfinite(out[1]).all()
    assert calls and set(calls) == {((B, 2048, 6), 6)}


@pytest.mark.parametrize('n,P,served', [(6, 2080, True), (32, 6000, True), (64, 2048, True),
                                        (128, 2048, True), (1024, 6144, True),
                                        (128, 2080, False), (26, 2048, False)])
def test_serves_names_the_dispatched_shapes(n, P, served):
    """The Newton loops send the dispatcher every shape of n in NARROW_N
    (the narrow kernel pads P) and n % 128 == 0 at P % 256 == 0, and keep
    the plain version for any other."""
    assert gram.serves(n, P) is served
