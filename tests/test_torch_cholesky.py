"""The Cholesky direction of the Newton step on the CPU.

On the card ``solver._cholesky_direction`` is one launch of the
``lane_cholesky`` kernel (``superdsm_tpu_torch/csrc/lane_ops.cu``), held
bitwise to ``lane.cholesky_chain``, its order written op by op, by
``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py`` phase 3. On the
CPU the solver keeps LAPACK, and the chain is the kernel's arithmetic under
test. Here:

- the chain against the JAX package's vmapped ``cho_factor`` /
  ``cho_solve`` (JAX on the CPU, the same numpy inputs) at n = 6 to 384
  and 808 (the kernel's one-block route at n = 6 and 32, its cluster
  routes above):
  damped SPD systems built as ``tests/test_torch_pcg.py``
  builds them, rtol 1e-4, atol 1e-5, as
  ``tests/test_torch_solver.py::test_cg_matches_cholesky_and_jax_lane_freeze``
  (float32 in another order: the chain's right-looking one, LAPACK's
  blocked one);
- failing lanes (not positive definite, zero) are NaN in every entry,
  where ``cholesky_ex`` reports ``info != 0``, and leave the lanes beside
  them unchanged; a lane holding a NaN gives ``_newton_step`` the same
  guarded gradient step through the chain as through LAPACK;
- ``_cholesky_direction`` on the CPU is bitwise a copy of its former body
  (kept in this file), so every CPU result of the solver stays as it was;
- a lane alone gives its bits in a batch, and the upper triangle is never
  read;
- ``lane.cholesky_kernel`` refuses CPU tensors: no fallback;
- the cluster route's schedule (panels of columns dealt cyclically over
  blocks, the trailing update panel by panel, the back substitution panel
  by panel), written in plain torch here, gives the chain's bits, failing
  lanes NaN in every entry; so do the cluster routes as the kernel runs
  them (8 or 16 blocks, panels in shared memory or in the global scratch,
  the rows below a diagonal block in passes, the back substitution in
  groups of 32 columns released 8 at a time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdsm_tpu_torch.dsm import gram, lane, solver

RTOL, ATOL = 1e-4, 1e-5
#: Per-lane damping of the test systems ``M M^T / n + d I``.
DAMPING = (0.2, 1.0, 5.0, 50.0)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _systems(n, damping=DAMPING, seed=0):
    """SPD systems ``M M^T / n + d I`` (one lane per damping d) and right-hand
    sides, float32 numpy."""
    rng = np.random.RandomState(seed + n)
    M = rng.randn(len(damping), n, n).astype(np.float32)
    H = (M @ M.transpose(0, 2, 1) / np.float32(n)
         + np.eye(n, dtype=np.float32) * np.float32(damping)[:, None, None])
    return H.astype(np.float32), rng.randn(len(damping), n).astype(np.float32)


def _former_direction(Hd, g):
    """``solver._cholesky_direction`` before the ``lane_cholesky`` kernel, as
    it was."""
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = -torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info != 0)[:, None],
                       torch.full((), float('nan'), dtype=g.dtype, device=g.device),
                       delta)


def _jax_direction(H, b):
    def one(Hd, g):
        factor = jax.scipy.linalg.cho_factor(Hd)
        return -jax.scipy.linalg.cho_solve(factor, g)
    return np.asarray(jax.vmap(one)(jnp.asarray(H), jnp.asarray(b)))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(a, b):
    """Bitwise equal, a NaN equal to any NaN."""
    return bool(((_bits(a) == _bits(b)) | (torch.isnan(a) & torch.isnan(b))).all())


def _with_failing_lanes(n):
    """Four healthy lanes, then a lane that is not positive definite (its
    factorization fails at a later pivot) and a zero lane."""
    H, b = _systems(n)
    bad = H[1] - 2.0 * np.eye(n, dtype=np.float32)
    H = np.concatenate([H, bad[None], np.zeros((1, n, n), np.float32)])
    b = np.concatenate([b, b[:2]])
    return torch.from_numpy(H), torch.from_numpy(b)


@pytest.mark.parametrize('n', [6, 32, 64, 128, 256, 384, 808])
def test_chain_matches_the_jax_package(n):
    """The chain's direction against the JAX package's ``cho_factor`` /
    ``cho_solve`` on the same systems, rtol 1e-4, atol 1e-5; n = 6 and 32
    are the kernel's one-block route on the card, n = 64 to 384 its cluster
    route of 8 blocks, n = 808 (two lanes) the first n of its cluster
    routes of 16."""
    H, b = _systems(n, damping=DAMPING if n <= 384 else DAMPING[:2])
    out = lane.cholesky_chain(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, _jax_direction(H, b), rtol=RTOL, atol=ATOL)
    assert (n > lane.CHOL_ONE_BLOCK_MAX_N) == (n >= 64)
    assert (n > lane.CHOL_CLUSTER_MAX_N) == (n == 808)
    assert n <= lane.CHOL_WIDE_MAX_N


@pytest.mark.parametrize('n', [6, 64, 256])
def test_failing_lanes_are_nan_and_leave_the_others(n):
    """A lane that is not positive definite and a zero lane are NaN in every
    entry, where ``cholesky_ex`` reports ``info != 0``; the healthy lanes
    beside them keep their bits."""
    H, b = _with_failing_lanes(n)
    out = lane.cholesky_chain(H, b)
    _, info = torch.linalg.cholesky_ex(H)
    failed = info != 0
    assert failed.tolist() == [False] * 4 + [True, True]
    assert bool(torch.isnan(out[failed]).all())
    assert bool(torch.isfinite(out[~failed]).all())
    assert torch.equal(_bits(out[:4]), _bits(lane.cholesky_chain(H[:4], b[:4])))
    # the non-definite lane fails at a later pivot, not at the first
    assert float(H[4, 0, 0]) > 0


def _newton_inputs(B=3, P=512, K=26, seed=1):
    """One ``_newton_step``'s arguments at n = 6 + K: random features and
    parameters, g and H of the plain gram."""
    rng = np.random.RandomState(seed)
    n = 6 + K
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    Bf = t(rng.randn(B, P, n) * 0.3)
    params = t(rng.randn(B, n) * 0.1)
    yv = t(np.sign(rng.randn(B, P)))
    w = t(rng.rand(B, P) < 0.9)
    kmask = torch.ones((B, K))
    alpha = torch.full((B,), 0.5)
    s = lane.matvec(Bf, params)
    f0 = solver._energy_from_surface(s, params[:, 6:], yv, w, alpha, 1.0, kmask)
    g, H = gram.grad_hess_plain(Bf, s, yv, w)
    mu = torch.full((B,), 1e-3)
    return [params, mu, s, f0, g, H, Bf, yv, w, alpha, 1.0, kmask, solver.DEFAULT_TOL]


def test_nan_lane_takes_the_same_guarded_step(monkeypatch):
    """A lane whose Hessian holds a NaN (LAPACK may report ``info`` 0 with a
    partly NaN result there): ``_newton_step`` takes the same guarded
    gradient step with the chain's all-NaN direction as with LAPACK's."""
    args = _newton_inputs()
    args[5] = args[5].clone()
    args[5][1, 9, 4] = float('nan')
    assert not bool(torch.isfinite(_former_direction(args[5][1:2], args[4][1:2])).all())
    former = solver._newton_step(*args)
    monkeypatch.setattr(lane, 'cholesky_lapack', lane.cholesky_chain)
    chained = solver._newton_step(*args)
    for a, b in zip(former, chained):
        assert _same_bits(a[1], b[1]) if a.is_floating_point() else \
            torch.equal(a[1], b[1])
    assert bool(torch.isnan(lane.cholesky_chain(args[5][1:2], args[4][1:2])).all())


@pytest.mark.parametrize('case', ['n = 6', 'n = 64, B = 1', 'n = 256 with failing lanes',
                                  'n = 384'])
def test_cholesky_direction_on_the_cpu_is_the_former_body(case):
    """On the CPU ``_cholesky_direction`` computes bitwise what its former
    body computed (LAPACK on the whole batch), NaN lanes included, and
    launches no kernel."""
    n = int(case.split('n = ')[1].split(',')[0].split(' ')[0])
    if 'failing' in case:
        H, b = _with_failing_lanes(n)
    else:
        H, b = (torch.from_numpy(a) for a in _systems(n))
    if 'B = 1' in case:
        H, b = H[2:3], b[2:3]
    lane.reset_launch_counts()
    out = solver._cholesky_direction(H, b)
    assert _same_bits(out, _former_direction(H, b))
    assert lane.LAUNCHES['lane_cholesky'] == 0


@pytest.mark.parametrize('n', [6, 128])
def test_chain_lane_alone_equals_lane_in_batch(n):
    """A lane alone gives the chain its bits in the batch."""
    H, b = _with_failing_lanes(n)
    out = lane.cholesky_chain(H, b)
    for k in range(H.shape[0]):
        assert _same_bits(lane.cholesky_chain(H[k:k + 1], b[k:k + 1])[0], out[k])


def test_chain_reads_the_lower_triangle_only():
    """The upper triangle is never read, as ``cholesky_ex`` (lower) reads
    only the lower one: garbage there changes no bit."""
    H, b = (torch.from_numpy(a) for a in _systems(64))
    junk = torch.triu(torch.randn(H.shape, generator=torch.Generator().manual_seed(3)), 1)
    assert torch.equal(_bits(lane.cholesky_chain(H + junk * 100, b)),
                       _bits(lane.cholesky_chain(H, b)))


def test_cholesky_kernel_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors (no fallback)."""
    H, b = (torch.from_numpy(a) for a in _systems(32))
    with pytest.raises(ValueError, match='CUDA'):
        lane.cholesky_kernel(H, b)


def _blocked_direction(Hd, g, pw, blocks, own='shared', rows_pass=None, back=None,
                       release=None):
    """``-Hd^-1 g`` in the schedule of the kernel's cluster routes, written
    with plain torch and :func:`lane._fused_update` rounding: b is row n of
    the augmented lower triangle; panels of ``pw`` columns are dealt
    cyclically over ``blocks`` blocks; the owner factors panel p (its
    diagonal block column by column, then the rows below it in passes of
    ``rows_pass`` rows, each pass column by column) and publishes it; then
    each block applies the published panel's updates, j in order, to its
    own later panels. ``own``: where a block's panels live while it updates
    them, apart from the published copy (``'shared'``) or in it, in place
    (``'global'``). The back substitution goes in groups of ``back``
    columns from the last (``pw`` by default), each group's columns
    released ``release`` at a time (the whole group by default), j
    descending: each released column solved and applied to the group's
    rows below it, then the release applied to the rows before the group.
    Entries above the diagonal are updated too (with values never read),
    as the kernel's panel rows are."""
    B, n = g.shape
    a = torch.zeros((B, n + 1, n), dtype=torch.float32)
    a[:, :n] = torch.tril(Hd)
    a[:, n] = g
    pub = a if own == 'global' else torch.zeros_like(a)
    d = torch.empty_like(g)
    fail = torch.zeros(B, dtype=torch.bool)
    panels = -(-n // pw)
    rows_pass = rows_pass or n + 1
    for p in range(panels):
        c0, c1 = p * pw, min(n, (p + 1) * pw)
        for j in range(c0, c1):
            piv = a[:, j, j].clone()
            fail |= ~(piv > 0)
            d[:, j] = torch.sqrt(piv)
            a[:, j + 1:c1, j] = a[:, j + 1:c1, j] / d[:, j, None]
            for m in range(j + 1, c1):
                a[:, m:c1, m] = lane._fused_update(a[:, m:c1, m], a[:, m:c1, j], a[:, m, j, None])
        for r0 in range(c1, n + 1, rows_pass):
            r1 = min(n + 1, r0 + rows_pass)
            for j in range(c0, c1):
                a[:, r0:r1, j] = a[:, r0:r1, j] / d[:, j, None]
                for m in range(j + 1, c1):
                    a[:, r0:r1, m] = lane._fused_update(a[:, r0:r1, m], a[:, r0:r1, j],
                                                        a[:, m, j, None])
        if own != 'global':
            pub[:, c0:, c0:c1] = a[:, c0:, c0:c1]
        for blk in range(blocks):
            cols = [k for k in range(c1, n) if (k // pw) % blocks == blk]
            for j in range(c0, c1):
                a[:, c1:, cols] = lane._fused_update(a[:, c1:, cols], pub[:, c1:, j, None],
                                                     pub[:, cols, j][:, None, :])
    y = pub[:, n].clone()
    back = back or pw
    for c0 in range((n - 1) // back * back, -1, -back):
        c1 = min(n, c0 + back)
        for r1 in range(c1, c0, -(release or back)):
            r0 = max(c0, r1 - (release or back))
            for j in range(r1 - 1, r0 - 1, -1):
                y[:, j] = y[:, j] / d[:, j]
                y[:, c0:j] = lane._fused_update(y[:, c0:j], pub[:, j, c0:j], y[:, j, None])
            for j in range(r1 - 1, r0 - 1, -1):
                y[:, :c0] = lane._fused_update(y[:, :c0], pub[:, j, :c0], y[:, j, None])
    return torch.where(fail[:, None], torch.full((), float('nan')), -y)


_BLOCKED_SYSTEMS = {}


def _blocked_systems(n):
    """Three healthy lanes and lanes that fail at the first pivot, at a
    pivot inside a panel and at the last pivot (made once per n)."""
    if n not in _BLOCKED_SYSTEMS:
        H, b = _systems(n, damping=(0.2, 1.0, 5.0, 1.0, 1.0, 1.0))
        H[3, 0, 0] = -1.0
        k = min(n // 2 + 3, n - 2)  # inside a panel of 8 or 16
        H[4, k, k] = -(n + 1.0)
        H[5, n - 1, n - 1] = -(n + 1.0)
        _BLOCKED_SYSTEMS[n] = torch.from_numpy(H), torch.from_numpy(b)
    return _BLOCKED_SYSTEMS[n]


@pytest.mark.parametrize('blocks', [1, 8, 16])
@pytest.mark.parametrize('pw', [1, 8, 16])
@pytest.mark.parametrize('n', [6, 37, 128, 256, 300])
def test_blocked_schedule_keeps_every_bit(n, pw, blocks):
    """The cluster route's schedule (panels of ``pw`` columns over
    ``blocks`` blocks, the trailing update panel by panel, the back
    substitution panel by panel) gives :func:`lane.cholesky_chain`'s bits,
    failing lanes NaN in every entry."""
    H, b = _blocked_systems(n)
    chain = lane.cholesky_chain(H, b)
    assert _same_bits(_blocked_direction(H, b, pw, blocks), chain)
    nan = torch.isnan(chain).all(dim=1).tolist()
    assert nan == [False] * 3 + [True] * 3


@pytest.mark.parametrize('own', ['shared', 'global'])
@pytest.mark.parametrize('blocks', [8, 16])
@pytest.mark.parametrize('n', [37, 130, 300])
def test_cluster_routes_schedule_keeps_every_bit(n, blocks, own):
    """The kernel's cluster routes as they run: panels of 8 columns over 8
    or 16 blocks (the routes up to n = 807 and above it), a block's panels
    in its shared memory or in the published copy itself (the global
    scratch of the widest route), the rows below a diagonal block in
    passes (here of 5 rows, so that small n take several, as n > 967 do
    with the kernel's 960), and the back substitution in groups of 32
    columns released 8 at a time: :func:`lane.cholesky_chain`'s bits,
    failing lanes NaN in every entry."""
    H, b = _blocked_systems(n)
    chain = lane.cholesky_chain(H, b)
    out = _blocked_direction(H, b, 8, blocks, own=own, rows_pass=5, back=32, release=8)
    assert _same_bits(out, chain)
    assert torch.isnan(out).all(dim=1).tolist() == [False] * 3 + [True] * 3
