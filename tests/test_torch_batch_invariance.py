"""A lane's solve does not depend on its batch, nor on how often the Newton
loop reads its convergence flags.

Part one: every product and sum of a lane goes through
:mod:`superdsm_tpu_torch.dsm.lane` (on the CPU: ``torch.matmul`` and
``sum``, with a batch of one computed as a batch of two) or a library call on
that lane alone, so a lane solved alone and inside a batch gives bitwise the
same parameters, energy and iteration count. Before, a batch of one took
BLAS's matrix-vector route for ``Bf @ delta`` and a batch of two its
matrix-matrix one: bench seed 3's c2f solve at crop offset (279, 380)
stopped at 323.45 alone and at 95.48 in a batch of two.

Part two: the Newton loop runs ``solver.SYNC_EVERY`` iterations between two
reads of ``conv.all()`` (on the card, replays of a captured CUDA graph; on
the CPU, eagerly). Converged lanes are frozen bitwise, so any chunk gives
the results of one iteration at a time (``SYNC_EVERY = 1``), and PCG run to
``CG_MAX_ITERS`` gives those of its early exit.

Every comparison here is bitwise: the claims are about the order of the
arithmetic, not about a tolerance.
"""

import os

import numpy as np
import pytest
import torch

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import batching, gram, lane, solver
from superdsm_tpu_torch.dsm.smooth import build_smooth_matrix

HERE = os.path.dirname(os.path.abspath(__file__))
C2F_FIXTURE = os.path.join(HERE, 'data', 'torch_port', 'stall-seed3-c2f-279-380.npz')
ATOM17_FIXTURE = os.path.join(HERE, 'data', 'torch_port', 'stall-seed3-atom17.npz')
_SOLVE_BATCH_IMPL = solver._solve_batch_impl


@pytest.fixture(autouse=True)
def _cpu_device():
    with T.use_device('cpu'):
        yield


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """This module's solves on one torch thread (a worker process each; the
    count restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(a, b):
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _lanes(n, B=5, seed=0):
    """``B`` distinct lanes of size n = 6 + K from ``seed``: a square region
    holding a noisy disk, the DSM basis centred on K of its pixels spread
    evenly (n = 6: the polynomial basis alone). Returns the arguments of
    ``solver._solve_batch_impl`` up to ``maxiter``."""
    K = n - 6
    side = {6: 22, 128: 22, 512: 23}[n]
    P = -(-side * side // 256) * 256
    rr, cc = np.indices((side, side))
    pts = np.stack([rr.ravel(), cc.ravel()], 1).astype(np.float32)
    PIX = np.zeros((P, 2), np.float32)
    PIX[:len(pts)] = pts
    W = np.zeros(P, np.float32)
    W[:len(pts)] = 1.0
    rng = np.random.RandomState(seed + n)
    yv = np.zeros((B, P), np.float32)
    for b in range(B):
        r = side / 4 + rng.rand() * side / 8
        disk = (rr - side / 2 - rng.randn()) ** 2 + (cc - side / 2 - rng.randn()) ** 2 <= r * r
        yv[b, :len(pts)] = (disk - 0.5 + rng.randn(side, side) * 0.4).ravel()
    tile = lambda a: torch.from_numpy(np.stack([a] * B))
    coords = tile((PIX + 40.0) / np.float32(199.0))
    Q = solver._poly_basis(coords)
    w = tile(W)
    if K == 0:
        return (torch.zeros((B, 6)), Q, None, torch.from_numpy(yv), w,
                torch.zeros(B), 1.0, torch.zeros((B, 0)))
    grid = pts[::len(pts) // K][:K]
    assert len(grid) == K
    kmask = torch.ones((B, K))
    G = build_smooth_matrix(tile(PIX), tile(grid), 4.0, 16, kmask)
    return (torch.zeros((B, n)), Q, G, torch.from_numpy(yv), w,
            torch.full((B,), 0.05), 1.0, kmask)


def _lane(args, b):
    return tuple(a[b:b + 1] if isinstance(a, torch.Tensor) else a for a in args)


def _step_inputs(args):
    params, Q, G, yv, w, alpha, epsilon, kmask = args
    Bf = solver._features(Q, G)
    s = solver._bmv(Bf, params + 0.01)
    f0 = solver._energy_from_surface(s, params[:, 6:] + 0.01, yv, w, alpha,
                                     epsilon, kmask)
    g, H = gram.grad_hess_plain(Bf, s, yv, w)
    mu = torch.full((params.shape[0],), 1e-3)
    return (params + 0.01, mu, s, f0, g, H, Bf, yv, w, alpha, epsilon, kmask, 1e-5)


# ---------------------------------------------------------------------------
# part one: a lane alone equals the same lane in a batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [6, 128, 512])
def test_newton_step_lane_alone_equals_lane_in_batch(n):
    """``_newton_step`` on a batch of 5 and on each lane alone (n = 512
    solves by PCG): every output bitwise equal."""
    inputs = _step_inputs(_lanes(n))
    batch = solver._newton_step(*inputs)
    for b in range(5):
        alone = solver._newton_step(*_lane(inputs, b))
        for x, y in zip(alone, batch):
            assert _equal(x[0], y[b]), (n, b)


@pytest.mark.parametrize('n,maxiter', [(6, 50), (128, 20), (512, 3)])
def test_solve_lane_alone_equals_lane_in_batch(n, maxiter):
    """``_solve_batch_impl`` on a batch of 5 and on each lane alone: params,
    energy, convergence, surface and the lane's iterations bitwise equal."""
    args = _lanes(n)
    params, f, conv, _, s, it_lane = solver._solve_batch_impl(*args, maxiter, 1e-5)
    for b in range(5):
        p1, f1, c1, it1, s1, il1 = solver._solve_batch_impl(*_lane(args, b), maxiter, 1e-5)
        assert _equal(p1[0], params[b]) and _equal(f1[0], f[b]), (n, b)
        assert _equal(c1[0], conv[b]) and _equal(s1[0], s[b]), (n, b)
        assert _equal(il1[0], it_lane[b]) and int(it1) == int(il1[0]), (n, b)


def _fixture_problem(path):
    fx = np.load(path)
    sub = fx['sub'] if 'sub' in fx.files else np.zeros((0, 2), np.int32)
    return fx, batching.Problem(pts=fx['pts'], offset=fx['offset'],
                                img_shape=tuple(int(v) for v in fx['img_shape']),
                                yv=fx['yv'], sub=sub)


def _solve_copies(monkeypatch, problem, B, **kw):
    """``solve_problems`` on ``B`` copies of ``problem``; returns the
    results and every Newton loop's per-lane iterations."""
    it_lanes = []

    def spy(*args, **kwargs):
        out = _SOLVE_BATCH_IMPL(*args, **kwargs)
        it_lanes.append(out[5].clone())
        return out

    monkeypatch.setattr(solver, '_solve_batch_impl', spy)
    return batching.solve_problems([problem] * B, **kw), it_lanes


def _assert_same_lanes(runs):
    (ref, ref_its), rest = runs[0], runs[1:]
    for res, its in rest:
        for r in res:
            assert _equal(r.params, ref[0].params) and r.energy == ref[0].energy
        assert len(its) == len(ref_its)
        for it, it_ref in zip(its, ref_its):
            assert bool((it[:len(res)] == it_ref[0]).all()), (it, it_ref)


def test_c2f_stall_fixture_same_at_every_batch(monkeypatch):
    """Bench seed 3's c2f solve at crop offset (279, 380) (4022 pixels, six
    parameters, its first Newton system at condition 1.28e9) at B = 1, 2, 3
    and 4: every lane's params, energy and iterations bitwise equal (the
    parent stopped at 323.4516 alone and at 95.4780 in a batch)."""
    _, problem = _fixture_problem(C2F_FIXTURE)
    runs = [_solve_copies(monkeypatch, problem, B, smooth_amount=np.inf)
            for B in (1, 2, 3, 4)]
    _assert_same_lanes(runs)
    assert runs[0][0][0].energy == pytest.approx(95.478, rel=1e-4)


def test_atom17_stall_fixture_same_at_every_batch(monkeypatch):
    """Bench seed 3's atom 17 (5055 pixels, 86 deformation points, n = 128)
    at B = 1 and 2: params, energy and every loop's iterations bitwise
    equal."""
    fx, problem = _fixture_problem(ATOM17_FIXTURE)
    kw = dict(alpha=float(fx['alpha']), epsilon=float(fx['epsilon']),
              smooth_amount=float(fx['smooth_amount']),
              gaussian_shape_multiplier=int(fx['gaussian_shape_multiplier']))
    _assert_same_lanes([_solve_copies(monkeypatch, problem, B, **kw) for B in (1, 2)])


@pytest.mark.parametrize('shape,dim', [((5, 2048), -1), ((5, 2048, 12), 1),
                                       ((5, 9, 26), -1), ((5, 524288), -1)])
def test_lane_sum_plain_alone_equals_in_batch(shape, dim):
    """The plain lane sum of one lane alone equals the same lane's in a batch
    of five, also at four threads, where PyTorch sums one long row across
    threads (a batch of one is summed as two)."""
    x = torch.from_numpy(np.random.RandomState(len(shape)).randn(*shape).astype(np.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        full = lane.lane_sum(x, dim)
        for b in (0, 4):
            assert _equal(lane.lane_sum(x[b:b + 1], dim)[0], full[b])
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize('L', [1, 7, 256, 300, 5000])
def test_lane_sum_in_kernel_order(L):
    """The host replay of the row-sum kernel's order equals the order
    written out thread by thread (float32 scalars), and lies within
    sqrt(L) u sum|x| of the exact sum, on positive softplus terms."""
    rng = np.random.RandomState(L)
    x = np.logaddexp(rng.randn(2, L), 0.0).astype(np.float32)
    got = lane.lane_sum_in_kernel_order(x)
    T = lane.ROW_THREADS
    for r in range(2):
        part = []
        for t in range(T):
            acc = np.float32(0.0)
            for i in range(t, L, T):
                acc = np.float32(acc + x[r, i])
            part.append(acc)
        m = T // 2
        while m:
            part[:m] = [np.float32(part[t] + part[t + m]) for t in range(m)]
            m //= 2
        assert got[r].view(np.int32) == part[0].view(np.int32)
    exact = x.astype(np.float64).sum(1)
    assert (np.abs(got - exact) <= np.sqrt(L) * 2.0 ** -24 * exact).all()


@pytest.mark.parametrize('n', [6, 128, 1024])
def test_matvec_plain_alone_equals_in_batch(n):
    """The plain per-lane product alone equals the same lane's in a batch
    (``torch.matmul`` of a batch of one takes BLAS's matrix-vector route,
    which rounds differently)."""
    rng = np.random.RandomState(n)
    A = torch.from_numpy(rng.randn(5, 2048, n).astype(np.float32))
    x = torch.from_numpy(rng.randn(5, n).astype(np.float32))
    full = lane.matvec(A, x)
    assert _equal(full, (A @ x[..., None])[..., 0])
    for b in range(5):
        assert _equal(lane.matvec(A[b:b + 1], x[b:b + 1])[0], full[b])


# ---------------------------------------------------------------------------
# part two: the chunked loop, PCG's full run, the launch records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n,maxiter', [(6, 50), (6, 3), (128, 30), (128, 4), (512, 2)])
@pytest.mark.parametrize('k', [2, 4, 8])
def test_chunked_loop_equals_one_iteration_at_a_time(monkeypatch, n, maxiter, k):
    """The loop reading ``conv.all()`` every k iterations against every
    iteration (``SYNC_EVERY = 1``, the loop before the device loop):
    params, energy, conv, iterations and per-lane iterations bitwise equal,
    for poly (n = 6) and DSM solves, converged and cut at ``maxiter``."""
    args = _lanes(n, B=3)
    monkeypatch.setattr(solver, 'SYNC_EVERY', 1)
    ref = solver._solve_batch_impl(*args, maxiter, 1e-5)
    monkeypatch.setattr(solver, 'SYNC_EVERY', k)
    solver.reset_loop_stats()
    out = solver._solve_batch_impl(*args, maxiter, 1e-5)
    for x, y in zip(out, ref):
        assert _equal(x, y)
    assert int(out[3]) == int(ref[5].max())
    stats = solver.LOOP_STATS
    assert stats['solves'] == 1 and stats['graphs'] == 0 and stats['replays'] == 0
    assert stats['syncs'] == -(-stats['iterations'] // k)
    assert stats['iterations'] <= maxiter


def test_a_batch_cut_at_maxiter_reports_maxiter(monkeypatch):
    """A batch whose lanes do not all converge runs exactly ``maxiter``
    iterations in any chunk, and reports them on the device."""
    args = _lanes(128, B=3)
    for k in (1, 3, 8):
        monkeypatch.setattr(solver, 'SYNC_EVERY', k)
        _, _, conv, it, _, it_lane = solver._solve_batch_impl(*args, 4, 1e-5)
        assert not bool(conv.all()) and int(it) == 4
        assert bool((it_lane[~conv] == 4).all())


def test_pcg_full_run_equals_early_exit():
    """PCG run to ``CG_MAX_ITERS`` with its per-lane freeze (as inside a
    CUDA graph) against its early exit: bitwise equal, with lanes that stop
    at different steps."""
    rng = np.random.RandomState(3)
    n = 384
    M = rng.randn(4, n, n).astype(np.float32)
    H = torch.from_numpy(M @ M.transpose(0, 2, 1) / n
                         + np.eye(n, dtype=np.float32) * np.float32([[[0.2]], [[1.0]], [[5.0]], [[50.0]]]))
    b = torch.from_numpy(rng.randn(4, n).astype(np.float32))
    early = solver._pcg_solve(H, b)
    full = solver._pcg_solve(H, b, early_exit=False)
    assert _equal(early, full)
    assert not _equal(early, solver._pcg_solve(H, b, iters=2))


def test_eager_loop_nests_and_restores():
    assert solver._eager['depth'] == 0
    with solver.eager_loop():
        with solver.eager_loop():
            assert solver._eager['depth'] == 2
        assert solver._eager['depth'] == 1
    assert solver._eager['depth'] == 0


def test_recorded_launches_count_once_per_replay():
    """Launches made while a graph is captured are recorded, not counted;
    each replay counts them once and tells the launch hooks."""
    gram.reset_launch_counts()
    lane.reset_launch_counts()
    seen = []
    hook = lambda shape, active, banded, passes, full: seen.append(shape)
    gram.LAUNCH_HOOKS.append(hook)
    try:
        with gram.recording_launches() as records:
            gram._count_launch('banded', ((1, 2048, 512), torch.ones(1), True, 6, False))
            gram._count_launch('lane_sum', table=lane.LAUNCHES)
            with pytest.raises(RuntimeError):
                with gram.recording_launches():
                    pass
        assert gram.LAUNCHES['banded'] == 0 and lane.LAUNCHES['lane_sum'] == 0
        for _ in range(3):
            gram.count_replayed(records)
        assert gram.LAUNCHES['banded'] == 3 and lane.LAUNCHES['lane_sum'] == 3
        assert seen == [(1, 2048, 512)] * 3
        gram._count_launch('dense')
        assert gram.LAUNCHES['dense'] == 1
    finally:
        gram.LAUNCH_HOOKS.remove(hook)
        gram.reset_launch_counts()
        lane.reset_launch_counts()
