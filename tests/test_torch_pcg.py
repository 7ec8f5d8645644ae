"""PCG (``solver._pcg_solve``) on the CPU.

On the card ``_pcg_solve`` is one launch of the ``lane_pcg`` kernel
(``superdsm_tpu_torch/csrc/lane_ops.cu``), held bitwise to the op-by-op
chain it replaces by ``tests/test_torch_kernel_cuda.py`` and
``chip_smoke.py`` phase 3. On the CPU it runs that chain
(``lane.pcg_chain``), which must stay bitwise what the solver computed
before the kernel existed. Here:

- ``_pcg_solve`` on the CPU against a copy of the solver's former PCG body
  (kept in this file), bitwise, with lanes that freeze at different steps,
  a lane cut at ``iters``, NaN and zero lanes, ``iters`` 0;
- against the JAX package's ``jax.vmap(_pcg_solve)`` (JAX on the CPU, the
  same numpy inputs) at n = 384 and 512, with lanes damped from 0.2 to 50
  (2 to 26 steps) and, at ``iters`` = 16, a lane that does not converge
  within ``iters``: rtol 1e-4, atol 1e-5, as
  ``tests/test_torch_solver.py::test_cg_matches_cholesky_and_jax_lane_freeze``
  (float32 sums in another order: the port's in the lane kernels' order,
  XLA's its own);
- the early exit (a host sync every ``lane.PCG_SYNC_EVERY`` steps) and the
  full run give the same bits, and a lane alone gives its bits in a batch;
- ``lane.pcg_kernel`` refuses CPU tensors: no fallback;
- the schedule of the kernel's register route (``lane_pcg_reg_kernel``,
  n <= ``lane.PCG_REG_MAX_N``) replayed in numpy: a warp's 8 rows reduced
  by one xor tree that halves the rows a lane carries gives each row the
  bits of ``lane_matvec``'s separate tree (a tree in another order
  fails), and the dots' slots read from the registers' columns (thread
  (w, l) holds j = l + 32 k) give ``lane_sum``'s order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdsm_tpu.dsm import solver as jsolver

from superdsm_tpu_torch.dsm import lane, solver

RTOL, ATOL = 1e-4, 1e-5
#: Per-lane damping of the test systems: PCG stops after about 26, 12, 6
#: and 2 steps on these lanes (n = 384 and 512).
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


def _former_pcg(H, b, iters=solver.CG_MAX_ITERS, rtol=solver.CG_RTOL,
                early_exit=True):
    """The solver's PCG body before the ``lane_pcg`` kernel, as it was."""
    dinv = 1.0 / torch.diagonal(H, dim1=-2, dim2=-1)
    x = b * dinv
    r = b - lane.matvec(H, x)
    z = r * dinv
    p = z
    rz = lane.lane_dot(r, z)
    r2_stop = (rtol * rtol) * lane.lane_dot(b, b) + 1e-30
    live = lane.lane_dot(r, r) > r2_stop
    for i in range(iters):
        if early_exit and i % 8 == 0 and not bool(live.any()):
            break
        Hp = lane.matvec(H, p)
        a = rz / (lane.lane_dot(p, Hp) + 1e-30)
        x_new = x + a[:, None] * p
        r_new = r - a[:, None] * Hp
        z = r_new * dinv
        rz_new = lane.lane_dot(r_new, z)
        beta = rz_new / (rz + 1e-30)
        p_new = z + beta[:, None] * p
        keep = live[:, None]
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, p_new, p)
        rz = torch.where(live, rz_new, rz)
        live = live & (lane.lane_dot(r, r) > r2_stop)
    return x


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(a, b):
    """Bitwise equal, a NaN equal to any NaN."""
    return bool(((_bits(a) == _bits(b)) | (torch.isnan(a) & torch.isnan(b))).all())


def _case(name):
    """``(H, b, iters)`` of a named case (torch, CPU)."""
    n = int(name.split('n = ')[1].split(',')[0].split(' ')[0])
    H, b = _systems(n)
    iters = solver.CG_MAX_ITERS
    if 'iters' in name:
        iters = int(name.split('iters = ')[1])
    H, b = torch.from_numpy(H), torch.from_numpy(b)
    if 'nan' in name:
        H[1, 3, 5] = float('nan')  # r has a NaN: never live
        b[2] = 0.0  # a zero right-hand side: done before the first step
        H[3, 7, 7] = float('nan')  # dinv, and so x, have a NaN
    return H, b, iters


CASES = ['n = 384', 'n = 512', 'n = 384, iters = 16', 'n = 384, iters = 0',
         'n = 40', 'n = 6', 'n = 384 with nan and zero lanes']


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('early_exit', [True, False])
def test_pcg_on_the_cpu_is_the_former_chain(case, early_exit):
    """On the CPU ``_pcg_solve`` computes bitwise what the solver's own PCG
    body computed before the kernel (the chain the kernel replaces on the
    card), NaN lanes included."""
    H, b, iters = _case(case)
    out = solver._pcg_solve(H, b, iters=iters, early_exit=early_exit)
    ref = _former_pcg(H, b, iters=iters, early_exit=early_exit)
    assert _same_bits(out, ref)
    assert _same_bits(out, lane.pcg_chain(H, b, iters, solver.CG_RTOL, early_exit))
    if 'nan' in case:
        # the NaN lanes are never live (r . r is NaN): x = b / diag(H)
        for k in (1, 3):
            assert _same_bits(out[k], b[k] * (1.0 / torch.diagonal(H[k])))
        assert bool(torch.isfinite(out[1]).all()) and bool(torch.isnan(out[3, 7]))
        assert bool((out[2] == 0).all())


@pytest.mark.parametrize('n', [384, 512])
@pytest.mark.parametrize('iters', [16, solver.CG_MAX_ITERS])
def test_pcg_matches_the_jax_package(n, iters):
    """``_pcg_solve`` against the JAX package's vmapped ``_pcg_solve`` on the
    same systems: lanes that freeze after 2 to 26 steps, and at ``iters`` =
    16 the lane damped by 0.2, which does not converge within ``iters``;
    rtol 1e-4, atol 1e-5."""
    H, b = _systems(n)
    out = solver._pcg_solve(torch.from_numpy(H), torch.from_numpy(b), iters=iters).numpy()
    ref = np.asarray(jax.vmap(functools.partial(jsolver._pcg_solve, iters=iters))(
        jnp.asarray(H), jnp.asarray(b)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    if iters == 16:
        # the 0.2 lane is cut at iters: more steps still move it
        more = solver._pcg_solve(torch.from_numpy(H[:1]), torch.from_numpy(b[:1]),
                                 iters=iters + 1).numpy()
        assert not np.array_equal(more[0], out[0])


@pytest.mark.parametrize('n', [384, 512])
def test_early_exit_and_full_run_give_the_same_bits(n):
    """The early exit and the run of all ``CG_MAX_ITERS`` steps agree
    bitwise; each lane alone gives its bits in the batch; a lane stops at a
    step of its own (fewer steps change it)."""
    H, b = (torch.from_numpy(a) for a in _systems(n))
    early = solver._pcg_solve(H, b)
    full = solver._pcg_solve(H, b, early_exit=False)
    assert torch.equal(_bits(early), _bits(full))
    for k in range(H.shape[0]):
        alone = solver._pcg_solve(H[k:k + 1], b[k:k + 1], early_exit=False)
        assert torch.equal(_bits(alone[0]), _bits(full[k]))
    steps = [next(i for i in range(solver.CG_MAX_ITERS + 1)
                  if torch.equal(solver._pcg_solve(H[k:k + 1], b[k:k + 1], iters=i)[0],
                                 full[k]))
             for k in range(H.shape[0])]
    assert len(set(steps)) == len(steps) and max(steps) < solver.CG_MAX_ITERS


def test_pcg_kernel_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors (no fallback); ``lane.pcg``
    takes the chain there and launches nothing."""
    H, b = (torch.from_numpy(a) for a in _systems(40))
    with pytest.raises(ValueError, match='CUDA'):
        lane.pcg_kernel(H, b, solver.CG_MAX_ITERS, solver.CG_RTOL)
    lane.reset_launch_counts()
    lane.pcg(H, b, solver.CG_MAX_ITERS, solver.CG_RTOL)
    assert lane.LAUNCHES['lane_pcg'] == 0


_LANES = np.arange(32)


def _xor_tree(v, order=(16, 8, 4, 2, 1)):
    """``lane_matvec_kernel``'s tree of one row's 32 lane sums (float32):
    lane l adds lane l ^ m's value for m = 16, 8, 4, 2, 1; every lane's
    result."""
    for m in order:
        v = (v + v[_LANES ^ m]).astype(np.float32)
    return v


def _rows_tree(acc, order=(16, 8, 4)):
    """``lane_pcg_reg_kernel``'s tree of a warp's 8 rows at once (``acc``
    (8, 32): row e's sum in lane l): at each m of ``order`` a lane keeps the
    half of its rows its bit m selects and adds its partner's copy of them,
    then m = 2, 1 on the one row left; returns (32,), lane l's row."""
    v = acc
    for m in order:
        half = v.shape[0] // 2
        hi = (_LANES & m) != 0
        send = np.where(hi, v[:half], v[half:])
        keep = np.where(hi, v[half:], v[:half])
        v = (keep + send[:, _LANES ^ m]).astype(np.float32)
    v = v[0]
    for m in (2, 1):
        v = (v + v[_LANES ^ m]).astype(np.float32)
    return v


@pytest.mark.parametrize('seed', range(4))
def test_register_route_row_tree_keeps_every_bit(seed):
    """Lanes 4 e .. 4 e + 3 end with row e's sum, bitwise what the separate
    xor tree gives it; on these sums a tree in another order gives other
    bits (so the comparison would see one)."""
    rng = np.random.RandomState(seed)
    acc = (rng.randn(8, 32) * 10.0 ** rng.randint(-3, 4, (8, 32))).astype(np.float32)
    rows = _rows_tree(acc)
    for e in range(8):
        want = _xor_tree(acc[e])
        assert np.all(want == want[0])
        assert np.array_equal(rows[4 * e:4 * e + 4].view(np.int32),
                              np.full(4, want[0], np.float32).view(np.int32))
    assert any(_xor_tree(acc[e], (8, 16, 4, 2, 1))[0] != _xor_tree(acc[e])[0]
               for e in range(8))


@pytest.mark.parametrize('n', [6, 100, 256, 300, 510, 512])
def test_register_route_dot_slots_keep_every_bit(n):
    """A dot's slot t = 32 w + l sums the columns k = w and w + 8 that
    thread (w, l) holds (j = l + 32 k < n, in that order, from 0), and the
    slot tree gives ``lane.lane_sum_in_kernel_order``'s bits."""
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * 10.0 ** rng.randint(-3, 4, n)).astype(np.float32)
    slots = np.zeros(256, np.float32)
    for w in range(8):
        for l in range(32):
            for k in (w, w + 8):
                j = l + 32 * k
                if j < n:
                    slots[32 * w + l] = np.float32(slots[32 * w + l] + x[j])
    v = slots.reshape(8, 32)  # v[r, l]: slot 32 r + l
    for m in (4, 2, 1):
        v = (v[:m] + v[m:2 * m]).astype(np.float32)
    v = v[0]
    for m in (16, 8, 4, 2, 1):  # shuffle down: lane l adds lane l + m
        v = (v + np.concatenate([v[m:], np.zeros(m, np.float32)])).astype(np.float32)
    want = lane.lane_sum_in_kernel_order(x[None])[0]
    assert v[0].view(np.int32) == np.float32(want).view(np.int32)
