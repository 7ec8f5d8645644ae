"""The Cholesky direction of the Newton step on the CPU.

On the card ``solver._cholesky_direction`` is one launch of the
``lane_cholesky`` kernel (``superdsm_tpu_torch/csrc/lane_ops.cu``), held
bitwise to ``lane.cholesky_chain``, its order written op by op, by
``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py`` phase 3. On the
CPU the solver keeps LAPACK, and the chain is the kernel's arithmetic under
test. Here:

- the chain against the JAX package's vmapped ``cho_factor`` /
  ``cho_solve`` (JAX on the CPU, the same numpy inputs) at n = 6 to 256
  and at n = 384, whose work space takes the kernel's global-scratch route
  on the card: damped SPD systems built as ``tests/test_torch_pcg.py``
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
- ``lane.cholesky_kernel`` refuses CPU tensors: no fallback.
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


@pytest.mark.parametrize('n', [6, 32, 64, 128, 256, 384])
def test_chain_matches_the_jax_package(n):
    """The chain's direction against the JAX package's ``cho_factor`` /
    ``cho_solve`` on the same systems, rtol 1e-4, atol 1e-5; n = 384 is the
    kernel's global-scratch route on the card."""
    H, b = _systems(n)
    out = lane.cholesky_chain(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, _jax_direction(H, b), rtol=RTOL, atol=ATOL)
    assert (n > lane.CHOL_SHARED_MAX_N) == (n == 384)


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
    monkeypatch.setattr(solver, '_cholesky_direction', lane.cholesky_chain)
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
