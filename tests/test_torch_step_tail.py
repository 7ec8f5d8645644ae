"""The rest of the Newton step after the line search's sums, on the CPU.

:func:`lane.step_pick` is the line search's pick (the first passing step,
else the least candidate; the new params and surface) and
:func:`lane.step_tail` the scale sweep's regularizer and pick, the new mu,
the convergence test and, given the loop's state, the freeze writes that
``iteration()`` made. On the card each is one kernel (``lane_step_pick``,
``lane_step_tail`` in ``superdsm_tpu_torch/csrc/lane_ops.cu``); on the CPU
each is its plain version, which must be exactly the op-by-op expressions
the solver ran before, so that every CPU result stays bitwise what it was.
Both solvers reach them through ``solver._step_tail``. Here:

- (a) the plain versions (and the entry points, which launch nothing on
  the CPU) bitwise a copy of those expressions (kept in this file), on a
  Cholesky lane, a PCG lane (``CHOLESKY_MAX_N`` monkeypatched below n) and
  a polynomial lane at B = 1, 2 and 5, with ties in the candidates and in
  the scale sweep's, a NaN and an all-inf candidate, no passing step, a
  scale candidate that is not finite, mu at ``MU_MIN`` and ``MU_MAX`` and a
  lane already converged, each in the last lane;
- (b) ``solver._newton_step`` given the loop's state bitwise its return
  mode followed by the former freeze writes;
- (c) the step against the JAX package's ``_newton_step``
  (``superdsm_tpu/dsm/solver.py:181-289``) and one loop iteration against
  its loop body (``:370-376``), run by JAX on the CPU on the same numpy
  inputs, at rtol 1e-5 (float32 sums in another order); the flags, mu and
  the lanes' iterations exactly;
- (d) the kernels' schedules replayed in numpy with their own index
  arithmetic (a lane's pick recomputed by each of its blocks, the first
  passing step, ATen's argmin: its first NaN, else its first least value;
  the scale sweep's regularizer sums over 256 slots and their trees):
  bitwise the chain replayed with float32 numpy ops and
  :func:`lane.lane_sum_in_kernel_order`; a replay with the slots in
  another order gives other bits;
- (e) ``solver._solve_batch_impl`` and ``parallel/newton._newton_row``
  bitwise copies of their former bodies (kept in this file).

The kernels themselves are held bitwise to their chains on the card by
``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py`` phase 3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdsm_tpu.dsm import solver as jsolver

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import gram, lane, solver
from superdsm_tpu_torch.dsm.smooth import build_smooth_matrix
from superdsm_tpu_torch.parallel import mesh as pm
from superdsm_tpu_torch.parallel import newton

torch.set_num_threads(1)

EPSILON = 1.0
TOL = 1e-5
#: Lane kinds: (n, direction); the PCG lane's n lies above the
#: ``CHOLESKY_MAX_N`` that :func:`_kind` sets.
KINDS = {'cholesky': (38, 'cholesky'), 'pcg': (70, 'pcg'), 'poly': (6, 'cholesky')}
PCG_CUTOVER = 64
VARIANTS = ['as is', 'tied candidates', 'NaN candidate', 'all-inf candidates',
            'no passing step', 'tied scale candidates', 'scale candidate not finite',
            'mu at MU_MIN', 'mu at MU_MAX', 'converged lane']


@pytest.fixture(autouse=True)
def _cpu_device():
    with T.use_device('cpu'):
        yield


@pytest.fixture
def _kind(monkeypatch):
    monkeypatch.setattr(solver, 'CHOLESKY_MAX_N', PCG_CUTOVER)
    monkeypatch.setattr(jsolver, 'CHOLESKY_MAX_N', PCG_CUTOVER)


def _bits_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _inputs(n, B, seed=0, P=256):
    """One Newton step's inputs at n = 6 + K as numpy float32: features Bf
    (B, P, n), params, labels, weights, kmask with some padded dimensions,
    alpha, the surface, f0 and the plain gram's g and H, mu of 1e-6 to
    1e-1 across the lanes."""
    rng = np.random.RandomState(seed + 10 * n + B)
    K = n - 6
    t = torch.from_numpy
    Bf = (rng.randn(B, P, n) * 0.3).astype(np.float32)
    params = (rng.randn(B, n) * 0.5).astype(np.float32)
    yv = np.sign(rng.randn(B, P)).astype(np.float32)
    w = (rng.rand(B, P) < 0.9).astype(np.float32)
    kmask = (rng.rand(B, K) < 0.8).astype(np.float32)
    alpha = (rng.rand(B) * 0.5 + 0.05 if K else np.zeros(B)).astype(np.float32)
    s = lane.matvec(t(Bf), t(params))
    f0 = solver._energy_from_surface(s, t(params)[:, 6:], t(yv), t(w), t(alpha), EPSILON,
                                     t(kmask))
    g, H = gram.grad_hess_plain(t(Bf), s, t(yv), t(w))
    mu = (10.0 ** rng.uniform(-6, -1, B)).astype(np.float32)
    return dict(params=params, mu=mu, s=s.numpy(), f0=f0.numpy(), g=g.numpy(), H=H.numpy(),
                Bf=Bf, yv=yv, w=w, alpha=alpha, kmask=kmask)


def _steps():
    return 0.5 ** torch.arange(solver.LS_STEPS, dtype=torch.float32)


def _scales():
    return torch.tensor(solver.SCALES, dtype=torch.float32)


# the expressions the solver ran before lane.step_pick and lane.step_tail
# (superdsm_tpu_torch/dsm/solver.py's _newton_step and the Newton loop's
# iteration), op by op


def _former_pick(data_cand, reg_cand, armijo_f, f0, steps, params, delta, s, u):
    n = params.shape[1]
    dt, dev = params.dtype, params.device
    f_cand = data_cand + reg_cand if n > 6 else data_cand
    armijo = f_cand <= armijo_f
    any_ok = armijo.any(dim=1)
    first_ok = armijo.to(torch.int32).argmax(dim=1)
    best = torch.argmin(f_cand, dim=1)
    pick = torch.where(any_ok, first_ok, best)
    f_pick = f_cand.gather(1, pick[:, None])[:, 0]
    improved = f_pick < f0
    t_step = torch.where(improved, steps[pick], torch.zeros((), dtype=dt, device=dev))
    full_step = improved & (pick == 0)
    new_params = params + t_step[:, None] * delta
    new_s = s + t_step[:, None] * u
    new_f = torch.where(improved, f_pick, f0)
    return t_step, new_params, new_s, new_f, improved, full_step


def _former_tail(data_sc, new_params, new_s, new_f, improved, full_step, mu, f0, decrement,
                 alpha, epsilon, kmask, scales, tol):
    n = new_params.shape[1]
    dt, dev = new_params.dtype, new_params.device
    sq_eps = math.sqrt(epsilon)
    if n > 6:
        xi_sc = new_params[:, 6:, None] * scales
        term2sc = torch.sqrt(xi_sc * xi_sc + epsilon)
        reg_sc = (alpha[:, None] * lane.lane_sum(kmask[:, :, None] * (term2sc - sq_eps), 1)
                  ).clamp_min(0.0)
        f_sc = data_sc + reg_sc
    else:
        f_sc = data_sc
    pick_sc = torch.argmin(f_sc, dim=1)
    f_sc_pick = f_sc.gather(1, pick_sc[:, None])[:, 0]
    boost = (f_sc_pick < new_f) & torch.isfinite(f_sc_pick)
    c_best = torch.where(boost, scales[pick_sc], torch.ones((), dtype=dt, device=dev))
    new_params = new_params * c_best[:, None]
    new_s = new_s * c_best[:, None]
    new_f = torch.where(boost, f_sc_pick, new_f)

    new_mu = torch.where(full_step, (mu * 0.25).clamp_min(solver.MU_MIN),
                         torch.where(improved, mu, (mu * 8.0).clamp_max(solver.MU_MAX)))
    tiny_gain = (f0 - new_f) <= tol * (1.0 + f0.abs())
    converged = (((0.5 * decrement <= tol * (1.0 + f0.abs())) & (mu <= 1e-4)
                  & tiny_gain)
                 | ((~improved) & (mu >= solver.MU_MAX) & tiny_gain))
    return new_params, new_s, new_f, converged, new_mu


def _former_freeze(params, s, fval, mu, it_lane, it_dev, conv, out):
    """The loop's former freeze writes after ``it_dev.add_(1)``."""
    new_params, new_s, new_f, new_conv, new_mu = out
    keep = conv[:, None]
    params.copy_(torch.where(keep, params, new_params))
    s.copy_(torch.where(keep, s, new_s))
    fval.copy_(torch.where(conv, fval, new_f))
    mu.copy_(torch.where(conv, mu, new_mu))
    it_lane.copy_(torch.where(conv, it_lane, it_dev))
    conv.logical_or_(new_conv)


def _former_newton_step(params, mu, s, f0, g, H, Bf, yv, w, alpha, epsilon, kmask, tol):
    """``solver._newton_step`` as it was, op by op after the guard."""
    n = params.shape[1]
    dt, dev = params.dtype, params.device
    g, Hd = lane.lm_system(params, mu, alpha, epsilon, kmask, g, H)
    steps = 0.5 ** torch.arange(solver.LS_STEPS, dtype=dt, device=dev)
    if n > solver.CHOLESKY_MAX_N:
        direction, negate = solver._pcg_solve(Hd, g), True
    else:
        direction, negate = solver._cholesky_direction(Hd, g), False
    delta, decrement, reg_cand, armijo_f = lane.step_guard(
        direction, g, params, alpha, epsilon, kmask, steps, f0, solver.ARMIJO_C, negate)
    u = lane.matvec(Bf, delta)
    data_cand = lane.softplus_energies(s, yv, w, steps, u)
    t_step, new_params, new_s, new_f, improved, full_step = _former_pick(
        data_cand, reg_cand, armijo_f, f0, steps, params, delta, s, u)
    scales = solver._scales(dt, dev)
    data_sc = lane.softplus_energies(new_s, yv, w, scales)
    return _former_tail(data_sc, new_params, new_s, new_f, improved, full_step, mu, f0,
                        decrement, alpha, epsilon, kmask, scales, tol)


def _direction(kind, g, Hd):
    if KINDS[kind][1] == 'pcg':
        return solver._pcg_solve(Hd, g), True
    return solver._cholesky_direction(Hd, g), False


def _tail_inputs(kind, B, variant):
    """The pick's and the tail's inputs of one step (the solver's own up to
    the line search's sums), the variant applied to the last lane: its
    candidates, scale sweep energies or mu; and the loop's state with conv
    set in lane 0 of B >= 2 and, in the 'converged lane' variant, in the
    last."""
    n, _ = KINDS[kind]
    a = {k: torch.from_numpy(np.array(v)) for k, v in _inputs(n, B).items()}
    g, Hd = lane.lm_system(a['params'], a['mu'], a['alpha'], EPSILON, a['kmask'], a['g'],
                           a['H'])
    direction, negate = _direction(kind, g, Hd)
    delta, decrement, reg_cand, armijo_f = lane.step_guard(
        direction, g, a['params'], a['alpha'], EPSILON, a['kmask'], _steps(), a['f0'],
        solver.ARMIJO_C, negate)
    u = lane.matvec(a['Bf'], delta)
    data_cand = lane.softplus_energies(a['s'], a['yv'], a['w'], _steps(), u)
    reg = reg_cand if reg_cand is not None else torch.zeros_like(data_cand)
    f0, mu = a['f0'], a['mu']
    if variant == 'tied candidates':
        data_cand[-1] = f0[-1] + 5.0 - reg[-1]
        data_cand[-1, 3] = data_cand[-1, 8] = f0[-1] + 4.0 - reg[-1, 3]
        data_cand[-1, 8] = f0[-1] + 4.0 - reg[-1, 8]
    elif variant == 'NaN candidate':
        data_cand[-1] = f0[-1] + 5.0 - reg[-1]
        data_cand[-1, 5] = float('nan')
    elif variant == 'all-inf candidates':
        data_cand[-1] = float('inf')
    elif variant == 'no passing step':
        data_cand[-1] = armijo_f[-1] + 1.0 + torch.arange(12.0)
    elif variant == 'mu at MU_MIN':
        data_cand[-1, 0] = armijo_f[-1, 0] - 1.0 - reg[-1, 0]
        mu[-1] = solver.MU_MIN
    elif variant == 'mu at MU_MAX':
        mu[-1] = solver.MU_MAX
    t_step, new_params, new_s, new_f, improved, full_step = _former_pick(
        data_cand, reg_cand, armijo_f, f0, _steps(), a['params'], delta, a['s'], u)
    data_sc = lane.softplus_energies(new_s, a['yv'], a['w'], _scales())
    if variant == 'tied scale candidates':
        data_sc[-1] = new_f[-1] - 1.0
    elif variant == 'scale candidate not finite':
        data_sc[-1, 2] = float('nan')
        data_sc[-1, 6] = float('-inf')
    conv = torch.zeros(B, dtype=torch.bool)
    conv[0] = B >= 2
    conv[-1] |= variant == 'converged lane'
    return dict(a, data_cand=data_cand, reg_cand=reg_cand, armijo_f=armijo_f, delta=delta,
                decrement=decrement, u=u, data_sc=data_sc, conv=conv,
                it_lane=torch.arange(B, dtype=torch.int32), it_dev=torch.tensor(7, dtype=torch.int32))


def _pick_args(a):
    return (a['data_cand'], a['reg_cand'], a['armijo_f'], a['f0'], _steps(), a['params'],
            a['delta'], a['s'], a['u'])


def _tail_args(a, pick, mu=None, f0=None):
    return (a['data_sc'], *pick[1:], a['mu'] if mu is None else mu,
            a['f0'] if f0 is None else f0, a['decrement'], a['alpha'], EPSILON, a['kmask'],
            _scales(), TOL)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('B', [1, 2, 5])
@pytest.mark.parametrize('kind', list(KINDS))
def test_plain_versions_are_the_former_expressions(kind, B, variant, _kind):
    """(a) ``step_pick_plain`` and ``step_tail_plain`` (and the entry
    points, which launch nothing on the CPU) bitwise the expressions the
    solver ran before, in every variant; with the loop's state, bitwise the
    former freeze writes after them, a converged lane's state untouched."""
    a = _tail_inputs(kind, B, variant)
    lane.reset_launch_counts()
    want = _former_pick(*_pick_args(a))
    for got in (lane.step_pick_plain(*_pick_args(a)), lane.step_pick(*_pick_args(a))):
        assert len(got) == 6 and all(_bits_equal(x, y) for x, y in zip(got, want))
    tail_want = _former_tail(*_tail_args(a, want))
    for fn in (lane.step_tail_plain, lane.step_tail):
        got = fn(*_tail_args(a, want), solver.MU_MIN, solver.MU_MAX)
        assert len(got) == 5 and all(_bits_equal(x, y) for x, y in zip(got, tail_want))
    if variant in ('NaN candidate', 'all-inf candidates', 'no passing step',
                   'tied candidates'):
        assert not bool(want[4][-1])  # no step: mu grows, the energy stays
    if variant == 'mu at MU_MIN':
        assert bool(want[5][-1]) and float(tail_want[4][-1]) == np.float32(solver.MU_MIN)
    keys = ('params', 's', 'f0', 'mu', 'it_lane', 'it_dev', 'conv')
    former = {k: a[k].clone() for k in keys}
    _former_freeze(former['params'], former['s'], former['f0'], former['mu'], former['it_lane'],
                   former['it_dev'], former['conv'], tail_want)
    st = {k: a[k].clone() for k in keys}
    assert lane.step_tail(*_tail_args(a, want, st['mu'], st['f0']), solver.MU_MIN,
                          solver.MU_MAX, lane.FreezeState(st['params'], st['s'], st['f0'],
                                                          st['it_lane'], st['it_dev'],
                                                          st['conv'])) is None
    for k in keys:
        assert _bits_equal(st[k], former[k])
    for k in ('params', 's', 'f0', 'mu', 'it_lane'):   # a converged lane as it was
        assert _bits_equal(st[k][a['conv']], a[k][a['conv']])
    assert not any(lane.LAUNCHES.values())


@pytest.mark.parametrize('B', [1, 5])
@pytest.mark.parametrize('kind', list(KINDS))
def test_newton_step_state_mode_is_return_mode_and_freeze(kind, B, _kind):
    """(b) ``solver._newton_step`` given the loop's state (params, s, fval,
    mu, it_lane, conv, with ``it_dev`` added to before) bitwise its return
    mode followed by the former freeze writes, with some lanes converged;
    and its return mode bitwise the former step."""
    n, _ = KINDS[kind]
    a = {k: torch.from_numpy(np.array(v)) for k, v in _inputs(n, B, seed=4).items()}
    args = (a['params'], a['mu'], a['s'], a['f0'], a['g'], a['H'], a['Bf'], a['yv'], a['w'],
            a['alpha'], EPSILON, a['kmask'], TOL)
    out = solver._newton_step(*args)
    assert all(_bits_equal(x, y) for x, y in zip(out, _former_newton_step(*args)))
    conv = torch.arange(B) % 2 == 1
    it_dev = torch.tensor(3, dtype=torch.int32)
    former = [t.clone() for t in (a['params'], a['s'], a['f0'], a['mu'])]
    former_it, former_conv = torch.zeros(B, dtype=torch.int32), conv.clone()
    _former_freeze(*former, former_it, it_dev, former_conv, out)
    st = [t.clone() for t in (a['params'], a['s'], a['f0'], a['mu'])]
    it_lane, c = torch.zeros(B, dtype=torch.int32), conv.clone()
    assert solver._newton_step(st[0], st[3], st[1], st[2], *args[4:],
                               state=lane.FreezeState(st[0], st[1], st[2], it_lane, it_dev,
                                                      c)) is None
    for x, y in zip(st + [it_lane, c], former + [former_it, former_conv]):
        assert _bits_equal(x, y)


# (c) the JAX package's step and loop body on the same numpy inputs


@pytest.mark.parametrize('kind', list(KINDS))
def test_step_and_iteration_match_the_jax_package(kind, _kind):
    """(c) ``solver._newton_step`` against the JAX package's vmapped
    ``_newton_step`` (``superdsm_tpu/dsm/solver.py:181-289``), and the
    port's in-place iteration (the step given the loop's state) against its
    loop body's freeze (``:370-376``) on the same inputs, lanes 1 and 3
    already converged: params, surface and energy to rtol 1e-5, the flags,
    mu and the lanes' iterations exactly."""
    n, _ = KINDS[kind]
    a = _inputs(n, 4, seed=6)
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    args = (t['params'], t['mu'], t['s'], t['f0'], t['g'], t['H'], t['Bf'], t['yv'], t['w'],
            t['alpha'], EPSILON, t['kmask'], TOL)
    out = solver._newton_step(*args)
    step = jax.vmap(jsolver._newton_step,
                    in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None, 0, None))
    ref = step(*(jnp.asarray(a[k]) for k in ('params', 'mu', 's', 'f0', 'g', 'H', 'Bf',
                                             'yv', 'w', 'alpha')),
               EPSILON, jnp.asarray(a['kmask']), TOL)
    for x, y in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    for x, y in zip(out[3:], ref[3:]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    # one iteration of the loop: the JAX body's freeze after its step
    conv0 = np.array([False, True, False, True])
    it = 4
    new_params, new_s, new_f, new_conv, new_mu = ref
    cj = jnp.asarray(conv0)
    want = dict(params=jnp.where(cj[:, None], a['params'], new_params),
                s=jnp.where(cj[:, None], a['s'], new_s),
                f0=jnp.where(cj, a['f0'], new_f), mu=jnp.where(cj, a['mu'], new_mu),
                it_lane=jnp.where(cj, jnp.zeros(4, jnp.int32), it + 1), conv=cj | new_conv)
    st = {k: t[k].clone() for k in ('params', 's', 'f0', 'mu')}
    st['it_lane'] = torch.zeros(4, dtype=torch.int32)
    st['conv'] = torch.from_numpy(conv0.copy())
    it_dev = torch.tensor(it, dtype=torch.int32)
    it_dev.add_(1)
    solver._newton_step(st['params'], st['mu'], st['s'], st['f0'], *args[4:],
                        state=lane.FreezeState(st['params'], st['s'], st['f0'], st['it_lane'],
                                               it_dev, st['conv']))
    for k in ('params', 's', 'f0'):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ('mu', 'it_lane', 'conv'):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(want[k]), err_msg=k)


# (d) the kernels' schedules replayed in numpy

F32 = np.float32
#: csrc/lane_ops.cu: slots of a sum, warps of a block, blocks of a lane.
SLOTS, WARP, STEP_BLOCKS = lane.ROW_THREADS, 32, 8


def _clamp(v, lo=None, hi=None):
    if np.isnan(v):
        return v
    return F32(max(v, lo)) if lo is not None else F32(min(v, hi))


def _slot_sum(terms, reverse=False):
    """A block's sum of ``terms`` (L,) as ``reg_sums`` runs it: slot t adds
    terms t, t + 256, ... in turn from 0 (``reverse``: another order, slot
    t adds a contiguous run of c terms, t c to t c + c - 1, c = ceil(L /
    256)); warp k % 8 gathers slots 32 r + l into v[r], adds v[r + m] for m
    = 4, 2, 1 and then shuffles down by 16, ..., 1; lane 0 holds the
    sum."""
    slots = np.zeros(SLOTS, F32)
    L = len(terms)
    chain = -(-L // SLOTS)
    for t in range(SLOTS):
        run = range(t * chain, min(L, (t + 1) * chain)) if reverse else range(t, L, SLOTS)
        for i in run:
            slots[t] = F32(slots[t] + terms[i])
    v = slots.reshape(SLOTS // WARP, WARP)
    for m in (4, 2, 1):
        v = (v[:m] + v[m:2 * m]).astype(F32)
    x = v[0]
    for m in (16, 8, 4, 2, 1):
        x = (x + np.concatenate([x[m:], np.zeros(m, F32)])).astype(F32)
    return x[0]


def _aten_argmin(v):
    """``aten_argmin`` of the kernels, in their loop: the first NaN, else
    the first least value."""
    best = 0
    for k in range(1, len(v)):
        if not np.isnan(v[best]) and (np.isnan(v[k]) or v[k] < v[best]):
            best = k
    return best


def _pick_kernel_replay(data_cand, reg_cand, thr, f0, steps, params, delta, s, u):
    """``lane_step_pick_kernel`` block by block: each of a lane's blocks
    recomputes its pick (thread 0's loop) and writes every 8th run of 256
    surface entries; rank 0 writes the lane's params and scalars."""
    B, n = params.shape
    P = s.shape[1]
    t_step, new_f = np.empty(B, F32), np.empty(B, F32)
    improved, full_step = np.empty(B, bool), np.empty(B, bool)
    new_params, new_s = np.empty_like(params), np.empty_like(s)
    for block in range(B * STEP_BLOCKS):
        o, rank = divmod(block, STEP_BLOCKS)
        f = data_cand[o] + reg_cand[o] if reg_cand is not None else data_cand[o]
        passing = [k for k in range(len(f)) if f[k] <= thr[o, k]]
        pick = passing[0] if passing else _aten_argmin(f)
        imp = f[pick] < f0[o]
        ts = steps[pick] if imp else F32(0)
        if rank == 0:
            t_step[o], new_f[o] = ts, f[pick] if imp else f0[o]
            improved[o], full_step[o] = imp, imp and pick == 0
            new_params[o] = params[o] + F32(ts) * delta[o]
        for start in range(rank * SLOTS, P, STEP_BLOCKS * SLOTS):
            i = slice(start, min(P, start + SLOTS))
            new_s[o, i] = s[o, i] + F32(ts) * u[o, i]
    return t_step, new_params, new_s, new_f, improved, full_step


def _tail_kernel_replay(data_sc, new_params, new_s, new_f, improved, full_step, mu, f0,
                        decrement, alpha, kmask, scales, reverse=False):
    """``lane_step_tail_kernel`` in its return mode, block by block: each
    block sums the regularizer (``reg_sums``: ``reverse`` takes the slots
    in another order) and picks the scale; rank 0 writes params and the
    scalars, every block its runs of the surface. Also returns the sums."""
    B, n = new_params.shape
    P, S, K = new_s.shape[1], len(scales), n - 6
    eps, sq_eps = F32(EPSILON), F32(math.sqrt(EPSILON))
    tol, mu_min, mu_max, mu_small = (F32(v) for v in (TOL, solver.MU_MIN, solver.MU_MAX, 1e-4))
    out_params, out_s = np.empty_like(new_params), np.empty_like(new_s)
    out_f, out_mu, out_conv = np.empty(B, F32), np.empty(B, F32), np.empty(B, bool)
    sums = np.zeros((B, S), F32)
    for block in range(B * STEP_BLOCKS):
        o, rank = divmod(block, STEP_BLOCKS)
        f = data_sc[o].copy()
        if K > 0:
            for k in range(S):
                xi = new_params[o, 6:] * scales[k]
                terms = kmask[o] * (np.sqrt(xi * xi + eps) - sq_eps)
                sums[o, k] = _slot_sum(terms, reverse)
                f[k] = F32(f[k] + _clamp(F32(alpha[o] * sums[o, k]), lo=F32(0)))
        pick = _aten_argmin(f)
        boost = f[pick] < new_f[o] and np.isfinite(f[pick])
        c = scales[pick] if boost else F32(1)
        if rank == 0:
            out_params[o] = new_params[o] * c
            out_f[o] = f[pick] if boost else new_f[o]
            m = mu[o]
            out_mu[o] = (_clamp(F32(m * F32(0.25)), lo=mu_min) if full_step[o]
                         else m if improved[o] else _clamp(F32(m * F32(8)), hi=mu_max))
            gain_tol = F32(F32(np.abs(f0[o]) + F32(1)) * tol)
            tiny = F32(f0[o] - out_f[o]) <= gain_tol
            out_conv[o] = ((F32(decrement[o] * F32(0.5)) <= gain_tol and m <= mu_small
                            and tiny) or (not improved[o] and m >= mu_max and tiny))
        for start in range(rank * SLOTS, P, STEP_BLOCKS * SLOTS):
            i = slice(start, min(P, start + SLOTS))
            out_s[o, i] = new_s[o, i] * c
    return (out_params, out_s, out_f, out_conv, out_mu), sums


def _tail_chain_replay(data_sc, new_params, new_s, new_f, improved, full_step, mu, f0,
                       decrement, alpha, kmask, scales):
    """The tail's op-by-op chain with float32 numpy ops as ATen's CUDA
    kernels round them and :func:`lane.lane_sum_in_kernel_order` for the
    (B, K, S) sums; also returns the sums."""
    B, n = new_params.shape
    S = len(scales)
    sums = np.zeros((B, S), F32)
    f_sc = data_sc
    if n > 6:
        xi = new_params[:, 6:, None] * scales                         # (B, K, S)
        terms = kmask[:, :, None] * (np.sqrt(xi * xi + F32(EPSILON)) - F32(math.sqrt(EPSILON)))
        sums = lane.lane_sum_in_kernel_order(
            terms.transpose(0, 2, 1).reshape(-1, n - 6)).reshape(B, S)
        prod = alpha[:, None] * sums
        f_sc = data_sc + np.where(np.isnan(prod), prod, np.maximum(prod, F32(0)))
    pick = np.array([_aten_argmin(v) for v in f_sc])
    f_pick = f_sc[np.arange(B), pick]
    with np.errstate(invalid='ignore'):
        boost = (f_pick < new_f) & np.isfinite(f_pick)
    c = np.where(boost, scales[pick], F32(1)).astype(F32)
    out_f = np.where(boost, f_pick, new_f)
    down = mu * F32(0.25)
    up = mu * F32(8)
    new_mu = np.where(full_step, np.where(np.isnan(down), down, np.maximum(down, F32(solver.MU_MIN))),
                      np.where(improved, mu, np.where(np.isnan(up), up,
                                                      np.minimum(up, F32(solver.MU_MAX)))))
    gain_tol = F32(TOL) * (F32(1) + np.abs(f0))
    tiny = (f0 - out_f) <= gain_tol
    conv = (((F32(0.5) * decrement <= gain_tol) & (mu <= F32(1e-4)) & tiny)
            | (~improved & (mu >= F32(solver.MU_MAX)) & tiny))
    return (new_params * c[:, None], new_s * c[:, None], out_f, conv, new_mu.astype(F32)), sums


def _np_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == bool or b.dtype == bool:
        return a.shape == b.shape and np.array_equal(a, b)
    a, b = a.astype(F32), b.astype(F32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _np_case(kind, B, variant):
    a = _tail_inputs(kind, B, variant)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in a.items()}


@pytest.mark.parametrize('variant', VARIANTS[:7])
@pytest.mark.parametrize('kind', ['cholesky', 'poly'])
def test_pick_schedule_keeps_every_bit(kind, variant):
    """(d) ``lane_step_pick``'s blocks (each recomputing its lane's pick:
    the first step that passes, else ATen's argmin) give bitwise the plain
    version's outputs on the CPU (the same elementwise ops), in every
    variant of the candidates."""
    a = _np_case(kind, 5, variant)
    got = _pick_kernel_replay(a['data_cand'], a['reg_cand'], a['armijo_f'], a['f0'],
                              _steps().numpy(), a['params'], a['delta'], a['s'], a['u'])
    plain = lane.step_pick_plain(*(None if v is None else torch.from_numpy(np.asarray(v))
                                   for v in (a['data_cand'], a['reg_cand'], a['armijo_f'],
                                             a['f0'], _steps().numpy(), a['params'],
                                             a['delta'], a['s'], a['u'])))
    for x, y in zip(got, plain):
        assert _np_equal(x, y.numpy())


@pytest.mark.parametrize('variant', ['as is', 'tied scale candidates',
                                     'scale candidate not finite', 'mu at MU_MIN',
                                     'mu at MU_MAX'])
@pytest.mark.parametrize('kind', ['cholesky', 'pcg', 'poly'])
def test_tail_schedule_keeps_every_bit(kind, variant, _kind):
    """(d) ``lane_step_tail``'s blocks (each with the scale sweep's
    regularizer sums over 256 slots and their trees, and ATen's argmin)
    give bitwise the chain replayed with float32 numpy ops and
    :func:`lane.lane_sum_in_kernel_order`; its sums are that order's, and
    at n = 6 (no sum) every output is the plain version's bitwise. The
    same schedule with each sum's slots in another order gives other bits
    of a sum where a slot adds more than one term."""
    a = _np_case(kind, 5, variant)
    pick = _pick_kernel_replay(a['data_cand'], a['reg_cand'], a['armijo_f'], a['f0'],
                               _steps().numpy(), a['params'], a['delta'], a['s'], a['u'])
    args = (a['data_sc'], *pick[1:], a['mu'], a['f0'], a['decrement'], a['alpha'],
            a['kmask'], _scales().numpy())
    got, sums = _tail_kernel_replay(*args)
    want, want_sums = _tail_chain_replay(*args)
    assert _np_equal(sums, want_sums)
    for x, y in zip(got, want):
        assert _np_equal(x, y)
    plain = lane.step_tail_plain(*(torch.from_numpy(np.asarray(v)) for v in args[:10]),
                                 EPSILON, torch.from_numpy(a['kmask']), _scales(), TOL,
                                 solver.MU_MIN, solver.MU_MAX)
    for x, y in zip(got, plain):
        if KINDS[kind][0] == 6 or y.dtype == torch.bool:
            assert _np_equal(x, y.numpy())
        else:   # the CPU's sums
            np.testing.assert_allclose(x, y.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('K', [300, 1018])
def test_reg_sums_order(K):
    """(d) The scale sweep's regularizer sums at K > 256 (a slot adds two
    or more terms): the kernel's schedule bitwise
    :func:`lane.lane_sum_in_kernel_order`, and a replay with the slots in
    another order gives other bits in some sum. The terms mix magnitudes
    (every 97th xi of 3e6), so a partial sum that holds a large one loses
    the small ones' fractions, how many depending on the order."""
    rng = np.random.RandomState(K)
    B, n = 3, 6 + K
    new_params = (rng.uniform(0.1, 1.0, (B, n)) * np.sign(rng.randn(B, n))).astype(F32)
    new_params[:, 6::97] *= F32(3e6)
    kmask = (rng.rand(B, K) < 0.9).astype(F32)
    scales = _scales().numpy()
    z = np.zeros(B, F32)
    args = (np.zeros((B, 8), F32), new_params, np.zeros((B, 4), F32), z, z > 0, z > 0, z + 1,
            z, z, np.ones(B, F32), kmask, scales)
    _, sums = _tail_kernel_replay(*args)
    _, want = _tail_chain_replay(*args)
    assert _np_equal(sums, want)
    _, other = _tail_kernel_replay(*args, reverse=True)
    assert not _np_equal(other, want)


# (e) the solvers bitwise as they were


def _former_solve_batch_impl(params0, Q, G, yv, w, alpha, epsilon, kmask, maxiter, tol):
    """``solver._solve_batch_impl`` as it ran on the CPU (an eager loop,
    the convergence read every ``SYNC_EVERY`` iterations), with the former
    step and freeze writes."""
    B = params0.shape[0]
    Bf = solver._features(Q, G)
    params = params0.clone()
    s = lane.matvec(Bf, params0)
    fval = solver._energy_from_surface(s, params0[:, 6:], yv, w, alpha, epsilon, kmask)
    conv = torch.zeros(B, dtype=torch.bool)
    mu = torch.full((B,), 1e-6, dtype=params0.dtype)
    it_lane = torch.zeros(B, dtype=torch.int32)
    it_dev = torch.zeros((), dtype=torch.int32)
    it = 0
    while it < maxiter and B > 0:
        for _ in range(min(solver.SYNC_EVERY, maxiter - it)):
            g_b, H_b = gram.grad_hess_plain(Bf, s, yv, w, passes=gram.GRAM_PASSES)
            out = _former_newton_step(params, mu, s, fval, g_b, H_b, Bf, yv, w, alpha, epsilon,
                                      kmask, tol)
            it_dev.add_(1)
            _former_freeze(params, s, fval, mu, it_lane, it_dev, conv, out)
        it += min(solver.SYNC_EVERY, maxiter - it)
        if bool(conv.all()):
            break
    s_final = lane.matvec(Bf, params)
    f_final = solver._energy_from_surface(s_final, params[:, 6:], yv, w, alpha, epsilon, kmask)
    return params, f_final, conv, it_lane.max(), s_final, it_lane


def _former_reg_value(xi, alpha, epsilon, kmask):
    term2 = torch.sqrt(xi * xi + epsilon)
    return (alpha[:, None] * lane.lane_sum(kmask[:, :, None] * (term2 - math.sqrt(epsilon)), 1)
            ).clamp_min(0.0)


def _former_newton_row(params0, shards, alpha, epsilon, kmask, maxiter, tol):
    """``parallel/newton._newton_row`` as it was."""
    home = shards[0].device
    B, n = params0.shape
    dt = params0.dtype
    eye = torch.eye(n, dtype=dt, device=home)
    steps = 0.5 ** torch.arange(solver.LS_STEPS, dtype=dt, device=home)
    ones = torch.ones((), dtype=dt, device=home)
    scales = torch.tensor(solver.SCALES, dtype=dt, device=home)

    def energy(params):
        data = newton._reduce([lane.softplus_energies(sh.surface(params), sh.yv, sh.w)
                               for sh in shards], home)
        return data + solver._reg_terms(params, alpha, epsilon, kmask)[0]

    params = params0
    conv = torch.zeros(B, dtype=torch.bool, device=home)
    mu = torch.full((B,), 1e-6, dtype=dt, device=home)
    it = 0
    while it < maxiter and not bool(conv.all()):
        active = (~conv).to(torch.int32)
        local = [sh.contribs(params, active) for sh in shards]
        f0 = newton._reduce([c[1] for c in local], home)
        g = newton._reduce([c[2] for c in local], home)
        H = newton._reduce([c[3] for c in local], home)
        reg, reg_g, reg_h = solver._reg_terms(params, alpha, epsilon, kmask)
        f0 = f0 + reg
        g = g + reg_g
        H = H + torch.diag_embed(reg_h)
        scale_h = lane.lane_sum(torch.diagonal(H, dim1=-2, dim2=-1)) / n + 1e-12
        direction = solver._cholesky_direction(H + (mu * scale_h)[:, None, None] * eye, g)
        delta, decrement, reg_cand, armijo_f = lane.step_guard(
            direction, g, params, alpha, epsilon, kmask, steps, f0, solver.ARMIJO_C)
        us = [sh.surface(delta) for sh in shards]
        data_cand = newton._reduce([sh.line_search(c[0], u, steps)
                                    for sh, c, u in zip(shards, local, us)], home)
        f_cand = data_cand + reg_cand if n > 6 else data_cand
        armijo = f_cand <= armijo_f
        pick = torch.where(armijo.any(dim=1), armijo.to(torch.int32).argmax(dim=1),
                           torch.argmin(f_cand, dim=1))
        f_pick = f_cand.gather(1, pick[:, None])[:, 0]
        improved = f_pick < f0
        t_step = torch.where(improved, steps[pick], torch.zeros((), dtype=dt, device=home))
        full_step = improved & (pick == 0)
        new_params = params + t_step[:, None] * delta
        new_f = torch.where(improved, f_pick, f0)
        data_sc = newton._reduce([sh.scale_sweep(c[0] + t_step.to(sh.device)[:, None] * u,
                                                 scales)
                                  for sh, c, u in zip(shards, local, us)], home)
        if n > 6:
            f_sc = data_sc + _former_reg_value(new_params[:, 6:, None] * scales,
                                               alpha, epsilon, kmask)
        else:
            f_sc = data_sc
        pick_sc = torch.argmin(f_sc, dim=1)
        f_sc_pick = f_sc.gather(1, pick_sc[:, None])[:, 0]
        boost = (f_sc_pick < new_f) & torch.isfinite(f_sc_pick)
        new_params = new_params * torch.where(boost, scales[pick_sc], ones)[:, None]
        new_f = torch.where(boost, f_sc_pick, new_f)
        new_mu = torch.where(full_step, (mu * 0.25).clamp_min(solver.MU_MIN),
                             torch.where(improved, mu,
                                         (mu * 8.0).clamp_max(solver.MU_MAX)))
        tiny_gain = (f0 - new_f) <= tol * (1.0 + f0.abs())
        new_conv = (((0.5 * decrement <= tol * (1.0 + f0.abs())) & (mu <= 1e-4)
                     & tiny_gain) | ((~improved) & (mu >= solver.MU_MAX) & tiny_gain))
        params = torch.where(conv[:, None], params, new_params)
        mu = torch.where(conv, mu, new_mu)
        conv = conv | new_conv
        it += 1
    return params, energy(params), conv


def _field(B=4, H=16, W=32, K=8):
    """Disks with noise on a 16x32 field, the DSM's subsample points and
    kmask (the last point of lane 1 padded)."""
    rng = np.random.RandomState(1)
    rr, cc = np.indices((H, W))
    pix = np.stack([rr, cc], -1).reshape(-1, 2).astype(np.float32)
    C = np.tile((pix / np.array([H - 1, W - 1], np.float32))[None], (B, 1, 1))
    Y = np.zeros((B, H * W), np.float32)
    for b in range(B):
        r0, c0 = rng.randint(4, 12), rng.randint(8, 24)
        Y[b] = ((((rr - r0) ** 2 + (cc - c0) ** 2) < 25).astype(np.float32) - 0.5).ravel()
        Y[b] += rng.randn(H * W).astype(np.float32) * 0.1
    sub = rng.randint(0, 16, (B, K, 2)).astype(np.float32)
    km = np.ones((B, K), np.float32)
    km[1, -1] = 0.0
    return (C, Y, np.ones((B, H * W), np.float32), np.tile(pix[None], (B, 1, 1)), sub, km)


@pytest.mark.parametrize('kind', ['poly', 'dsm'])
def test_solve_batch_impl_is_its_former_body(kind):
    """(e) ``solver._solve_batch_impl`` (its step's tail and freeze writes
    now ``lane.step_pick`` and ``lane.step_tail``) bitwise a copy of its
    former body on the CPU: params, energies, flags, iterations, surfaces
    and the lanes' iterations."""
    C, Y, Wt, pix, sub, km = (torch.from_numpy(a) for a in _field())
    B = C.shape[0]
    Q = solver._poly_basis(C)
    if kind == 'poly':
        G, kmask, alpha, eps = None, torch.zeros((B, 0)), torch.zeros(B), 1.0
        params0 = solver._lsq_init(Q, Y, Wt)
    else:
        G = build_smooth_matrix(pix, sub, 3.0, 12, km)
        kmask, alpha, eps = km, torch.full((B,), 0.1), EPSILON
        params0 = torch.cat([solver._lsq_init(Q, Y, Wt), torch.zeros((B, km.shape[1]))], 1)
    args = (params0, Q, G, Y, Wt, alpha, eps, kmask, 30, TOL)
    got = solver._solve_batch_impl(*args)
    want = _former_solve_batch_impl(*args)
    assert int(want[3]) > 1
    for x, y in zip(got, want):
        assert _bits_equal(x, y)


@pytest.mark.parametrize('kind', ['poly', 'dsm'])
def test_sharded_solver_is_its_former_body(kind, monkeypatch):
    """(e) The sharded solvers on a (1, 2) mesh bitwise what they give with
    ``_newton_row`` as it was (kept in this file): its tail now
    ``solver._step_tail``, its freeze in place."""
    C, Y, Wt, pix, sub, km = _field()
    mesh = pm.make_mesh(1, 2, ['cpu'] * 2)
    if kind == 'poly':
        solve = newton.make_sharded_poly_solver(mesh)
        args = (np.zeros((4, 6), np.float32), C, Y, Wt)
    else:
        solve = newton.make_sharded_dsm_solver(mesh, sigma=3.0, cutoff=12)
        args = (np.zeros((4, 14), np.float32), C, pix, sub, km, Y, Wt,
                np.full(4, 0.1, np.float32))
    p0 = args[0].copy()
    out = solve(*args)
    assert np.array_equal(args[0], p0)      # the caller's params0 untouched
    monkeypatch.setattr(newton, '_newton_row', _former_newton_row)
    for x, y in zip(out, solve(*args)):
        assert _bits_equal(x.float(), y.float())
