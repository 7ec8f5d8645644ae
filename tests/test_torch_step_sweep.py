"""The Newton loop's step after the line search's sums as one route, on the CPU.

Given the loop's state, ``solver._newton_step`` hands the line search's
pick, the scale sweep's data energies over the new surface and the rest
of the step with the freeze writes to :func:`lane.step_sweep`: on the card
one kernel (``lane_step_sweep`` in ``superdsm_tpu_torch/csrc/lane_ops.cu``,
a mode of the softplus sums whose prologue is the pick and whose lanes'
last clusters run the tail), on the CPU its plain version
:func:`lane.step_sweep_plain`, which must be exactly the chain the loop
ran before (``step_pick_plain``, the sweep's ``softplus_energies``,
``step_tail_plain`` given the state), so that every CPU result stays
bitwise what it was. Here:

- (a) the plain version (and the entry point, which launches nothing on
  the CPU) bitwise a copy of the former expressions and freeze writes
  (``tests/test_torch_step_tail.py``'s), on a Cholesky lane, a PCG lane and
  a polynomial lane at B = 1, 2 and 5, the last lane holding one of: no
  passing step, a NaN candidate, +inf candidates, a -inf candidate, NaN or
  -inf scale candidates, a full step at ``MU_MIN``, mu at ``MU_MAX``, a
  lane that converges, a lane already converged; lane 0 of B >= 2 is
  converged too, with a NaN of its own payload and -0 in its params and
  surface, which stay to the bit;
- (b) the loop's step and ``solver._solve_batch_impl`` take the route: one
  ``step_sweep`` a step and no ``step_pick`` or ``step_tail``, the solve's
  scratch in its state (and return mode the two calls), each bitwise its
  former body;
- (c) one loop iteration through the route against the JAX package's
  ``_newton_step`` (``superdsm_tpu/dsm/solver.py:181-289``) and its loop
  body's freeze (``:370-376``), run by JAX on the CPU on the same numpy
  inputs: params, surface and energy to rtol 1e-5 / atol 1e-6, the flags,
  mu and the lanes' iterations exactly;
- (d) the kernel's schedule replayed in numpy with its own index
  arithmetic (each block's pick in warp 0: the Armijo ballot, ATen's
  argmin over shuffled candidates; tiles of ceil(S / k) scales at 1, 2 and
  4 tiles a lane; blocks of 512 threads, their chain steps in groups of
  16, at B = 5, 16, 32 and 64; each output's regularizer sum in
  its owner block beside its data sum; the outputs arriving in order,
  reversed and shuffled; the
  tail in the cluster whose owner counted the lane's last output; the
  arrival counters back at 0): bitwise the chain replayed with float32
  numpy ops and :func:`lane.lane_sum_in_kernel_order`.

The kernel itself is held bitwise to the three launches and to this plain
version on the card by ``tests/test_torch_kernel_cuda.py`` and
``chip_smoke.py`` phase 3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdsm_tpu.dsm import solver as jsolver

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import lane, solver
from superdsm_tpu_torch.dsm.smooth import build_smooth_matrix
from tests.test_torch_step_tail import (EPSILON, F32, KINDS, PCG_CUTOVER, TOL,
                                        _aten_argmin, _bits_equal, _clamp, _direction,
                                        _field, _former_freeze, _former_newton_step,
                                        _former_pick, _former_solve_batch_impl,
                                        _former_tail, _inputs, _np_equal, _scales,
                                        _slot_sum, _steps, _tail_chain_replay, SLOTS, WARP)

torch.set_num_threads(1)

VARIANTS = ['as is', 'no passing step', 'NaN candidate', '+inf candidates',
            '-inf candidate', 'NaN scale candidates', '-inf scale candidates',
            'full step at MU_MIN', 'mu at MU_MAX', 'converging lane', 'converged lane']
#: The state's tensors, in :class:`lane.FreezeState`'s order, and mu.
STATE = ('params', 's', 'f0', 'it_lane', 'it_dev', 'conv')
#: csrc/lane_ops.cu: blocks of a cluster, threads of a softplus block.
CLUSTER, SP_THREADS = 8, 512


@pytest.fixture(autouse=True)
def _cpu_device():
    with T.use_device('cpu'):
        yield


@pytest.fixture
def _kind(monkeypatch):
    monkeypatch.setattr(solver, 'CHOLESKY_MAX_N', PCG_CUTOVER)
    monkeypatch.setattr(jsolver, 'CHOLESKY_MAX_N', PCG_CUTOVER)


def _sweep_inputs(kind, B, variant, seed=0, P=256):
    """One loop step's inputs after the line search's sums (the solver's
    own up to there) at P pixels a lane, the variant in the last lane, and
    the loop's state: conv set in lane 0 of B >= 2 (and in the last lane
    for 'converged lane'), whose params and surface hold a NaN of its own
    payload and a -0; it_dev 7."""
    n, _ = KINDS[kind]
    a = {k: torch.from_numpy(np.array(v)) for k, v in _inputs(n, B, seed, P).items()}
    g, Hd = lane.lm_system(a['params'], a['mu'], a['alpha'], EPSILON, a['kmask'], a['g'],
                           a['H'])
    direction, negate = _direction(kind, g, Hd)
    delta, decrement, reg_cand, armijo_f = lane.step_guard(
        direction, g, a['params'], a['alpha'], EPSILON, a['kmask'], _steps(), a['f0'],
        solver.ARMIJO_C, negate)
    u = lane.matvec(a['Bf'], delta)
    data_cand = lane.softplus_energies(a['s'], a['yv'], a['w'], _steps(), u)
    reg = reg_cand if reg_cand is not None else torch.zeros_like(data_cand)
    f0, mu, yv, w = a['f0'], a['mu'], a['yv'], a['w']
    if variant == 'no passing step':
        data_cand[-1] = armijo_f[-1] + 1.0 + torch.arange(12.0)
    elif variant == 'NaN candidate':
        data_cand[-1] = f0[-1] + 5.0 - reg[-1]
        data_cand[-1, 5] = float('nan')
    elif variant == '+inf candidates':
        data_cand[-1] = float('inf')
    elif variant == '-inf candidate':
        data_cand[-1] = f0[-1] + 5.0 - reg[-1]
        data_cand[-1, 7] = float('-inf')
    elif variant == 'NaN scale candidates':
        yv[-1, 3] = float('nan')
    elif variant == '-inf scale candidates':
        w[-1, 3] = float('-inf')
    elif variant == 'full step at MU_MIN':
        data_cand[-1, 0] = armijo_f[-1, 0] - 1.0 - reg[-1, 0]
        mu[-1] = solver.MU_MIN
    elif variant == 'mu at MU_MAX':
        mu[-1] = solver.MU_MAX
    elif variant == 'converging lane':
        # no data term, no step and no boost at a zero decrement and small mu
        w[-1] = 0.0
        f0[-1] = armijo_f[-1] = decrement[-1] = 0.0
        data_cand[-1] = 5.0
        mu[-1] = 1e-5
    conv = torch.zeros(B, dtype=torch.bool)
    conv[0] = B >= 2
    conv[-1] |= variant == 'converged lane'
    params, s = a['params'].clone(), a['s'].clone()
    odd = torch.from_numpy(np.array([np.uint32(0x7fc01234).view(np.float32), -0.0], F32))
    params[conv, :2] = odd
    s[conv, :2] = odd
    return dict(a, params=params, s=s, data_cand=data_cand, reg_cand=reg_cand,
                armijo_f=armijo_f, delta=delta, decrement=decrement, u=u, conv=conv,
                it_lane=torch.arange(B, dtype=torch.int32), it_dev=torch.tensor(7, dtype=torch.int32))


def _state(a):
    """Copies of the loop's state tensors and mu."""
    return {k: a[k].clone() for k in STATE + ('mu',)}


def _freeze_state(st):
    return lane.FreezeState(st['params'], st['s'], st['f0'], st['it_lane'], st['it_dev'],
                            st['conv'])


def _sweep_args(a, st):
    return (a['data_cand'], a['reg_cand'], a['armijo_f'], _steps(), a['delta'], a['u'],
            a['yv'], a['w'], st['mu'], a['decrement'], a['alpha'], EPSILON, a['kmask'],
            _scales(), TOL, solver.MU_MIN, solver.MU_MAX, _freeze_state(st))


def _former_loop_step(a, st):
    """The loop's former step after the line search's sums on the state
    ``st``: the pick, the sweep's sums, the tail and the freeze writes."""
    pick = _former_pick(a['data_cand'], a['reg_cand'], a['armijo_f'], st['f0'], _steps(),
                        st['params'], a['delta'], st['s'], a['u'])
    data_sc = lane.softplus_energies(pick[2], a['yv'], a['w'], _scales())
    out = _former_tail(data_sc, *pick[1:], st['mu'], st['f0'], a['decrement'], a['alpha'],
                       EPSILON, a['kmask'], _scales(), TOL)
    _former_freeze(st['params'], st['s'], st['f0'], st['mu'], st['it_lane'], st['it_dev'],
                   st['conv'], out)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('B', [1, 2, 5])
@pytest.mark.parametrize('kind', list(KINDS))
def test_plain_version_is_the_former_chain(kind, B, variant, _kind):
    """(a) ``step_sweep_plain`` and ``step_sweep`` (no launch on the CPU)
    write bitwise the state the former pick, sweep, tail and freeze
    writes gave, in every variant; a converged lane's state stays to the
    bit; the converging lane converges at this iteration, and a full step
    at ``MU_MIN`` keeps mu there."""
    a = _sweep_inputs(kind, B, variant)
    want = _state(a)
    _former_loop_step(a, want)
    lane.reset_launch_counts()
    for fn in (lane.step_sweep_plain, lane.step_sweep):
        st = _state(a)
        assert fn(*_sweep_args(a, st)) is None
        for k in STATE + ('mu',):
            assert _bits_equal(st[k], want[k]), k
    assert not any(lane.LAUNCHES.values())
    for k in ('params', 's', 'f0', 'mu', 'it_lane'):
        assert _bits_equal(want[k][a['conv']], a[k][a['conv']])
    if variant == 'converging lane':
        assert bool(want['conv'][-1]) and int(want['it_lane'][-1]) == 7
    if variant == 'full step at MU_MIN':
        assert float(want['mu'][-1]) == np.float32(solver.MU_MIN)
        assert not bool(want['conv'][-1])


class _Spy:
    """Counts the calls of ``lane``'s step functions while it is active."""

    def __init__(self, monkeypatch, names=('step_sweep', 'step_pick', 'step_tail')):
        self.calls = {name: [] for name in names}
        for name in names:
            original = getattr(lane, name)

            def spy(*args, _name=name, _fn=original):
                self.calls[_name].append(args)
                return _fn(*args)
            monkeypatch.setattr(lane, name, spy)

    def counts(self):
        return {k: len(v) for k, v in self.calls.items()}


@pytest.mark.parametrize('B', [1, 5])
@pytest.mark.parametrize('kind', list(KINDS))
def test_loop_step_takes_the_fused_route(kind, B, _kind, monkeypatch):
    """(b) ``solver._newton_step`` given the loop's state makes one
    ``step_sweep`` call and no ``step_pick`` or ``step_tail`` call, and
    writes bitwise the former step followed by the former freeze; without a
    state it makes the two calls and returns the former step's outputs."""
    n, _ = KINDS[kind]
    a = {k: torch.from_numpy(np.array(v)) for k, v in _inputs(n, B, seed=9).items()}
    args = (a['g'], a['H'], a['Bf'], a['yv'], a['w'], a['alpha'], EPSILON, a['kmask'], TOL)
    conv = torch.arange(B) % 2 == 1
    it_dev = torch.tensor(4, dtype=torch.int32)
    former = [a[k].clone() for k in ('params', 's', 'f0', 'mu')]
    former_it, former_conv = torch.zeros(B, dtype=torch.int32), conv.clone()
    out = _former_newton_step(former[0], former[3], former[1], former[2], *args)
    _former_freeze(*former, former_it, it_dev, former_conv, out)
    spy = _Spy(monkeypatch)
    st = [a[k].clone() for k in ('params', 's', 'f0', 'mu')]
    it_lane, c = torch.zeros(B, dtype=torch.int32), conv.clone()
    assert solver._newton_step(st[0], st[3], st[1], st[2], *args, state=lane.FreezeState(
        st[0], st[1], st[2], it_lane, it_dev, c)) is None
    assert spy.counts() == {'step_sweep': 1, 'step_pick': 0, 'step_tail': 0}
    for x, y in zip(st + [it_lane, c], former + [former_it, former_conv]):
        assert _bits_equal(x, y)
    got = solver._newton_step(a['params'], a['mu'], a['s'], a['f0'], *args)
    assert spy.counts() == {'step_sweep': 1, 'step_pick': 1, 'step_tail': 1}
    want = _former_newton_step(a['params'], a['mu'], a['s'], a['f0'], *args)
    assert all(_bits_equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize('kind', ['poly', 'dsm'])
def test_solve_batch_impl_takes_the_fused_route(kind, monkeypatch):
    """(b) ``solver._solve_batch_impl`` steps through ``step_sweep`` once
    an iteration, with the solve's scratch (arrivals (B,) int32 at 0, sums
    (B, 8)) in its state, and never through ``step_pick`` or
    ``step_tail``; bitwise its former body."""
    C, Y, Wt, pix, sub, km = (torch.from_numpy(v) for v in _field())
    B = C.shape[0]
    Q = solver._poly_basis(C)
    if kind == 'poly':
        G, kmask, alpha, eps = None, torch.zeros((B, 0)), torch.zeros(B), 1.0
        params0 = solver._lsq_init(Q, Y, Wt)
    else:
        G = build_smooth_matrix(pix, sub, 3.0, 12, km)
        kmask, alpha, eps = km, torch.full((B,), 0.1), EPSILON
        params0 = torch.cat([solver._lsq_init(Q, Y, Wt), torch.zeros((B, km.shape[1]))], 1)
    args = (params0, Q, G, Y, Wt, alpha, eps, kmask, 25, TOL)
    want = _former_solve_batch_impl(*args)
    spy = _Spy(monkeypatch)
    solver.reset_loop_stats()
    got = solver._solve_batch_impl(*args)
    for x, y in zip(got, want):
        assert _bits_equal(x, y)
    counts = spy.counts()
    assert counts['step_pick'] == counts['step_tail'] == 0
    assert counts['step_sweep'] == solver.LOOP_STATS['iterations'] > 1
    scratch = spy.calls['step_sweep'][0][-1].scratch
    assert scratch.arrivals.dtype == torch.int32 and tuple(scratch.arrivals.shape) == (B,)
    assert not scratch.arrivals.any()
    assert tuple(scratch.sums.shape) == (B, len(solver.SCALES))
    assert all(call[-1].scratch is scratch for call in spy.calls['step_sweep'])


@pytest.mark.parametrize('kind', list(KINDS))
def test_iteration_through_the_route_matches_the_jax_package(kind, _kind, monkeypatch):
    """(c) One loop iteration through ``step_sweep`` (the step given the
    loop's state; lanes 1 and 4 already converged) against the JAX
    package's vmapped ``_newton_step`` and its loop body's freeze on the
    same inputs: params, surface and energy to rtol 1e-5 / atol 1e-6 (its
    float32 sums take another order), mu, the flags and the lanes'
    iterations exactly."""
    n, _ = KINDS[kind]
    B = 5
    a = _inputs(n, B, seed=11)
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    step = jax.vmap(jsolver._newton_step,
                    in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None, 0, None))
    ref = step(*(jnp.asarray(a[k]) for k in ('params', 'mu', 's', 'f0', 'g', 'H', 'Bf',
                                             'yv', 'w', 'alpha')),
               EPSILON, jnp.asarray(a['kmask']), TOL)
    conv0 = np.array([False, True, False, False, True])
    it = 6
    new_params, new_s, new_f, new_conv, new_mu = ref
    cj = jnp.asarray(conv0)
    want = dict(params=jnp.where(cj[:, None], a['params'], new_params),
                s=jnp.where(cj[:, None], a['s'], new_s),
                f0=jnp.where(cj, a['f0'], new_f), mu=jnp.where(cj, a['mu'], new_mu),
                it_lane=jnp.where(cj, jnp.zeros(B, jnp.int32), it + 1), conv=cj | new_conv)
    spy = _Spy(monkeypatch)
    st = {k: t[k].clone() for k in ('params', 's', 'f0', 'mu')}
    st['it_lane'] = torch.zeros(B, dtype=torch.int32)
    st['conv'] = torch.from_numpy(conv0.copy())
    it_dev = torch.tensor(it + 1, dtype=torch.int32)
    solver._newton_step(st['params'], st['mu'], st['s'], st['f0'], t['g'], t['H'], t['Bf'],
                        t['yv'], t['w'], t['alpha'], EPSILON, t['kmask'], TOL,
                        state=lane.FreezeState(st['params'], st['s'], st['f0'], st['it_lane'],
                                               it_dev, st['conv']))
    assert spy.counts() == {'step_sweep': 1, 'step_pick': 0, 'step_tail': 0}
    for k in ('params', 's', 'f0'):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ('mu', 'it_lane', 'conv'):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(want[k]), err_msg=k)


# (d) the kernel's schedule replayed in numpy


def _softplus(x):
    with np.errstate(invalid='ignore'):  # NaN in, NaN out
        return np.logaddexp(x, F32(0)).astype(F32)


def _np_inputs(kind, B, variant, P=256):
    a = _sweep_inputs(kind, B, variant, P=P)
    return {k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v) for k, v in a.items()}


def _np_freeze(a, out):
    """The former freeze writes in numpy: the new state."""
    conv = a['conv']
    keep = conv[:, None]
    new_params, new_s, new_f, new_conv, new_mu = out
    return dict(params=np.where(keep, a['params'], new_params),
                s=np.where(keep, a['s'], new_s), f0=np.where(conv, a['f0'], new_f),
                mu=np.where(conv, a['mu'], new_mu),
                it_lane=np.where(conv, a['it_lane'], a['it_dev']).astype(np.int32),
                conv=conv | new_conv)


def _sweep_chain_replay(a):
    """The three launches' chain with float32 numpy ops: the plain pick,
    the sweep's terms summed by :func:`lane.lane_sum_in_kernel_order`, the
    tail's chain, the freeze writes."""
    t = lambda v: None if v is None else torch.from_numpy(np.asarray(v))
    _, new_params, new_s, new_f, improved, full_step = (
        v.numpy() for v in lane.step_pick_plain(
            t(a['data_cand']), t(a['reg_cand']), t(a['armijo_f']), t(a['f0']), _steps(),
            t(a['params']), t(a['delta']), t(a['s']), t(a['u'])))
    scales = _scales().numpy()
    B, P = new_s.shape
    terms = a['w'][:, :, None] * _softplus((-(a['yv'] * new_s))[:, :, None] * scales)
    data_sc = lane.lane_sum_in_kernel_order(
        terms.transpose(0, 2, 1).reshape(-1, P)).reshape(B, len(scales))
    out, _ = _tail_chain_replay(data_sc, new_params, new_s, new_f, improved, full_step,
                                a['mu'], a['f0'], a['decrement'], a['alpha'], a['kmask'],
                                scales)
    return _np_freeze(a, out)


def _warp_argmin(v, S):
    """``warp_argmin`` replayed: lane l of 32 holds v[l] (l < S) or no
    candidate; five butterfly steps, each lane taking its partner's
    (value, lane) if it comes first (a NaN before any number, then the
    value, then the lane); every lane must end with the same lane."""
    vals = [F32(v[l]) if l < S else F32(0) for l in range(32)]
    idx = [l if l < S else 32 for l in range(32)]
    m = 16
    while m:
        new_vals, new_idx = vals[:], idx[:]
        for l in range(32):
            ov, oi, cv, ci = vals[l ^ m], idx[l ^ m], vals[l], idx[l]
            if oi >= 32 or ci >= 32:
                other = oi < ci
            elif np.isnan(ov) != np.isnan(cv):
                other = bool(np.isnan(ov))
            elif not np.isnan(cv) and ov != cv:
                other = bool(ov < cv)
            else:
                other = oi < ci
            if other:
                new_vals[l], new_idx[l] = ov, oi
        vals, idx = new_vals, new_idx
        m //= 2
    assert len(set(idx)) == 1
    return idx[0]


def _warp_pick(a, o):
    """``pick_of``: lane k < S holds candidate k, the Armijo test a ballot
    (its lowest set bit), else :func:`_warp_argmin`."""
    S = a['data_cand'].shape[1]
    f = a['data_cand'][o] + a['reg_cand'][o] if a['reg_cand'] is not None \
        else a['data_cand'][o].copy()
    with np.errstate(invalid='ignore'):
        ballot = [k for k in range(S) if f[k] <= a['armijo_f'][o, k]]
    pick = ballot[0] if ballot else _warp_argmin(f, S)
    improved = f[pick] < a['f0'][o]
    return (_steps().numpy()[pick] if improved else F32(0), f[pick] if improved else a['f0'][o],
            improved, improved and pick == 0)


def _layout_sum(terms):
    """One output's data sum as a cluster of 8 blocks of 512 threads
    makes it (``softplus_pixel_sums``): block q holds slots 32 q .. 32 q +
    31; group g of its chain steps is 16 steps, warp w building chain step
    16 g + w (the pixel (16 g + w) 256 + 32 q + l, or 0 past the chain or
    P) into the group buffer, the
    output's warp adding the group's steps in turn into each slot; each
    slot pushed to the owner, whose warp runs the tree: slots t + 128, +
    64, + 32, then shuffles down by 16, ..., 1."""
    group = SP_THREADS // WARP
    P = len(terms)
    chain = -(-P // SLOTS)
    groups = -(-chain // group)
    padded = np.zeros(groups * group * SLOTS, F32)
    padded[:P] = terms
    slots = np.zeros(SLOTS, F32)
    for q in range(CLUSTER):
        lanes = slice(WARP * q, WARP * (q + 1))
        acc = np.zeros(WARP, F32)
        for g in range(groups):
            buf = [padded[(g * group + w) * SLOTS:][lanes] for w in range(group)]
            for w in range(group):
                acc = (acc + buf[w]).astype(F32)
        slots[lanes] = acc  # pushed to the owner
    v = slots.reshape(CLUSTER, WARP)
    for m in (4, 2, 1):
        v = (v[:m] + v[m:2 * m]).astype(F32)
    x = v[0]
    for m in (16, 8, 4, 2, 1):
        x = (x + np.concatenate([x[m:], np.zeros(m, F32)])).astype(F32)
    return x[0]


def _sweep_kernel_replay(a, tiles, order):
    """``lane_step_sweep_kernel`` cluster by cluster, in ``order`` ('in
    order', 'reversed', 'shuffled'; within a cluster its owners' outputs
    in order, reversed or shuffled too), its blocks' data sums as
    :func:`_layout_sum` makes them:
    tiles of kb = ceil(S / tiles) scales (k_tiles = ceil(S / kb) clusters a
    lane); each cluster's blocks recompute the pick and read conv (a
    converged lane's clusters leave); then the blocks' data sums, each
    output's tree in its owner (block kl % 8), which makes the output's
    regularizer sum after pushing its own slots and adds it; at one tile
    a lane each energy is pushed into the
    cluster's blocks (their mbarriers, no count: the cluster is the lane's
    last), else stored in the scratch and an arrival counted, and the owner
    that brings the lane's count to S sets it back to 0 and flags its
    cluster, which runs the tail: every block's scale pick from the
    energies, block r's runs of 512 surface entries, block 0's
    params and scalars. Returns the state, the counters and the tails run
    a lane."""
    st = {k: a[k].copy() for k in ('params', 's', 'f0', 'mu', 'it_lane', 'conv')}
    B, n = st['params'].shape
    P, K = st['s'].shape[1], n - 6
    scales = _scales().numpy()
    SC = len(scales)
    kb = -(-SC // tiles)
    k_tiles = -(-SC // kb)
    assert kb <= SP_THREADS // WARP  # a warp adds one output's slots
    eps, sq_eps = F32(EPSILON), F32(math.sqrt(EPSILON))
    tol, mu_min, mu_max, mu_small = (F32(v) for v in (TOL, solver.MU_MIN, solver.MU_MAX, 1e-4))
    arrivals, tails = np.zeros(B, np.int32), np.zeros(B, np.int32)
    sums = np.full((B, SC), np.nan, F32)
    clusters = [(o, tile) for o in range(B) for tile in range(k_tiles)]
    rng = np.random.RandomState(3)
    if order == 'reversed':
        clusters = clusters[::-1]
    elif order == 'shuffled':
        clusters = [clusters[i] for i in rng.permutation(len(clusters))]
    for o, tile in clusters:
        if st['conv'][o]:  # every block reads it beside its pick
            continue
        ts, new_f, improved, full_step = _warp_pick(a, o)
        k0 = tile * kb
        outputs = list(range(min(kb, SC - k0)))
        data = {}  # the blocks' slots, pushed to the owners
        ns = st['s'][o] + F32(ts) * a['u'][o]
        ys = -(a['yv'][o] * ns)
        if order == 'reversed':
            outputs = outputs[::-1]
        elif order == 'shuffled':
            outputs = [outputs[i] for i in rng.permutation(len(outputs))]
        for kl in outputs:
            data[kl] = _layout_sum(a['w'][o] * _softplus(ys * scales[k0 + kl]))
        last = False
        for kl in outputs:  # in block kl % 8, its regularizer sum while the slots arrive
            k = k0 + kl
            f = data[kl]
            if K > 0:
                xi = (st['params'][o, 6:] + F32(ts) * a['delta'][o, 6:]) * scales[k]
                terms = a['kmask'][o] * (np.sqrt(xi * xi + eps) - sq_eps)
                f = F32(f + _clamp(F32(a['alpha'][o] * _slot_sum(terms)), lo=F32(0)))
            sums[o, k] = f
            if k_tiles == 1:  # pushed to the cluster's blocks: it is the lane's last
                last = True
                continue
            arrivals[o] += 1
            if arrivals[o] == SC:
                arrivals[o] = 0
                last = True
        if not last:
            continue
        tails[o] += 1
        for rank in range(CLUSTER):
            f = sums[o].copy()
            pick = _warp_argmin(f, SC)
            boost = f[pick] < new_f and np.isfinite(f[pick])
            c = scales[pick] if boost else F32(1)
            for start in range(rank * SP_THREADS, P, CLUSTER * SP_THREADS):
                i = slice(start, min(P, start + SP_THREADS))
                st['s'][o, i] = ns[i] * c
            if rank == 0:
                f_new = f[pick] if boost else new_f
                m, f0 = st['mu'][o], st['f0'][o]
                mu_new = (_clamp(F32(m * F32(0.25)), lo=mu_min) if full_step
                          else m if improved else _clamp(F32(m * F32(8)), hi=mu_max))
                gain_tol = F32(F32(np.abs(f0) + F32(1)) * tol)
                tiny = F32(f0 - f_new) <= gain_tol
                conv = ((F32(a['decrement'][o] * F32(0.5)) <= gain_tol and m <= mu_small
                         and tiny) or (not improved and m >= mu_max and tiny))
                st['params'][o] = (st['params'][o] + F32(ts) * a['delta'][o]) * c
                st['f0'][o], st['mu'][o] = f_new, mu_new
                st['it_lane'][o], st['conv'][o] = a['it_dev'], conv
    return st, arrivals, tails


def _check_schedule(a, tiles, orders):
    """:func:`_sweep_kernel_replay` bitwise the chain of the three launches
    (:func:`_sweep_chain_replay`) in each order; each lane that was not
    converged runs its tail once and its counter ends at 0; a converged
    lane's state stays to the bit."""
    want = _sweep_chain_replay(a)
    for order in orders:
        got, arrivals, tails = _sweep_kernel_replay(a, tiles, order)
        assert not arrivals.any()
        assert np.array_equal(tails, (~a['conv']).astype(np.int32))
        for k in ('params', 's', 'f0', 'mu', 'it_lane', 'conv'):
            assert _np_equal(got[k], want[k]), (order, k)
    for k in ('params', 's', 'f0', 'mu', 'it_lane'):
        assert _np_equal(want[k][a['conv']], a[k][a['conv']])


@pytest.mark.parametrize('variant', ['as is', 'no passing step', 'NaN scale candidates',
                                     'full step at MU_MIN', 'converging lane'])
@pytest.mark.parametrize('tiles', [1, 2, 4])
@pytest.mark.parametrize('kind', list(KINDS))
def test_fused_schedule_keeps_every_bit(kind, tiles, variant, _kind):
    """(d) The fused launch's schedule at 1, 2 and 4 tiles a lane, its
    clusters arriving in order, reversed and shuffled: bitwise the chain of
    the three launches replayed in numpy; each lane that was not converged
    runs its tail once and its counter ends at 0; a converged lane's state
    stays to the bit."""
    a = _np_inputs(kind, 5, variant)
    _check_schedule(a, tiles, ('in order', 'reversed', 'shuffled'))


@pytest.mark.parametrize('B', [16, 32, 64])
@pytest.mark.parametrize('tiles', [1, 2, 4])
@pytest.mark.parametrize('kind', list(KINDS))
def test_fused_schedule_at_many_lanes_keeps_every_bit(kind, tiles, B, _kind):
    """(d) The layout of 16, 32 and 64 lanes (one tile a lane by the
    plan, and 2 and 4 forced) over P = 20 chain steps and a ragged end (2
    groups of a block's chain steps): bitwise the chain of the three
    launches."""
    a = _np_inputs(kind, B, 'full step at MU_MIN' if B == 32 else 'NaN scale candidates',
                   P=20 * SLOTS + 37)
    _check_schedule(a, tiles, ('in order', 'shuffled'))


@pytest.mark.parametrize('seed', range(4))
def test_warp_argmin_is_atens(seed):
    """(d) The butterfly of ``warp_argmin`` finds ATen's argmin (its first
    NaN, else its first least value, -0 tying +0) on vectors of 1 to 16
    candidates drawn from few values (ties), NaN and both infinities."""
    rng = np.random.RandomState(seed)
    pool = np.array([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0, np.inf, -np.inf, np.nan], F32)
    for _ in range(200):
        S = rng.randint(1, 17)
        v = pool[rng.randint(0, len(pool), S)]
        if rng.rand() < 0.3:
            v = (rng.randn(S) * 3).astype(F32)
        assert _warp_argmin(v, S) == _aten_argmin(v)
