"""The two ends of the Newton step around the direction solve, on the CPU.

:func:`lane.lm_system` assembles the damped Newton system (the
regularizer's gradient and Hessian diagonal, ``scale_h`` and the LM
damping) and :func:`lane.step_guard` guards the direction and computes
what the line search needs of it (the gradient fallback, the decrement, the
regularizer's candidates and the Armijo thresholds). On the card each is a
kernel of its own (``lane_lm_system``, ``lane_step_guard`` in
``superdsm_tpu_torch/csrc/lane_ops.cu``), and the solver runs both with the
direction between them as one launch (:func:`lane.newton_direction`: the
direction kernels' step variants, the damped system formed as they load H
and the guard run where they hold the direction); on the CPU each is its
plain version, which must be exactly the op-by-op expressions the solver
ran before, so that every CPU result stays bitwise what it was. Here:

- (a) the plain versions against a copy of those expressions (kept in this
  file), bitwise, on a Cholesky lane, a PCG lane (``CHOLESKY_MAX_N``
  monkeypatched below n) and a polynomial lane at B = 1, 2 and 5, with a
  NaN direction, an all-zero ``kmask``, an infinite ``mu scale_h`` and an
  infinite ``f0`` in the last lane;
- (b) the same functions against the JAX package's lines
  (``superdsm_tpu/dsm/solver.py:194-200`` and ``:208-227``, with its own
  ``_reg_terms``), and ``solver._newton_step`` against its
  ``_newton_step``, run by JAX on the CPU on the same numpy inputs, at
  rtol 1e-5 (float32 sums in another order);
- (c) each kernel's schedule replayed in numpy with its own index
  arithmetic (a block of 16 rows of one lane's Hd recomputing the lane's
  ``scale_h``; one block a lane for the guard, its sums over 256 slots and
  their trees): bitwise the chain it replaces replayed with float32 numpy
  ops as ATen's CUDA kernels round them (``x / n`` as ``x * (1 / n)``) and
  :func:`lane.lane_sum_in_kernel_order`; a replay with one sum's slots in
  another order gives other bits; and the direction kernels' prologue and
  epilogue replayed the same way (the trace in every block of a lane by
  64 to 512 threads, the damped entries in each route's load order, the
  guard on the direction as block 0 holds it, a failed lane's gradient
  step);
- (d) ``solver._newton_step`` bitwise a copy of its former body (through
  :func:`lane.newton_direction_plain`, at the DSM buckets' n too), and the
  sharded solvers (``parallel/newton._newton_row``) bitwise what they give
  with the guard written as the copied expressions.

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
from superdsm_tpu_torch.parallel import mesh as pm
from superdsm_tpu_torch.parallel import newton

torch.set_num_threads(1)

EPSILON = 1.0
#: Lane kinds: (n, direction); the PCG lane's n lies above the
#: ``CHOLESKY_MAX_N`` that :func:`_kind` sets.
KINDS = {'cholesky': (38, 'cholesky'), 'pcg': (70, 'pcg'), 'poly': (6, 'cholesky')}
PCG_CUTOVER = 64
VARIANTS = ['as is', 'NaN direction', 'zero kmask', 'infinite damping', 'infinite f0']


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


def _inputs(n, B, seed=0):
    """One Newton step's inputs at n = 6 + K as numpy float32: features Bf
    (B, P, n), params, labels, weights, kmask with some padded dimensions,
    alpha, the surface, f0 and the plain gram's g and H, mu of 1e-6 to
    1e-1 across the lanes."""
    rng = np.random.RandomState(seed + 10 * n + B)
    K, P = n - 6, 256
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


# the expressions the solver ran before lane.lm_system and lane.step_guard
# (superdsm_tpu_torch/dsm/solver.py's _reg_terms and _newton_step), op by op


def _former_reg_terms(params, alpha, epsilon, kmask):
    n = params.shape[-1]
    if n <= 6:
        z = torch.zeros_like(params)
        return torch.zeros(params.shape[:-1], dtype=params.dtype,
                           device=params.device), z, z
    xi = params[..., 6:]
    a = torch.as_tensor(alpha, dtype=params.dtype, device=params.device)[..., None]
    term2 = torch.sqrt(xi * xi + epsilon)
    val = (a[..., 0] * lane.lane_sum(kmask * (term2 - math.sqrt(epsilon)))).clamp_min(0.0)
    zeros6 = torch.zeros(params.shape[:-1] + (6,), dtype=params.dtype,
                         device=params.device)
    grad = torch.cat([zeros6, a * (xi / term2) * kmask], dim=-1)
    hdiag = a * (1.0 / term2 - (xi * xi) / (term2 ** 3))
    hdiag = torch.cat([zeros6, hdiag.clamp_min(0.0) * kmask + (1.0 - kmask)],
                      dim=-1)
    return val, grad, hdiag


def _former_lm_system(params, mu, alpha, epsilon, kmask, g, H):
    B, n = params.shape
    dt, dev = params.dtype, params.device
    if n > 6:
        _, reg_g, reg_h = _former_reg_terms(params, alpha, epsilon, kmask)
        g = (g + reg_g) * torch.cat(
            [torch.ones((B, 6), dtype=dt, device=dev), kmask], dim=1)
        H = H + torch.diag_embed(reg_h)
    scale_h = lane.lane_sum(torch.diagonal(H, dim1=-2, dim2=-1)) / n + 1e-12
    Hd = H + (mu * scale_h)[:, None, None] * torch.eye(n, dtype=dt, device=dev)
    return g, Hd


def _former_guard(direction, g, params, alpha, epsilon, kmask, steps, f0, armijo_c,
                  negate=False):
    """The former guard, decrement, regularizer candidates (clamped, as the
    former f_cand took them) and Armijo thresholds."""
    n = params.shape[1]
    delta = -direction if negate else direction
    bad = ~torch.isfinite(delta).all(dim=1)
    delta = torch.where(bad[:, None],
                        -g / (torch.sqrt(lane.lane_dot(g, g)) + 1.0)[:, None], delta)
    decrement = -lane.lane_dot(g, delta)
    reg = None
    if n > 6:
        xi_cand = params[:, 6:, None] + delta[:, 6:, None] * steps  # (B, K, S)
        term2c = torch.sqrt(xi_cand * xi_cand + epsilon)
        reg_cand = alpha[:, None] * lane.lane_sum(
            kmask[:, :, None] * (term2c - math.sqrt(epsilon)), 1)
        reg = reg_cand.clamp_min(0.0)
    return delta, decrement, reg, f0[:, None] - armijo_c * steps * decrement[:, None]


def _former_newton_step(params, mu, s, f0, g, H, Bf, yv, w, alpha, epsilon, kmask, tol):
    """``solver._newton_step`` as it was, op by op."""
    B, n = params.shape
    dt, dev = params.dtype, params.device
    if n > 6:
        _, reg_g, reg_h = _former_reg_terms(params, alpha, epsilon, kmask)
        g = (g + reg_g) * torch.cat(
            [torch.ones((B, 6), dtype=dt, device=dev), kmask], dim=1)
        H = H + torch.diag_embed(reg_h)

    scale_h = lane.lane_sum(torch.diagonal(H, dim1=-2, dim2=-1)) / n + 1e-12
    Hd = H + (mu * scale_h)[:, None, None] * torch.eye(n, dtype=dt, device=dev)
    if n > solver.CHOLESKY_MAX_N:
        delta = -solver._pcg_solve(Hd, g)
    else:
        delta = solver._cholesky_direction(Hd, g)
    bad = ~torch.isfinite(delta).all(dim=1)
    delta = torch.where(bad[:, None],
                        -g / (torch.sqrt(lane.lane_dot(g, g)) + 1.0)[:, None], delta)
    decrement = -lane.lane_dot(g, delta)

    u = lane.matvec(Bf, delta)
    steps = 0.5 ** torch.arange(solver.LS_STEPS, dtype=dt, device=dev)
    data_cand = lane.softplus_energies(s, yv, w, steps, u)
    sq_eps = math.sqrt(epsilon)
    if n > 6:
        xi_cand = params[:, 6:, None] + delta[:, 6:, None] * steps
        term2c = torch.sqrt(xi_cand * xi_cand + epsilon)
        reg_cand = alpha[:, None] * lane.lane_sum(kmask[:, :, None] * (term2c - sq_eps), 1)
        f_cand = data_cand + reg_cand.clamp_min(0.0)
    else:
        f_cand = data_cand

    armijo = f_cand <= f0[:, None] - solver.ARMIJO_C * steps * decrement[:, None]
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

    scales = solver._scales(dt, dev)
    data_sc = lane.softplus_energies(new_s, yv, w, scales)
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


def _variant_inputs(kind, B, variant):
    """Torch inputs of one case, the variant applied to the last lane (the
    NaN direction is applied by the caller)."""
    n, _ = KINDS[kind]
    a = {k: torch.from_numpy(np.array(v)) for k, v in _inputs(n, B).items()}
    if variant == 'zero kmask':
        a['kmask'][-1] = 0.0
    elif variant == 'infinite damping':
        a['mu'][-1] = float('inf')
    elif variant == 'infinite f0':
        a['f0'][-1] = float('inf')
    return a


def _direction(kind, g, Hd):
    """The direction as the step hands it to the guard, and ``negate``."""
    if KINDS[kind][1] == 'pcg':
        return solver._pcg_solve(Hd, g), True
    return solver._cholesky_direction(Hd, g), False


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('B', [1, 2, 5])
@pytest.mark.parametrize('kind', list(KINDS))
def test_plain_versions_are_the_former_expressions(kind, B, variant, _kind):
    """(a) ``lm_system_plain`` and ``step_guard_plain`` (and the entry
    points, which launch nothing on the CPU) bitwise the expressions the
    solver ran before, in every variant."""
    a = _variant_inputs(kind, B, variant)
    args = (a['params'], a['mu'], a['alpha'], EPSILON, a['kmask'], a['g'], a['H'])
    lane.reset_launch_counts()
    g_ref, Hd_ref = _former_lm_system(*args)
    for g, Hd in (lane.lm_system_plain(*args), lane.lm_system(*args)):
        assert _bits_equal(g, g_ref) and _bits_equal(Hd, Hd_ref)
    if variant == 'infinite damping':
        assert bool(torch.isnan(Hd_ref[-1]).any())
    direction, negate = _direction(kind, g_ref, Hd_ref)
    if variant == 'NaN direction':
        direction = direction.clone()
        direction[-1, 3] = float('nan')
    guard_args = (direction, g_ref, a['params'], a['alpha'], EPSILON, a['kmask'], _steps(),
                  a['f0'], solver.ARMIJO_C, negate)
    want = _former_guard(*guard_args)
    for got in (lane.step_guard_plain(*guard_args), lane.step_guard(*guard_args)):
        assert len(got) == len(want) == 4
        for x, y in zip(got, want):
            assert _bits_equal(x, y)
    if variant in ('NaN direction', 'infinite damping'):
        assert bool(torch.isfinite(want[0][-1]).all())  # the gradient step
    assert not any(lane.LAUNCHES.values())


# (b) the JAX package's lines on the same numpy inputs


def _jax_lm_system(params, mu, alpha, kmask, g, H):
    """``superdsm_tpu/dsm/solver.py:194-200``, one lane, vmapped."""
    def one(params, mu, alpha, kmask, g, H):
        n = params.shape[0]
        if n > 6:
            _, reg_g, reg_h = jsolver._reg_terms(params, alpha, EPSILON, kmask)
            g = (g + reg_g) * jnp.concatenate([jnp.ones(6, params.dtype), kmask])
            H = H + jnp.diag(reg_h)
        scale_h = jnp.trace(H) / n + 1e-12
        return g, H + (mu * scale_h) * jnp.eye(n, dtype=H.dtype)
    return [np.asarray(x) for x in jax.vmap(one)(
        *(jnp.asarray(v) for v in (params, mu, alpha, kmask, g, H)))]


def _jax_guard(delta, g, params, alpha, kmask, f0):
    """``superdsm_tpu/dsm/solver.py:208-210, 218-222, 227`` (the threshold
    of the Armijo test), one lane, vmapped."""
    def one(delta, g, params, alpha, kmask, f0):
        n = params.shape[0]
        bad = ~jnp.all(jnp.isfinite(delta))
        delta = jnp.where(bad, -g / (jnp.sqrt(jnp.sum(g * g)) + 1.0), delta)
        decrement = -jnp.dot(g, delta)
        steps = 0.5 ** jnp.arange(jsolver.LS_STEPS, dtype=params.dtype)
        reg_cand = jnp.zeros_like(steps)
        if n > 6:
            xi_cand = params[6:, None] + delta[6:, None] * steps[None, :]
            term2c = jnp.sqrt(xi_cand * xi_cand + EPSILON)
            reg_cand = alpha * jnp.sum(kmask[:, None] * (term2c - jnp.sqrt(EPSILON)), axis=0)
            reg_cand = jnp.maximum(reg_cand, 0.0)
        return delta, decrement, reg_cand, f0 - jsolver.ARMIJO_C * steps * decrement
    return [np.asarray(x) for x in jax.vmap(one)(
        *(jnp.asarray(v) for v in (delta, g, params, alpha, kmask, f0)))]


@pytest.mark.parametrize('kind', list(KINDS))
def test_lm_system_and_guard_match_the_jax_package(kind, _kind):
    """(b) The damped system and the guarded step's outputs against the JAX
    package's lines on the same inputs, to rtol 1e-5 (the trace and the dot
    products summed in another order), with a NaN direction in the last
    lane."""
    n, _ = KINDS[kind]
    a = _inputs(n, 4, seed=3)
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    g, Hd = lane.lm_system(t['params'], t['mu'], t['alpha'], EPSILON, t['kmask'], t['g'],
                           t['H'])
    jg, jHd = _jax_lm_system(a['params'], a['mu'], a['alpha'], a['kmask'], a['g'], a['H'])
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(Hd.numpy(), jHd, rtol=1e-5, atol=1e-6)
    direction, negate = _direction(kind, g, Hd)
    direction = direction.clone()
    direction[-1, 2] = float('nan')
    got = lane.step_guard(direction, g, t['params'], t['alpha'], EPSILON, t['kmask'],
                          _steps(), t['f0'], solver.ARMIJO_C, negate)
    want = _jax_guard((-direction if negate else direction).numpy(), g.numpy(), a['params'],
                      a['alpha'], a['kmask'], a['f0'])
    for name, x, y in zip(('delta', 'decrement', 'reg_cand', 'thresholds'), got, want):
        if x is None:
            assert n == 6 and not y.any()
            continue
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('kind', list(KINDS))
def test_newton_step_matches_the_jax_package(kind, _kind):
    """(b) ``solver._newton_step`` against the JAX package's vmapped
    ``_newton_step`` on the same inputs: params, surface and energy to rtol
    1e-5, the convergence flags and mu exactly."""
    n, _ = KINDS[kind]
    a = _inputs(n, 4, seed=5)
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    out = solver._newton_step(t['params'], t['mu'], t['s'], t['f0'], t['g'], t['H'], t['Bf'],
                              t['yv'], t['w'], t['alpha'], EPSILON, t['kmask'], 1e-5)
    step = jax.vmap(jsolver._newton_step,
                    in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None, 0, None))
    ref = step(*(jnp.asarray(a[k]) for k in ('params', 'mu', 's', 'f0', 'g', 'H', 'Bf',
                                             'yv', 'w', 'alpha')),
               EPSILON, jnp.asarray(a['kmask']), 1e-5)
    for x, y in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    for x, y in zip(out[3:], ref[3:]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# (c) the kernels' schedules replayed in numpy

F32 = np.float32
#: csrc/lane_ops.cu: slots of a sum, warps of a block, rows of Hd a block of
#: lane_lm_system writes.
SLOTS, WARP, LM_ROWS = lane.ROW_THREADS, 32, 16


def _clamp0(v):
    return np.where(np.isnan(v), v, np.maximum(v, F32(0)))


def _slot_sum(terms, reverse=False):
    """A block's sum of ``terms`` (L,) as the kernels run it: slot t adds
    terms t, t + 256, ... in turn from 0 (``reverse``: another order, slot
    t adds a contiguous run of c terms, t c to t c + c - 1, c = ceil(L /
    256); a permutation of the slots alone would not do, since the tree
    gives the same sum for slots reversed or rotated); warp 0 gathers slots
    32 r + l into v[r], adds v[r + m] for m = 4, 2, 1 and then shuffles
    down by 16, ..., 1; lane 0 holds the sum."""
    slots = np.zeros(SLOTS, F32)
    L = len(terms)
    chain = -(-L // SLOTS)
    for t in range(SLOTS):
        run = range(t * chain, min(L, (t + 1) * chain)) if reverse else range(t, L, SLOTS)
        for i in run:
            slots[t] = F32(slots[t] + terms[i])
    return _slot_tree(slots)


def _slot_tree(slots):
    """The tree of the 256 slots (:func:`_slot_sum`'s)."""
    v = slots.reshape(SLOTS // WARP, WARP)
    for m in (4, 2, 1):
        v = (v[:m] + v[m:2 * m]).astype(F32)
    x = v[0]
    for m in (16, 8, 4, 2, 1):
        x = (x + np.concatenate([x[m:], np.zeros(m, F32)])).astype(F32)
    return x[0]


def _reg_hess_np(xi, a, km, eps):
    t2 = np.sqrt(xi * xi + eps)
    r = (F32(1) / t2) * F32(1)
    q = (xi * xi) / ((t2 * t2) * t2)
    return _clamp0(a * (r - q)) * km + (F32(1) - km)


def _lm_kernel_replay(params, mu, alpha, kmask, g, H, reverse=False):
    """``lane_lm_system_kernel`` block by block: (g', Hd, the sum of each
    lane's diagonal as its last block computed it)."""
    B, n = params.shape
    eps, inv_n, tiny = F32(EPSILON), F32(1) / F32(n), F32(1e-12)
    K = n - 6
    tiles = -(-n // LM_ROWS)
    g_out, Hd, total = g.copy(), np.empty_like(H), np.empty(B, F32)
    for block in range(B * tiles):
        o, tile = divmod(block, tiles)
        p, a = params[o], alpha[o]
        km = kmask[o] if K > 0 else None

        def diag_term(i):
            v = H[o, i, i]
            if K > 0:
                v = F32(v + (F32(0) if i < 6 else _reg_hess_np(p[i], a, km[i - 6], eps)))
            return v

        total[o] = _slot_sum([diag_term(i) for i in range(n)], reverse)
        c = F32(mu[o] * F32(total[o] * inv_n + tiny))
        c_diag, c_off = F32(c * F32(1)), F32(c * F32(0))
        for i in range(tile * LM_ROWS, min(n, (tile + 1) * LM_ROWS)):
            row = H[o, i].copy()
            if K > 0:
                row = (row + F32(0)).astype(F32)
            row = (row + c_off).astype(F32)
            row[i] = F32(diag_term(i) + c_diag)
            Hd[o, i] = row
        if tile == 0 and K > 0:
            xi = p[6:]
            rg = (a * (xi / np.sqrt(xi * xi + eps))) * km
            g_out[o] = (g[o] + np.concatenate([np.zeros(6, F32), rg])) * \
                np.concatenate([np.ones(6, F32), km])
    return g_out, Hd, total


def _lm_chain_replay(params, mu, alpha, kmask, g, H):
    """The op-by-op chain with float32 numpy ops as ATen's CUDA kernels
    round them (``x / n`` with a Python n is ``x * (1.0f / n)`` there) and
    the lane sums' order."""
    B, n = params.shape
    eps = F32(EPSILON)
    if n > 6:
        xi, a = params[:, 6:], alpha[:, None]
        term2 = np.sqrt(xi * xi + eps)
        zeros6 = np.zeros((B, 6), F32)
        reg_g = np.concatenate([zeros6, a * (xi / term2) * kmask], 1)
        reg_h = np.concatenate([zeros6, _reg_hess_np(xi, a, kmask, eps)], 1)
        g = (g + reg_g) * np.concatenate([np.ones((B, 6), F32), kmask], 1)
        H = H + reg_h[:, :, None] * np.eye(n, dtype=F32)   # diag_embed: + 0 off it
    total = lane.lane_sum_in_kernel_order(np.diagonal(H, axis1=1, axis2=2))
    scale = total * (F32(1) / F32(n)) + F32(1e-12)
    return g, H + (mu * scale)[:, None, None] * np.eye(n, dtype=F32), total


def _guard_kernel_replay(direction, g, params, alpha, kmask, steps, f0, negate,
                         reverse=False):
    """``lane_step_guard_kernel`` lane by lane (one block each; its sums
    over the block's slots; ``reverse`` takes the decrement's slots in
    another order)."""
    B, n = direction.shape
    S, K = len(steps), n - 6
    eps, sq_eps, armijo = F32(EPSILON), F32(math.sqrt(EPSILON)), F32(solver.ARMIJO_C)
    delta = np.empty_like(direction)
    dec, thr = np.empty(B, F32), np.empty((B, S), F32)
    reg = np.empty((B, S), F32) if K > 0 else None
    for o in range(B):
        d = -direction[o] if negate else direction[o].copy()
        if not np.isfinite(d).all():
            den = F32(np.sqrt(_slot_sum(g[o] * g[o])) + F32(1))
            d = (-g[o] / den).astype(F32)
        delta[o] = d
        dec[o] = -_slot_sum(g[o] * d, reverse)
        thr[o] = f0[o] - (armijo * steps) * dec[o]
        for k in range(S if K > 0 else 0):
            xi = params[o, 6:] + d[6:] * steps[k]
            terms = kmask[o] * (np.sqrt(xi * xi + eps) - sq_eps)
            reg[o, k] = _clamp0(F32(alpha[o] * _slot_sum(terms)))
    return delta, dec, reg, thr


def _guard_chain_replay(direction, g, params, alpha, kmask, steps, f0, negate):
    """The op-by-op chain with float32 numpy ops and the lane sums' order."""
    B, n = direction.shape
    delta = -direction if negate else direction
    bad = ~np.isfinite(delta).all(1)
    gg = lane.lane_sum_in_kernel_order(g * g)
    delta = np.where(bad[:, None], -g / (np.sqrt(gg) + F32(1))[:, None], delta)
    dec = -lane.lane_sum_in_kernel_order(g * delta)
    reg = None
    if n > 6:
        xi = params[:, 6:, None] + delta[:, 6:, None] * steps          # (B, K, S)
        terms = kmask[:, :, None] * (np.sqrt(xi * xi + F32(EPSILON)) - F32(math.sqrt(EPSILON)))
        sums = lane.lane_sum_in_kernel_order(
            terms.transpose(0, 2, 1).reshape(-1, n - 6)).reshape(B, -1)
        reg = _clamp0(alpha[:, None] * sums)
    return delta, dec, reg, f0[:, None] - (F32(solver.ARMIJO_C) * steps) * dec[:, None]


def _replay_inputs(n, B, seed):
    """Inputs whose sums depend on their order: H's diagonal, g and the
    direction mostly of magnitude 0.1 to 1 with every 97th entry 3e6 (the
    direction's at other indices than g's; a
    partial sum that holds one loses the small terms' fractions, how many
    depending on which terms it met first), the diagonal positive; the
    rest of H of magnitudes 1e-3 to 1e3, params of a few units."""
    rng = np.random.RandomState(seed + n)

    def spiky(*shape, first=0):
        x = rng.uniform(0.1, 1.0, shape) * np.sign(rng.randn(*shape))
        x[..., first::97] *= 3e6
        return x.astype(F32)
    H = (rng.randn(B, n, n) * 10.0 ** rng.randint(-3, 4, (B, n, n))).astype(F32)
    H[:, np.arange(n), np.arange(n)] = np.abs(spiky(B, n))
    params = (rng.randn(B, n) * 3).astype(F32)
    kmask = (rng.rand(B, n - 6) < 0.8).astype(F32)
    alpha = (rng.rand(B) + 0.1).astype(F32)
    mu = (10.0 ** rng.uniform(-6, -1, B)).astype(F32)
    return params, mu, alpha, kmask, spiky(B, n), H, spiky(B, n, first=50)


def _np_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


def _slots_by_threads(terms, T):
    """``lane_slots_sum`` in a block of T threads (the direction kernels'
    64 to 512): thread t runs slots t, t + T, ... (< 256), slot s adding
    terms s, s + 256, ... in turn; then the tree."""
    slots = np.zeros(SLOTS, F32)
    for t in range(T):
        for s in range(t, SLOTS, T):
            acc = F32(0)
            for i in range(s, len(terms), SLOTS):
                acc = F32(acc + terms[i])
            slots[s] = acc
    return _slot_tree(slots)


#: The direction kernels' step variants by (route, threads a block, blocks
#: a lane): one block a lane (64 threads at n <= 32, 128 at n <= 64, else
#: 256), the cluster routes (512 threads, 8 or 16 blocks), PCG's register
#: route (256 threads, 8 blocks).
FUSED_ROUTES = [('one block', 64, 1), ('one block', 256, 1), ('cluster', 512, 8),
                ('cluster', 512, 16), ('pcg', 256, 8)]
PW = 8  # columns of a cluster route's panel


class _Damp:
    """``Damp`` of ``csrc/lane_ops.cu`` for one lane, in numpy float32: the
    trace computed by a block of T threads (:func:`_slots_by_threads`),
    then each entry of Hd and g' from H's and g's as a kernel loads it."""

    def __init__(self, p, mu, a, km, H, T):
        n = len(p)
        self.reg, self.n = n > 6, n
        eps = F32(EPSILON)
        if self.reg:
            self.reg_h = np.concatenate([np.zeros(6, F32), _reg_hess_np(p[6:], a, km, eps)])
            xi = p[6:]
            self.reg_g = np.concatenate([np.zeros(6, F32), (a * (xi / np.sqrt(xi * xi + eps))) * km])
            self.mask = np.concatenate([np.ones(6, F32), km])
        self.total = _slots_by_threads([self.trace_term(H[i, i], i) for i in range(n)], T)
        c = F32(mu * F32(F32(self.total * (F32(1) / F32(n))) + F32(1e-12)))
        self.c_diag, self.c_off = F32(c * F32(1)), F32(c * F32(0))

    def trace_term(self, h, i):
        return F32(h + self.reg_h[i]) if self.reg else h

    def at(self, h, i, k):
        if i == k:
            return F32(self.trace_term(h, i) + self.c_diag)
        return F32((F32(h + F32(0)) if self.reg else h) + self.c_off)

    def grad(self, gi, i):
        return F32(F32(gi + self.reg_g[i]) * self.mask[i]) if self.reg else gi


def _fused_prologue_replay(params, mu, alpha, kmask, g, H, route, T, C):
    """The step variants' prologue lane by lane: every block of a lane
    recomputes the trace (each block's ``Damp``; all must agree), then the
    damped entries as the route loads them: the cluster routes panel by
    panel (panel r of PW columns, rows r PW .. n, the augmented row n its
    g', owned by block r % C); one block a lane the lower triangle row by
    row; PCG's registers every row of its blocks' rows, Jacobi's diagonal
    and b. Returns (g', the lower triangle of Hd, whole rows for PCG, the
    trace)."""
    B, n = params.shape
    g_out, Hd, total = np.zeros_like(g), np.zeros_like(H), np.empty(B, F32)
    for o in range(B):
        dms = [_Damp(params[o], mu[o], alpha[o], kmask[o] if n > 6 else None, H[o], T)
               for _ in range(C)]
        assert len({d.total.tobytes() for d in dms}) == 1
        total[o] = dms[0].total
        if route == 'cluster':
            for r in range(-(-n // PW)):
                dm, c0 = dms[r % C], r * PW
                for f in range((n + 1 - c0) * PW):
                    i, k = c0 + f // PW, c0 + f % PW
                    if k < n and i >= k:
                        if i < n:
                            Hd[o, i, k] = dm.at(H[o, i, k], i, k)
                        else:
                            g_out[o, k] = dm.grad(g[o, k], k)
        elif route == 'one block':
            for i in range(n):
                for k in range(i + 1):
                    Hd[o, i, k] = dms[0].at(H[o, i, k], i, k)
                g_out[o, i] = dms[0].grad(g[o, i], i)
        else:
            nr = -(-n // C)
            for q in range(C):
                for i in range(q * nr, min(n, (q + 1) * nr)):
                    for j in range(n):
                        Hd[o, i, j] = dms[q].at(H[o, i, j], i, j)
                # every block's Jacobi diagonal and b, whole
                jacobi = [dms[q].at(H[o, j, j], j, j) for j in range(n)]
                b = [dms[q].grad(g[o, j], j) for j in range(n)]
                if q:
                    assert _np_equal(jacobi, first) and _np_equal(b, g_out[o])
                first, g_out[o] = jacobi, b
    return g_out, Hd, total


@pytest.mark.parametrize('n,B', [(6, 3), (38, 2), (262, 2), (774, 1)])
def test_lm_system_schedule_keeps_every_bit(n, B):
    """(c) ``lane_lm_system``'s blocks (16 rows of a lane's Hd each, every
    block with its own ``scale_h`` sum) give the chain's bits; the same
    schedule with the diagonal's slots in another order gives other bits
    of its sum where a slot adds more than one entry. So does the direction
    kernels' prologue (the direction launch's damped system, never written
    out) on each route: the trace in every block of a lane by its threads,
    the damped entries and g' in the order each route loads them (a
    cluster route's panels, the one-block route's triangle, PCG's rows in
    registers)."""
    params, mu, alpha, kmask, g, H, _ = _replay_inputs(n, B, seed=1)
    got = _lm_kernel_replay(params, mu, alpha, kmask, g, H)
    want = _lm_chain_replay(params, mu, alpha, kmask, g, H)
    for x, y in zip(got, want):
        assert _np_equal(x, y)
    plain = lane.lm_system_plain(*(torch.from_numpy(v) for v in (params, mu, alpha)),
                                 EPSILON, torch.from_numpy(kmask), torch.from_numpy(g),
                                 torch.from_numpy(H))
    for x, y in zip(plain, want[:2]):  # the same function: the CPU's sums and sqrt
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-5, atol=1e-6)
    if n > SLOTS:
        wrong = _lm_kernel_replay(params, mu, alpha, kmask, g, H, reverse=True)
        assert not _np_equal(wrong[2], want[2])
    # the direction kernels' prologue: the trace in each block of a lane,
    # the damped entries as each route loads them
    lower = np.tril(np.ones((n, n), bool))
    for route, T, C in FUSED_ROUTES:
        g_f, Hd_f, total_f = _fused_prologue_replay(params, mu, alpha, kmask, g, H, route, T, C)
        assert _np_equal(total_f, want[2]) and _np_equal(g_f, want[0]), route
        mask = np.ones((n, n), bool) if route == 'pcg' else lower
        assert _np_equal(Hd_f[:, mask], want[1][:, mask]), route


def _fused_guard_replay(direction, g, params, alpha, kmask, steps, f0, negate, T, fail=None,
                        blocks=1):
    """``step_guard_lane`` of the direction kernels' epilogue lane by lane,
    in a block of T threads: the direction as block 0 holds it (x negated
    in place: Cholesky's back substitution gives x = -direction, PCG's
    replica holds its solution, which the guard negates); thread t tests
    entries t, t + T, ...; the sums over the 256 slots by T threads
    (:func:`_slots_by_threads`), the S regularizer trees over the block's
    T / 32 warps (each sum's order its own), dealt over ``blocks`` blocks
    holding the same direction (PCG's cluster: block q the sums k = q, q +
    blocks, ...); lane ``fail``'s factor failed, and its direction is not
    read (here: its entries left as they are)."""
    B, n = direction.shape
    S, K = len(steps), n - 6
    eps, sq_eps, armijo = F32(EPSILON), F32(math.sqrt(EPSILON)), F32(solver.ARMIJO_C)
    delta = np.empty_like(direction)
    dec, thr = np.empty(B, F32), np.empty((B, S), F32)
    reg = np.empty((B, S), F32) if K > 0 else None
    for o in range(B):
        x = direction[o] if negate else -direction[o]
        d = -x
        bad = o == fail or any(not np.isfinite(d[i]) for t in range(T) for i in range(t, n, T))
        if bad:
            den = F32(np.sqrt(_slots_by_threads(g[o] * g[o], T)) + F32(1))
            d = (-g[o] / den).astype(F32)
        delta[o] = d
        dec[o] = -_slots_by_threads(g[o] * d, T)
        thr[o] = f0[o] - (armijo * steps) * dec[o]
        warps = T // WARP
        for q in range(blocks):
            for w in range(warps):
                for k in range(q + blocks * w, S if K > 0 else 0, blocks * warps):
                    xi = params[o, 6:] + d[6:] * steps[k]
                    terms = kmask[o] * (np.sqrt(xi * xi + eps) - sq_eps)
                    reg[o, k] = _clamp0(F32(alpha[o] * _slots_by_threads(terms, T)))
    return delta, dec, reg, thr


@pytest.mark.parametrize('negate', [False, True])
@pytest.mark.parametrize('n,B', [(6, 3), (38, 3), (262, 2), (774, 2)])
def test_step_guard_schedule_keeps_every_bit(n, B, negate):
    """(c) ``lane_step_guard``'s one block a lane (the direction read,
    negated for PCG; the gradient fallback's and the decrement's sums; the
    thresholds; the S regularizer sums over the same slots) gives the
    chain's bits, with a non-finite direction in lane 0; the decrement's
    slots in another order give other bits in the last lane (a finite
    direction, its terms of either sign) where a slot adds more than one
    term. So does the direction kernels' epilogue in blocks of 64, 256
    and 512 threads, on the direction as its block 0 holds it, its S sums
    dealt over PCG's 8 blocks, and with a lane whose factor failed (the
    chain's all-NaN direction) taking the gradient step without reading a
    direction."""
    params, _, alpha, kmask, g, _, direction = _replay_inputs(n, B, seed=2)
    direction[0, n // 2] = np.inf
    steps = _steps().numpy()
    f0 = np.random.RandomState(n).rand(B).astype(F32) * 100
    got = _guard_kernel_replay(direction, g, params, alpha, kmask, steps, f0, negate)
    want = _guard_chain_replay(direction, g, params, alpha, kmask, steps, f0, negate)
    for x, y in zip(got, want):
        assert _np_equal(x, y)
    plain = lane.step_guard_plain(*(torch.from_numpy(v) for v in (direction, g, params, alpha)),
                                  EPSILON, torch.from_numpy(kmask), _steps(),
                                  torch.from_numpy(f0), solver.ARMIJO_C, negate)
    for x, y in zip(plain, want):  # the same function: the CPU's sums and sqrt
        if x is not None:
            np.testing.assert_allclose(x.numpy(), y, rtol=1e-5, atol=1e-6)
    if n > SLOTS:
        wrong = _guard_kernel_replay(direction, g, params, alpha, kmask, steps, f0, negate,
                                     reverse=True)
        assert not _np_equal(wrong[1][-1], want[1][-1])
    # the direction kernels' epilogue, in blocks of T threads (the
    # direction as block 0 holds it: Cholesky's -x, PCG's replica of x
    # negated), and the failure path's gradient step: a lane whose factor
    # failed reads no direction
    failed = direction.copy()
    failed[-1] = np.nan  # the chain's direction of a failed lane
    for T, blocks in sorted({(T, C if route == 'pcg' else 1) for route, T, C in FUSED_ROUTES}):
        got = _fused_guard_replay(direction, g, params, alpha, kmask, steps, f0, negate, T,
                                  blocks=blocks)
        for x, y in zip(got, want):
            assert _np_equal(x, y), T
        got = _fused_guard_replay(direction, g, params, alpha, kmask, steps, f0, negate, T,
                                  fail=B - 1, blocks=blocks)
        for x, y in zip(got, _guard_chain_replay(failed, g, params, alpha, kmask, steps, f0,
                                                 negate)):
            assert _np_equal(x, y), T


# (d) the solver's steps bitwise as they were


@pytest.mark.parametrize('variant', ['as is', 'infinite damping'])
@pytest.mark.parametrize('kind', list(KINDS))
def test_newton_step_is_its_former_body(kind, variant, _kind):
    """(d) ``solver._newton_step`` bitwise a copy of its former body (kept
    in this file), on each lane kind, with an infinite damping in one
    lane (its guarded gradient step)."""
    a = _variant_inputs(kind, 5, variant)
    args = (a['params'], a['mu'], a['s'], a['f0'], a['g'], a['H'], a['Bf'], a['yv'], a['w'],
            a['alpha'], EPSILON, a['kmask'], 1e-5)
    for x, y in zip(solver._newton_step(*args), _former_newton_step(*args)):
        assert _bits_equal(x, y)


@pytest.mark.parametrize('n', [6, 134, 262, 518])
def test_newton_step_goes_through_the_direction_plain_version(n, monkeypatch):
    """(d) On the CPU ``solver._newton_step`` takes its damped system,
    direction and guard from ``lane.newton_direction_plain`` (once a step;
    PCG above ``CHOLESKY_MAX_N``, n = 518) and is bitwise its former body
    (the copy in this file: the damped system, ``_pcg_solve`` or
    ``_cholesky_direction`` and the guard op by op) at the DSM buckets' n =
    6, 134, 262 and 518, with an infinite damping in one lane."""
    a = _variant_inputs('poly', 3, 'infinite damping') if n == 6 else None
    if a is None:
        a = {k: torch.from_numpy(np.array(v)) for k, v in _inputs(n, 3, seed=7).items()}
        a['mu'][-1] = float('inf')
    calls = []
    plain = lane.newton_direction_plain

    def counted(*args, **kwargs):
        calls.append(args[10] if len(args) > 10 else kwargs.get('pcg'))
        return plain(*args, **kwargs)
    monkeypatch.setattr(lane, 'newton_direction_plain', counted)
    args = (a['params'], a['mu'], a['s'], a['f0'], a['g'], a['H'], a['Bf'], a['yv'], a['w'],
            a['alpha'], EPSILON, a['kmask'], 1e-5)
    out = solver._newton_step(*args)
    assert calls == [(solver.CG_MAX_ITERS, solver.CG_RTOL) if n > solver.CHOLESKY_MAX_N
                     else None]
    for x, y in zip(out, _former_newton_step(*args)):
        assert _bits_equal(x, y)


def _mesh_inputs(B=4, H=16, W=32, K=8):
    """Disks with noise on a 16x32 field, the DSM's subsample points and
    kmask (as ``tests/test_torch_mesh.py`` builds its problems)."""
    rng = np.random.RandomState(0)
    rr, cc = np.indices((H, W))
    pix = np.stack([rr, cc], -1).reshape(-1, 2).astype(np.float32)
    C = np.tile((pix / np.array([H - 1, W - 1], np.float32))[None], (B, 1, 1))
    Y = np.zeros((B, H * W), np.float32)
    for b in range(B):
        r0, c0 = rng.randint(4, 12), rng.randint(8, 24)
        Y[b] = ((((rr - r0) ** 2 + (cc - c0) ** 2) < 25).astype(np.float32) - 0.5).ravel()
        Y[b] += rng.randn(H * W).astype(np.float32) * 0.1
    sub = rng.randint(0, 16, (B, K, 2)).astype(np.float32)
    return (C, Y, np.ones((B, H * W), np.float32), np.tile(pix[None], (B, 1, 1)), sub,
            np.ones((B, K), np.float32))


@pytest.mark.parametrize('kind', ['poly', 'dsm'])
def test_sharded_solver_is_as_with_the_former_guard(kind, monkeypatch):
    """(d) The sharded solvers on a (1, 2) mesh give bitwise what they give
    with the step guard written as the former expressions after the
    Cholesky direction of the system they damp, and take the direction and
    its guard (``lane.newton_direction``, without its damping) once a
    Newton iteration."""
    C, Y, Wt, pix, sub, km = _mesh_inputs()
    mesh = pm.make_mesh(1, 2, ['cpu'] * 2)
    if kind == 'poly':
        solve = newton.make_sharded_poly_solver(mesh)
        args = (np.zeros((4, 6), np.float32), C, Y, Wt)
    else:
        solve = newton.make_sharded_dsm_solver(mesh, sigma=3.0, cutoff=12)
        args = (np.zeros((4, 14), np.float32), C, pix, sub, km, Y, Wt,
                np.full(4, 0.1, np.float32))
    calls = [0, 0]
    direction, contribs = lane.newton_direction, newton._Shard.contribs

    def counted_direction(*a, **k):
        calls[0] += 1
        return direction(*a, **k)

    def counted_contribs(*a, **k):
        calls[1] += 1
        return contribs(*a, **k)

    def former(params, mu, alpha, epsilon, kmask, g, Hd, steps, f0, armijo_c, pcg=None):
        assert mu is None and pcg is None
        return _former_guard(solver._cholesky_direction(Hd, g), g, params, alpha, epsilon,
                             kmask, steps, f0, armijo_c)
    monkeypatch.setattr(lane, 'newton_direction', counted_direction)
    monkeypatch.setattr(newton._Shard, 'contribs', counted_contribs)
    out = solve(*args)
    assert calls[0] > 1 and calls[1] == 2 * calls[0]
    monkeypatch.setattr(lane, 'newton_direction', former)
    for x, y in zip(out, solve(*args)):
        assert _bits_equal(x.float(), y.float())
