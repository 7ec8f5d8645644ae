"""The fused lane sums of :mod:`superdsm_tpu_torch.dsm.lane` on the CPU.

:func:`lane.softplus_energies` and :func:`lane.lane_dot` stand for sums that
the solver used to build op by op (a (B, P, S) tensor of softplus terms, a
product ``r * z``) before :func:`lane.lane_sum` read them back. On the card
each is one kernel that builds its terms in registers; on the CPU each is
its plain version, which must be exactly that op-by-op expression, so that
every CPU result stays bitwise what it was. Here:

- the plain versions against a copy of the expressions the solver used
  (kept in this file), bitwise, at the solver's shapes and B = 1, 2, 5;
- the same sums against the JAX package's own (``superdsm_tpu/dsm/
  solver.py``: the line search, the scale sweep, ``_energy_from_surface``,
  PCG's ``jnp.dot``), run by JAX on the CPU on the same numpy inputs, at
  rtol 1e-5 (float32 sums taken in another order);
- :func:`lane.lane_sum` of a strided (B, P, S) view: bitwise
  :func:`lane.lane_sum_plain`, and the strides the kernel is given
  (``lane._as_ols``) read the same elements in the same order as a
  contiguous copy, replayed in the kernel's order on the host;
- ``solver._newton_step`` (a Cholesky lane, a PCG lane, a polynomial lane),
  ``_energy_from_surface`` and ``_better_of`` bitwise equal to the same
  functions with the fused sums replaced by the copied expressions;
- the schedule of the softplus sums' kernel (``lane_softplus_pixel_kernel``:
  a thread builds one pixel's terms for every output of its tile, groups
  of 16 chain steps, slots pushed to the output's owner block) replayed
  with its own index arithmetic in numpy: bitwise
  ``lane.lane_sum_in_kernel_order`` of the terms, at several lengths,
  tiles and output counts; the replay with a group's steps added in
  reverse gives other bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superdsm_tpu.dsm import solver as jsolver

import superdsm_tpu_torch as T
from superdsm_tpu_torch.dsm import gram, lane, solver
from superdsm_tpu_torch.dsm.smooth import build_smooth_matrix

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_device():
    with T.use_device('cpu'):
        yield


def _bits_equal(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


# the expressions the solver summed before the fused entry points (its
# line search, scale sweep, energies and PCG's dot products), op by op


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _line_search_op_by_op(s, u, steps, yv, w):
    s_cand = s[:, :, None] + u[:, :, None] * steps                # (B, P, S)
    t_cand = yv[:, :, None] * s_cand
    return lane.lane_sum_plain(w[:, :, None] * _softplus(-t_cand), 1)


def _scale_sweep_op_by_op(new_s, scales, yv, w):
    t_sc = yv * new_s
    return lane.lane_sum_plain(w[:, :, None] * _softplus(-t_sc[:, :, None] * scales), 1)


def _energy_op_by_op(s, yv, w):
    t = yv * s
    return lane.lane_sum_plain(w * _softplus(-t))


def _softplus_energies_op_by_op(s, y, w, c=None, u=None):
    if u is not None:
        return _line_search_op_by_op(s, u, c, y, w)
    if c is not None:
        return _scale_sweep_op_by_op(s, c, y, w)
    return _energy_op_by_op(s, y, w)


def _dot_op_by_op(a, b):
    return lane.lane_sum_plain(a * b)


def _surface_inputs(B, P, seed=0):
    """``s, u, y, w`` (B, P) as the solver sees them: surfaces and steps of
    a few units, labels of either sign, weights in [0, 1] with padding
    zeros."""
    rng = np.random.RandomState(seed + 100 * B + P)
    s = (rng.randn(B, P) * 3).astype(np.float32)
    u = (rng.randn(B, P) * 2).astype(np.float32)
    y = rng.randn(B, P).astype(np.float32)
    w = ((rng.rand(B, P) < 0.9) * rng.rand(B, P)).astype(np.float32)
    return s, u, y, w


_STEPS = (0.5 ** np.arange(solver.LS_STEPS)).astype(np.float32)
_SCALES = np.asarray(solver.SCALES, np.float32)
MODES = ['line_search', 'scale_sweep', 'energy', 'dot']
SHAPES = [(B, P) for B in (1, 2, 5) for P in (1000, 4096)]
#: The JAX comparison also at the solver's longest chunks (P = 32768), where
#: float32 sums taken in another order drift the most.
JAX_SHAPES = SHAPES + [(1, 32768), (2, 32768)]


def _fused_and_reference(mode, s, u, y, w):
    """The port's entry point and the copied expression on the same torch
    tensors."""
    if mode == 'line_search':
        c = torch.from_numpy(_STEPS)
        return lane.softplus_energies(s, y, w, c, u), _softplus_energies_op_by_op(s, y, w, c, u)
    if mode == 'scale_sweep':
        c = torch.from_numpy(_SCALES)
        return lane.softplus_energies(s, y, w, c), _softplus_energies_op_by_op(s, y, w, c)
    if mode == 'energy':
        return lane.softplus_energies(s, y, w), _softplus_energies_op_by_op(s, y, w)
    return lane.lane_dot(s, u), _dot_op_by_op(s, u)


@pytest.mark.parametrize('B,P', SHAPES)
@pytest.mark.parametrize('mode', MODES)
def test_plain_fused_sums_equal_the_op_by_op_expressions(mode, B, P):
    """On the CPU each fused entry point is bitwise the expression it
    replaced in the solver (and so is its ``*_plain`` version)."""
    s, u, y, w = (torch.from_numpy(a) for a in _surface_inputs(B, P))
    fused, ref = _fused_and_reference(mode, s, u, y, w)
    assert _bits_equal(fused, ref)
    if mode == 'dot':
        assert _bits_equal(lane.lane_dot_plain(s, u), ref)
    else:
        c = {'line_search': _STEPS, 'scale_sweep': _SCALES}.get(mode)
        c = None if c is None else torch.from_numpy(c)
        assert _bits_equal(lane.softplus_energies_plain(
            s, y, w, c, u if mode == 'line_search' else None), ref)


def _jax_sums(mode, s, u, y, w):
    """The JAX package's sums on the same inputs, per lane (``vmap``): the
    line search and scale sweep as ``superdsm_tpu/dsm/solver.py``'s
    ``_newton_step`` writes them, one energy by its
    ``_energy_from_surface``, a dot product as its PCG's ``jnp.dot``."""
    def line_search(s, u, yv, w):
        steps = jnp.asarray(_STEPS)
        s_cand = s[:, None] + u[:, None] * steps[None, :]
        t_cand = yv[:, None] * s_cand
        return jnp.sum(w[:, None] * jax.nn.softplus(-t_cand), axis=0)

    def scale_sweep(new_s, u, yv, w):
        scales = jnp.asarray(_SCALES)
        t_sc = yv * new_s
        return jnp.sum(w[:, None] * jax.nn.softplus(-t_sc[:, None] * scales[None, :]),
                       axis=0)

    def energy(s, u, yv, w):
        empty = jnp.zeros((0,), jnp.float32)
        return jsolver._energy_from_surface(s, empty, yv, w, 0.0, 1.0, empty)

    def dot(s, u, yv, w):
        return jnp.dot(s, u)

    fn = {'line_search': line_search, 'scale_sweep': scale_sweep,
          'energy': energy, 'dot': dot}[mode]
    return np.asarray(jax.vmap(fn)(*(jnp.asarray(a) for a in (s, u, y, w))))


@pytest.mark.parametrize('B,P', JAX_SHAPES)
@pytest.mark.parametrize('mode', MODES)
def test_fused_sums_match_the_jax_package(mode, B, P):
    """The port's sums against the JAX package's on the same inputs, to
    rtol 1e-5 (float32 sums in another order; a dot product, whose terms
    cancel, to 1e-5 of the sum of its terms' magnitudes)."""
    arrays = _surface_inputs(B, P, seed=7)
    got = _fused_and_reference(mode, *(torch.from_numpy(a) for a in arrays))[0].numpy()
    ref = _jax_sums(mode, *arrays)
    assert got.shape == ref.shape
    if mode == 'dot':
        s, u = arrays[:2]
        scale = np.abs(s * u).sum(-1)
        assert np.all(np.abs(got - ref) <= 1e-5 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def _kernel_reading(x, dim):
    """The elements the strided lane-sum kernel reads for ``x`` summed over
    ``dim``, in its order: output (o, k) and reduced index i at storage
    offset o sO + i sL + k sS (``lane._as_ols``), as rows (O S, L)."""
    ols = lane._as_ols(x, dim)
    assert ols is not None
    (O, L, S), (sO, sL, sS) = ols
    view = torch.as_strided(x, (O, L, S), (sO, sL, sS), x.storage_offset())
    return view.permute(0, 2, 1).reshape(O * S, L)


def _strided_cases():
    rng = np.random.RandomState(5)
    base = torch.from_numpy(rng.randn(3, 12, 700).astype(np.float32))
    big = torch.from_numpy(rng.randn(2, 40, 9, 6).astype(np.float32))
    H = torch.from_numpy(rng.randn(4, 50, 50).astype(np.float32))
    return {
        'candidates (B, P, S) over P': (base.transpose(1, 2), 1),
        'candidates, a batch of one': (base[:1].transpose(1, 2), 1),
        'rows (B, S, P) over P': (base, 2),
        'regularizer (B, K, S) contiguous over K': (base.transpose(1, 2).contiguous(), 1),
        'a diagonal view': (torch.diagonal(H, dim1=-2, dim2=-1), 1),
        'trailing axes read as one': (big, 1),
        'a sliced batch': (base.transpose(1, 2)[1:], 1),
    }


@pytest.mark.parametrize('case', list(_strided_cases()))
def test_strided_lane_sum_reads_in_place(case):
    """``lane_sum(x, dim)`` of a strided view is bitwise ``lane_sum_plain``
    (the CPU path), and the strides the kernel is handed read exactly the
    elements of a moved-axis contiguous copy, so the kernel's
    order (replayed on the host) gives the copy's bits."""
    x, dim = _strided_cases()[case]
    assert _bits_equal(lane.lane_sum(x, dim), lane.lane_sum_plain(x, dim))
    rows = x.movedim(dim, -1).reshape(-1, x.shape[dim])
    reading = _kernel_reading(x, dim)
    assert torch.equal(reading, rows)
    shape = tuple(x.shape[:dim]) + tuple(x.shape[dim + 1:])
    replay = lane.lane_sum_in_kernel_order(reading.numpy()).reshape(shape)
    assert _bits_equal(torch.from_numpy(replay),
                       torch.from_numpy(lane.lane_sum_in_kernel_order(
                           rows.contiguous().numpy()).reshape(shape)))


def _lanes(n, B=3, seed=0):
    """``B`` lanes of size n = 6 + K: a noisy disk on a square region, the
    DSM basis centred on K of its pixels (n = 6: the polynomial basis
    alone). Returns ``(params, Q, G, yv, w, alpha, epsilon, kmask)``."""
    K = n - 6
    side = 23
    P = side * side
    rr, cc = np.indices((side, side))
    pts = np.stack([rr.ravel(), cc.ravel()], 1).astype(np.float32)
    rng = np.random.RandomState(seed + n)
    yv = np.zeros((B, P), np.float32)
    for b in range(B):
        r = side / 4 + rng.rand() * side / 8
        disk = (rr - side / 2 - rng.randn()) ** 2 + (cc - side / 2 - rng.randn()) ** 2 <= r * r
        yv[b] = (disk - 0.5 + rng.randn(side, side) * 0.4).ravel()
    tile = lambda a: torch.from_numpy(np.stack([a] * B))
    Q = solver._poly_basis(tile((pts + 40.0) / np.float32(199.0)))
    w = tile(np.ones(P, np.float32))
    if K == 0:
        return (torch.zeros((B, 6)), Q, None, torch.from_numpy(yv), w,
                torch.zeros(B), 1.0, torch.zeros((B, 0)))
    grid = pts[::len(pts) // K][:K]
    kmask = torch.ones((B, K))
    G = build_smooth_matrix(tile(pts), tile(grid), 4.0, 16, kmask)
    return (torch.zeros((B, n)), Q, G, torch.from_numpy(yv), w,
            torch.full((B,), 0.05), 1.0, kmask)


def _step_inputs(n):
    params, Q, G, yv, w, alpha, epsilon, kmask = _lanes(n)
    Bf = solver._features(Q, G)
    params = params + 0.01
    s = solver._bmv(Bf, params)
    f0 = solver._energy_from_surface(s, params[:, 6:], yv, w, alpha, epsilon, kmask)
    g, H = gram.grad_hess_plain(Bf, s, yv, w)
    mu = torch.full((params.shape[0],), 1e-3)
    return (params, mu, s, f0, g, H, Bf, yv, w, alpha, epsilon, kmask, 1e-5)


def _run(case):
    if case.startswith('newton'):
        n = {'newton cholesky (n = 128)': 128, 'newton pcg (n = 512)': 512,
             'newton poly (n = 6)': 6}[case]
        assert (n > solver.CHOLESKY_MAX_N) == ('pcg' in case)
        return solver._newton_step(*_step_inputs(n))
    params, Q, G, yv, w, alpha, epsilon, kmask = _lanes(128)
    Bf = solver._features(Q, G)
    s = solver._bmv(Bf, params + 0.02)
    if case == 'energy from surface':
        return (solver._energy_from_surface(s, params[:, 6:] + 0.02, yv, w, alpha,
                                            epsilon, kmask),)
    theta_b = torch.from_numpy(np.random.RandomState(1).randn(3, 6).astype(np.float32))
    return (solver._better_of(Q, yv, w, params[:, :6] + 0.1, theta_b),)


def _recording(fn, log):
    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append(out)
        return out
    return recorded


@pytest.mark.parametrize('case', ['newton cholesky (n = 128)', 'newton pcg (n = 512)',
                                  'newton poly (n = 6)', 'energy from surface',
                                  'better of'])
def test_solver_bitwise_as_with_the_op_by_op_sums(case, monkeypatch):
    """The solver's functions that moved to the fused sums return bitwise
    what they return with those sums written op by op, as they were, and
    every one of those sums on the way is bitwise its op-by-op value."""
    fused_sums, reference_sums = [], []
    monkeypatch.setattr(lane, 'softplus_energies',
                        _recording(lane.softplus_energies, fused_sums))
    monkeypatch.setattr(lane, 'lane_dot', _recording(lane.lane_dot, fused_sums))
    fused = _run(case)
    monkeypatch.setattr(lane, 'softplus_energies',
                        _recording(_softplus_energies_op_by_op, reference_sums))
    monkeypatch.setattr(lane, 'lane_dot', _recording(_dot_op_by_op, reference_sums))
    reference = _run(case)
    assert len(fused_sums) == len(reference_sums) > 0
    for a, b in zip(fused_sums, reference_sums):
        assert _bits_equal(a, b), case
    assert len(fused) == len(reference)
    for a, b in zip(fused, reference):
        assert _bits_equal(a.float() if a.dtype == torch.bool else a,
                           b.float() if b.dtype == torch.bool else b), case


#: ``csrc/lane_ops.cu``: blocks of a cluster, slots a block, threads of a
#: block of ``lane_softplus_pixel_kernel`` (a warp a chain step of a group).
_CLUSTER, _SLOT_BLOCK, _SP_THREADS = 8, 32, 512
_SP_GROUP = _SP_THREADS // 32


def _pixel_kernel_sums(terms, kb, reverse=False):
    """``terms`` (L, S) float32 of one lane summed over L as
    ``lane_softplus_pixel_kernel`` schedules the sums at tile width ``kb``:
    for each tile and block q, group g's buffer [step][kl][l] is built by
    thread (warp w, lane l) from pixel ((g G + w) 256 + 32 q + l) (zeros
    past the chain or L), warp kl's lane l adds the group's G steps in
    order (``reverse``: the wrong order), the slot goes to block kl % 8's
    slots[kl // 8][32 q + l], and the owner's warp runs the slot tree."""
    L, S = terms.shape
    chain = -(-L // 256)
    groups = -(-chain // _SP_GROUP)
    out = np.zeros(S, np.float32)
    for k0 in range(0, S, kb):
        kn = min(kb, S - k0)
        owned_slots = np.zeros((_CLUSTER, 2, 256), np.float32)
        for q in range(_CLUSTER):
            acc = np.zeros((kn, _SLOT_BLOCK), np.float32)
            for g in range(groups):
                buf = np.zeros((_SP_GROUP, kn, _SLOT_BLOCK), np.float32)
                for w in range(_SP_GROUP):
                    c = g * _SP_GROUP + w
                    for l in range(_SLOT_BLOCK):
                        i = c * 256 + 32 * q + l
                        if c < chain and i < L:
                            buf[w, :, l] = terms[i, k0:k0 + kn]
                steps = range(_SP_GROUP - 1, -1, -1) if reverse else range(_SP_GROUP)
                for step in steps:
                    acc = (acc + buf[step]).astype(np.float32)
            for kl in range(kn):
                owned_slots[kl % _CLUSTER, kl // _CLUSTER, 32 * q:32 * q + 32] = acc[kl]
        for q in range(_CLUSTER):
            for u in range(2):
                kl = q + _CLUSTER * u
                if kl >= kn:
                    continue
                v = owned_slots[q, u].reshape(8, 32)  # v[r, l]: slot 32 r + l
                for m in (4, 2, 1):
                    v = (v[:m] + v[m:2 * m]).astype(np.float32)
                v = v[0]
                for m in (16, 8, 4, 2, 1):
                    v = (v + np.concatenate([v[m:], np.zeros(m, np.float32)])).astype(np.float32)
                out[k0 + kl] = v[0]
    return out


@pytest.mark.parametrize('L,S,kb', [(100, 1, 1), (256, 3, 3), (5001, 12, 3), (5001, 12, 2),
                                    (12288, 12, 4), (12288, 16, 16), (4100, 16, 9),
                                    (12288, 1, 1)])
def test_softplus_pixel_schedule_keeps_every_bit(L, S, kb):
    """The kernel's schedule gives the lane-sum order's bits for every
    output (positive terms, as the solver's, of mixed magnitudes); the same schedule
    with a group's steps added in reverse does not, at lengths of more than
    one group (so the comparison would see it)."""
    rng = np.random.RandomState(L + S + kb)
    terms = (np.logaddexp(rng.randn(L, S) * 4, 0)
             * 10.0 ** rng.randint(-3, 4, (L, S))).astype(np.float32)
    want = lane.lane_sum_in_kernel_order(terms.T)
    got = _pixel_kernel_sums(terms, kb)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if -(-L // 256) > 1:
        wrong = _pixel_kernel_sums(terms, kb, reverse=True)
        assert not np.array_equal(wrong.view(np.int32), want.view(np.int32))
