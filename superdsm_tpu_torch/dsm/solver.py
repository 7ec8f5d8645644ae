"""Batched damped-Newton minimization of the convex DSM energy ψ in PyTorch.

Port of :mod:`superdsm_tpu.dsm.solver`. The energy, gradient and Hessian
follow the reference ``superdsm/dsm.py:253-385``:

    ψ(θ, ξ) = Σ_p w_p softplus(-y_p s_p) + α (Σ_k sqrt(ξ_k² + ε) - K sqrt(ε))
    s = Q θ + G ξ          (Q: second-order polynomial basis, G: smooth matrix)

Every function works on a batch of padded problems (leading dimension B):
pixels carry a weight ``w ∈ {0,1}`` and deformation dimensions a mask
``kmask ∈ {0,1}``; padded dimensions get a unit diagonal in the Hessian so
the batched Cholesky stays positive definite. Problems are solved together
with a per-problem convergence freeze and a whole-batch early exit. Where
the JAX package used ``vmap`` the batch dimension is written out.

The JAX package jits each solve into one device program whose Newton loop
is a ``lax.while_loop``. On the card the port captures one Newton iteration
(gram, step, freeze updates) as a CUDA graph per solve and replays it
:data:`SYNC_EVERY` iterations at a time, reading the convergence flags (one
host sync) between chunks only. Lanes freeze one by one, so iterations
after the last lane converged change nothing. :func:`eager_loop` runs the
loop op by op instead, syncing every iteration (the counterpart of
``jax.disable_jit()``); on the CPU the chunked loop runs eagerly. PCG
(:func:`_pcg_solve`, at n > :data:`CHOLESKY_MAX_N`) is one launch of the
``lane_pcg`` kernel on the card in either loop, whose lanes each stop when
they are done (:data:`CG_MAX_ITERS` steps at most); on the CPU it is the
op-by-op chain that the kernel replaces. The Cholesky direction (at n <=
:data:`CHOLESKY_MAX_N`) is one launch of the ``lane_cholesky`` kernel on
the card; on the CPU LAPACK's.

Every product, sum and factorization of a lane goes through
:mod:`superdsm_tpu_torch.dsm.lane` (fixed order) or a library call whose
batched route gives each lane its own bits, so a lane's result does not
depend on its batch. The Newton
gram at n % 128 == 0 goes through
:func:`superdsm_tpu_torch.dsm.gram.fused_grad_hess_batched` (the CUDA kernel
on the card).
"""

import contextlib
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .._device import thread_device, to_device
from . import gram, lane

#: Hard iteration caps (the reference instead relies on a 300 s SIGALRM
#: timeout per solve, ``superdsm/dsm.py:478-490``).
DEFAULT_MAXITER = 50
DEFAULT_TOL = 1e-5
LS_STEPS = 12  # candidate step sizes 2^0 .. 2^-(LS_STEPS-1)
ARMIJO_C = 1e-4

MU_MIN = 1e-10
MU_MAX = 1e6
#: Multipliers of the scale sweep against the near-separable "creep".
SCALES = (0.7, 1.0, 1.4, 2.0, 3.0, 4.5, 6.5, 9.0)

#: Newton systems larger than this solve by Jacobi-preconditioned CG
#: instead of Cholesky (the JAX package's cutover, kept for parity of the
#: Newton trajectories; ``SDSM_CHOL_MAX_N`` moves it, as there).
CHOLESKY_MAX_N = int(os.environ.get('SDSM_CHOL_MAX_N', '300'))
CG_MAX_ITERS = 64
CG_RTOL = 1e-5

#: Newton iterations between two reads of the convergence flags (one host
#: sync each): on the card, replays of the captured iteration. The results
#: do not depend on it (frozen lanes stay frozen); chosen on an H100 by
#: ``chip_smoke.py`` (PERF.md).
SYNC_EVERY = 4

#: Counters of the Newton loops since :func:`reset_loop_stats`: solves,
#: iterations run (eager or replayed), host syncs of the convergence check,
#: CUDA graphs captured, their capture and instantiation seconds, their
#: replays and the device memory reserved while capturing (the graphs'
#: pools growing; other threads' allocations count too).
LOOP_STATS = {}
_LOOP_KEYS = ('solves', 'iterations', 'syncs', 'graphs', 'capture_s',
              'instantiate_s', 'replays', 'graph_bytes')
_stats_lock = threading.Lock()
_eager = {'depth': 0}
_capture_local = threading.local()


def reset_loop_stats():
    with _stats_lock:
        LOOP_STATS.update({k: 0 for k in _LOOP_KEYS})


reset_loop_stats()


def _note(**counts):
    with _stats_lock:
        for k, v in counts.items():
            LOOP_STATS[k] += v


@contextlib.contextmanager
def eager_loop():
    """Runs every Newton loop of the block op by op, with a host sync every
    iteration (and, on the CPU, PCG's early exit), instead of replaying a
    captured CUDA graph: the counterpart of ``jax.disable_jit()``. It holds
    for every thread of the process while the block runs. The results are
    bitwise those of the graph."""
    with _stats_lock:
        _eager['depth'] += 1
    try:
        yield
    finally:
        with _stats_lock:
            _eager['depth'] -= 1

_F32 = torch.float32

_LINALG_LOCK = threading.Lock()
_LINALG_LOADED = False


def _load_linalg(device):
    """Makes this process's first CUDA linear-algebra call under a lock.

    PyTorch loads its CUDA linear-algebra library on the first such call of
    the process, and that load is not thread-safe: threads whose first calls
    meet fail with "lazy wrapper should be called at most once" (worker
    threads of a fresh process, such as the batch CLI's forked task with its
    threaded file stream). Every solve calls this before its own linalg
    calls; after the first, it is one check of a flag."""
    global _LINALG_LOADED
    if _LINALG_LOADED or device.type != 'cuda':
        return
    with _LINALG_LOCK:
        if not _LINALG_LOADED:
            torch.linalg.cholesky_ex(torch.ones((1, 1), device=device))
            _LINALG_LOADED = True


#: ``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0).
_softplus = lane.softplus_plain


def _poly_basis(coords):
    """(..., 2) normalized coordinates -> (..., 6) basis features."""
    x1 = coords[..., 0]
    x2 = coords[..., 1]
    return torch.stack([x1 * x1, x2 * x2, 2 * x1 * x2, 2 * x1, 2 * x2,
                        torch.ones_like(x1)], dim=-1)


def _energy_from_surface(s, xi, yv, w, alpha, epsilon, kmask):
    """ψ given precomputed surface values ``s``. Shapes: s, yv, w: (..., P);
    xi, kmask: (..., K); alpha: scalar or (...,)."""
    data = lane.softplus_energies(s, yv, w)
    if xi.shape[-1] > 0:
        term2 = torch.sqrt(xi * xi + epsilon)
        reg = alpha * lane.lane_sum(kmask * (term2 - math.sqrt(epsilon)))
        reg = reg.clamp_min(0.0)
        return data + reg
    return data


def _surface(params, Q, G, kmask):
    s = Q @ params[..., :6, None]
    s = s[..., 0]
    if G is not None:
        s = s + (G @ (params[..., 6:] * kmask)[..., None])[..., 0]
    return s


def _features(Q, G):
    """Single feature matrix Bf = [Q | G] (G columns of padded dims are
    already zeroed by ``build_smooth_matrix``)."""
    if G is None:
        return Q
    return torch.cat([Q, G], dim=-1)


def _reg_terms(params, alpha, epsilon, kmask):
    """Smooth-L1 deformation regularizer: value, gradient, Hessian diagonal
    (batched: params (B, n), alpha (B,), kmask (B, K))."""
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


def _grad_hess(params, s, Q, G, yv, w, alpha, epsilon, kmask):
    """Analytic gradient and Hessian of psi at ``params`` (reference form,
    used by the numerical tests; the Newton loop uses the fused feature
    matrix version inside :func:`_newton_step`)."""
    Bf = _features(Q, G if G is None else G * kmask[..., None, :])
    g, H = gram.grad_hess_plain(Bf, s, yv, w)
    if params.shape[-1] > 6:
        _, reg_g, reg_h = _reg_terms(params, alpha, epsilon, kmask)
        ones6 = torch.ones(params.shape[:-1] + (6,), dtype=params.dtype,
                           device=params.device)
        g = (g + reg_g) * torch.cat([ones6, kmask], dim=-1)
        H = H + torch.diag_embed(reg_h)
    return g, H


_bmv = lane.matvec
_lsum = lane.lane_sum
_dot = lane.lane_dot


def _concat(outs):
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _batched(fn, *args, split_on_cpu=True):
    """``fn`` on the whole batch, for calls whose batched route gives each
    lane the bits of that lane alone at every batch size (the float64
    products of ``_lsq_init``, ``solve_ex`` at n = 6; held on the card by
    ``chip_smoke.py`` phase 12): on the card a batch of one goes in as the
    same lane twice, since cuBLAS and cuSOLVER take another route for a
    batch of one. On the CPU each lane alone if ``split_on_cpu`` (MKL splits
    a batched product's long sums over its threads by the batch), else the
    whole batch (LAPACK solves each matrix by itself)."""
    B = args[0].shape[0]
    if args[0].is_cuda:
        if B != 1:
            return fn(*args)
        out = fn(*(lane.lanes2(a).contiguous() for a in args))
        return tuple(o[:1] for o in out) if isinstance(out, tuple) else out[:1]
    if B <= 1 or not split_on_cpu:
        return fn(*args)
    return _concat([fn(*(a[b:b + 1] for a in args)) for b in range(B)])


def _pcg_solve(H, b, iters=CG_MAX_ITERS, rtol=CG_RTOL, early_exit=True):
    """Jacobi-preconditioned conjugate gradients for a batch of SPD systems.

    Residual-based: a lane iterates until ``||r|| <= rtol * ||b||`` or
    ``iters`` steps. Lanes that are done are frozen (their state is kept
    exactly), as the JAX package's vmapped ``while_loop`` freezes them. On
    the card one launch of the ``lane_pcg`` kernel runs every step of every
    lane (no host sync; each lane stops when it is done), bitwise the
    op-by-op chain :func:`lane.pcg_chain`, which runs on the CPU: there
    ``early_exit`` ends the loop when every lane is done (a host sync every
    :data:`lane.PCG_SYNC_EVERY` steps), else it runs all ``iters`` steps,
    with the same result.
    """
    return lane.pcg(H, b, iters, rtol, early_exit)


def _cholesky_direction(Hd, g):
    """``-Hd^-1 g`` by Cholesky; NaN in the lanes whose factorization fails
    (the guard of :func:`_newton_step` turns them into gradient steps, as
    the JAX ``cho_factor`` returns NaNs there). On the card one launch of
    the ``lane_cholesky`` kernel for the whole batch
    (:func:`lane.cholesky_kernel`: an order fixed by n alone, so a lane's
    bits do not depend on its batch; NaN in every entry of a failed lane).
    On the CPU LAPACK's ``cholesky_ex`` and ``cholesky_solve`` on the whole
    batch (LAPACK factors each matrix by itself; ``cholesky_ex`` reports a
    failure instead of raising)."""
    if Hd.is_cuda:
        return lane.cholesky_kernel(Hd, g)
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = -torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info != 0)[:, None],
                       torch.full((), float('nan'), dtype=g.dtype, device=g.device),
                       delta)


def _newton_step(params, mu, s, f0, g, H, Bf, yv, w, alpha, epsilon, kmask, tol):
    """One Levenberg-Marquardt-damped Newton iteration for a batch of lanes
    (see the JAX package's ``_newton_step`` for the rationale of the LM
    damping, the Armijo line search over one matvec and the multiplicative
    scale sweep). Shapes: params (B, n), mu/f0/alpha (B,), s/yv/w (B, P),
    g (B, n), H (B, n, n), Bf (B, P, n), kmask (B, K). On the card it makes
    no host sync (on the CPU PCG's early exit reads its lanes,
    :func:`_pcg_solve`)."""
    B, n = params.shape
    dt, dev = params.dtype, params.device
    if n > 6:
        _, reg_g, reg_h = _reg_terms(params, alpha, epsilon, kmask)
        g = (g + reg_g) * torch.cat(
            [torch.ones((B, 6), dtype=dt, device=dev), kmask], dim=1)
        H = H + torch.diag_embed(reg_h)

    scale_h = _lsum(torch.diagonal(H, dim1=-2, dim2=-1)) / n + 1e-12
    Hd = H + (mu * scale_h)[:, None, None] * torch.eye(n, dtype=dt, device=dev)
    if n > CHOLESKY_MAX_N:
        delta = -_pcg_solve(Hd, g)
    else:
        delta = _cholesky_direction(Hd, g)
    bad = ~torch.isfinite(delta).all(dim=1)
    delta = torch.where(bad[:, None],
                        -g / (torch.sqrt(_dot(g, g)) + 1.0)[:, None], delta)
    decrement = -_dot(g, delta)  # lambda^2 >= 0 for the Newton step

    # line search: s is affine in params, so one matvec covers all steps
    u = _bmv(Bf, delta)
    steps = 0.5 ** torch.arange(LS_STEPS, dtype=dt, device=dev)    # (S,)
    # sum_p w softplus(-(y (s + u steps))): one kernel on the card, no
    # (B, P, S) tensor
    data_cand = lane.softplus_energies(s, yv, w, steps, u)         # (B, S)
    sq_eps = math.sqrt(epsilon)
    if n > 6:
        xi_cand = params[:, 6:, None] + delta[:, 6:, None] * steps  # (B, K, S)
        term2c = torch.sqrt(xi_cand * xi_cand + epsilon)
        reg_cand = alpha[:, None] * _lsum(kmask[:, :, None] * (term2c - sq_eps), 1)
        f_cand = data_cand + reg_cand.clamp_min(0.0)
    else:
        f_cand = data_cand

    armijo = f_cand <= f0[:, None] - ARMIJO_C * steps * decrement[:, None]
    any_ok = armijo.any(dim=1)
    # torch.argmax refuses bool; on int it returns the FIRST maximum, the
    # first (largest) passing step
    first_ok = armijo.to(torch.int32).argmax(dim=1)
    best = torch.argmin(f_cand, dim=1)      # fallback: best decrease
    pick = torch.where(any_ok, first_ok, best)
    f_pick = f_cand.gather(1, pick[:, None])[:, 0]
    improved = f_pick < f0
    t_step = torch.where(improved, steps[pick], torch.zeros((), dtype=dt, device=dev))
    full_step = improved & (pick == 0)

    new_params = params + t_step[:, None] * delta
    new_s = s + t_step[:, None] * u
    new_f = torch.where(improved, f_pick, f0)

    # multiplicative scale sweep against the near-separable "creep"
    scales = _scales(dt, dev)
    data_sc = lane.softplus_energies(new_s, yv, w, scales)         # (B, S)
    if n > 6:
        xi_sc = new_params[:, 6:, None] * scales
        term2sc = torch.sqrt(xi_sc * xi_sc + epsilon)
        reg_sc = (alpha[:, None] * _lsum(kmask[:, :, None] * (term2sc - sq_eps), 1)
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

    new_mu = torch.where(full_step, (mu * 0.25).clamp_min(MU_MIN),
                         torch.where(improved, mu, (mu * 8.0).clamp_max(MU_MAX)))
    tiny_gain = (f0 - new_f) <= tol * (1.0 + f0.abs())
    converged = (((0.5 * decrement <= tol * (1.0 + f0.abs())) & (mu <= 1e-4)
                  & tiny_gain)
                 | ((~improved) & (mu >= MU_MAX) & tiny_gain))
    return new_params, new_s, new_f, converged, new_mu


def _lsq_init(Q, yv, w, margin=2.0, ridge=1e-6):
    """Closed-form elliptical initialization: ridge regression of the
    polynomial surface onto ``margin * sign(y)`` (one batched 6x6 solve).
    A singular system (e.g. an empty padding lane) gives zeros, as the JAX
    package's non-finite guard does — never a raise."""
    _load_linalg(Q.device)
    z = margin * torch.sign(yv) * w
    # the pixel sums accumulate in float64, as the gram's do (see
    # gram.grad_hess_plain), one lane at a time as there; the 6x6 solve
    # stays float32
    Qd = Q.double()
    A, b = _batched(lambda Qw, Qd, z: (torch.einsum('bpi,bpj->bij', Qw, Qd),
                                       torch.einsum('bpi,bp->bi', Qd, z)),
                    Qd * w.double()[..., None], Qd, z.double())
    A, b = A.float(), b.float()
    tr = _lsum(torch.diagonal(A, dim1=-2, dim2=-1))
    A = A + ridge * tr[:, None, None] * torch.eye(6, dtype=Q.dtype, device=Q.device)
    theta, info = _batched(lambda A, b: torch.linalg.solve_ex(A, b), A, b[..., None],
                           split_on_cpu=False)
    theta = theta[..., 0]
    ok = torch.isfinite(theta) & (info == 0)[:, None]
    return torch.where(ok, theta, torch.zeros((), dtype=Q.dtype, device=Q.device))


def _better_of(Q, yv, w, theta_a, theta_b):
    """Per-problem pick of the lower-logistic-energy 6-parameter start."""
    def f_of(theta):
        s = _bmv(Q, theta)
        return lane.softplus_energies(s, yv, w)
    return torch.where((f_of(theta_b) < f_of(theta_a))[:, None], theta_b, theta_a)


_SCALES_ON = {}


def _scales(dtype, device):
    """:data:`SCALES` on ``device``, copied from the host once (such a copy
    waits for the card, and a CUDA graph capture cannot make it: each solve
    runs its first iteration before it captures one)."""
    key = (dtype, device)
    if key not in _SCALES_ON:
        _SCALES_ON[key] = torch.tensor(SCALES, dtype=dtype, device=device)
    return _SCALES_ON[key]


def _capture_context(device):
    """This thread's capture context on ``device``: a dict with its capture
    stream, its graph memory pool and the last graph captured into it. A
    graph is captured on a stream of its own and replayed on the current
    one. The graphs of one thread share a pool, each replayed only before
    the next one is captured (a solve's ``cheap`` graph before its full
    one; a solve's graphs are done before the next solve captures); the
    last graph is kept, since a pool that no graph holds is freed and its
    handle cannot be used again."""
    by_device = getattr(_capture_local, 'by_device', None)
    if by_device is None:
        by_device = _capture_local.by_device = {}
    if device not in by_device:
        by_device[device] = dict(stream=torch.cuda.Stream(device),
                                 pool=torch.cuda.graph_pool_handle(), last=None)
    return by_device[device]


class _Graph:
    """One Newton iteration captured as a CUDA graph, replayed on the
    current stream; each replay counts the kernel launches the capture
    recorded (:func:`gram.count_replayed`). A failed capture raises."""

    def __init__(self, iteration, device):
        cur = torch.cuda.current_stream(device)
        ctx = _capture_context(device)
        side = ctx['stream']
        side.wait_stream(cur)
        self.graph = torch.cuda.CUDAGraph()
        mem0 = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), gram.recording_launches() as records:
            # thread_local: other threads' streams run on while this one
            # captures (the batch CLI's and the mosaic's worker threads)
            self.graph.capture_begin(pool=ctx['pool'],
                                     capture_error_mode='thread_local')
            try:
                iteration()
            finally:
                t1 = time.perf_counter()
                self.graph.capture_end()
        t2 = time.perf_counter()
        ctx['last'] = self.graph
        cur.wait_stream(side)
        self.records = records
        _note(graphs=1, capture_s=t1 - t0, instantiate_s=t2 - t1,
              graph_bytes=torch.cuda.memory_reserved(device) - mem0)

    def __call__(self):
        self.graph.replay()
        gram.count_replayed(self.records)
        _note(replays=1)


def _solve_batch_impl(params0, Q, G, yv, w, alpha, epsilon, kmask, maxiter, tol,
                      banded=False):
    """Batch Newton driver with per-problem freeze.

    One iteration (the gram, :func:`_newton_step` and the freeze updates)
    updates the loop state in place and makes no host sync. On the card it
    runs eagerly once per solve (which loads every library it calls), is
    then captured as a CUDA graph and replayed; the host reads ``conv.all()``
    every :data:`SYNC_EVERY` iterations and never lets a chunk cross
    ``maxiter`` or the end of the hybrid schedule (whose ``cheap`` gram is a
    graph of its own). Under :func:`eager_loop`, or on the CPU, the same
    iteration runs op by op (on the card with a sync every iteration).

    :param banded: the feature matrix is band-structured (DSM solves): on the
        card, the gram at n in ``gram.BANDED_N`` runs the kernel's banded
        mode with a band table computed once here (G never changes across
        Newton iterations). The gram's precision follows the knobs
        ``gram.GRAM_PASSES`` and ``gram.HYBRID_ITERS``, read at each call.
    :return: ``(params, energy, conv, iterations, surface, it_lane)``;
        ``iterations`` is the 0-dim device tensor ``it_lane.max()``, the
        iterations until the last lane converged (or ``maxiter``).
    """
    B, n_total = params0.shape
    dev = Q.device
    _load_linalg(dev)
    Bf = _features(Q, G)
    P = Bf.shape[1]
    use_kernel = n_total % 128 == 0 and P % 256 == 0
    band = None
    if use_kernel and banded and Bf.is_cuda and n_total in gram.BANDED_N:
        band = gram.band_ranges(Bf, w)

    def grad_hess_b(s, active, cheap):
        if use_kernel:
            return gram.fused_grad_hess_batched(Bf, s, yv, w, active=active,
                                                band=band, cheap=cheap)
        # the JAX package's XLA path at GRAM_PRECISION (a straight product)
        return gram.grad_hess_plain(Bf, s, yv, w, passes=gram.GRAM_PASSES)

    # the first HYBRID_ITERS iterations take the 1-pass dense gram, where
    # the kernel serves the shape (the JAX package's Pallas condition)
    hybrid_iters = gram.HYBRID_ITERS if use_kernel else 0
    graphed = Bf.is_cuda and _eager['depth'] == 0

    # the loop state, updated in place by each iteration
    params = params0.clone()
    s = _bmv(Bf, params0)
    fval = _energy_from_surface(s, params0[:, 6:], yv, w, alpha, epsilon, kmask)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    mu = torch.full((B,), 1e-6, dtype=params0.dtype, device=dev)
    it_lane = torch.zeros(B, dtype=torch.int32, device=dev)
    it_dev = torch.zeros((), dtype=torch.int32, device=dev)

    def iteration(cheap):
        # frozen lanes skip the gram work in the kernel; their g/H come back
        # zero and only feed the masked-out step below
        g_b, H_b = grad_hess_b(s, (~conv).to(torch.int32), cheap)
        new_params, new_s, new_f, new_conv, new_mu = _newton_step(
            params, mu, s, fval, g_b, H_b, Bf, yv, w, alpha, epsilon, kmask, tol)
        keep = conv[:, None]
        it_dev.add_(1)
        params.copy_(torch.where(keep, params, new_params))
        s.copy_(torch.where(keep, s, new_s))
        fval.copy_(torch.where(conv, fval, new_f))
        mu.copy_(torch.where(conv, mu, new_mu))
        it_lane.copy_(torch.where(conv, it_lane, it_dev))
        conv.logical_or_(new_conv)

    graphs = {}  # cheap -> its captured iteration, after one eager run

    def run(cheap):
        if cheap in graphs:
            graphs[cheap]()
            return
        iteration(cheap)
        if graphed:
            graphs[cheap] = _Graph(lambda: iteration(cheap), dev)

    chunk = SYNC_EVERY if graphed or not Bf.is_cuda else 1
    it = 0
    while it < maxiter and B > 0:
        cheap = it < hybrid_iters
        steps = min(chunk, maxiter - it, hybrid_iters - it if cheap else maxiter)
        for _ in range(steps):
            run(cheap)
        it += steps
        _note(iterations=steps, syncs=1)
        if bool(conv.all()):
            break
    _note(solves=1)
    graphs.clear()

    # exact final energies and surfaces at the solution
    s_final = _bmv(Bf, params)
    f_final = _energy_from_surface(s_final, params[:, 6:], yv, w, alpha,
                                   epsilon, kmask)
    iterations = it_lane.max() if B > 0 else it_dev
    return params, f_final, conv, iterations, s_final, it_lane


@dataclass
class SolverResult:
    """Batched solver output (host numpy arrays, padded shapes)."""
    params: np.ndarray      # (B, 6+K)
    energy: np.ndarray      # (B,)
    converged: np.ndarray   # (B,)
    iterations: int
    surface: np.ndarray     # (B, P) surface values at mask pixels


def _host(t):
    return t.detach().cpu().numpy()


def solve_polynomial_batch(coords, yv, w, params0=None, alpha=0.0,
                           maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL):
    """Solves a batch of 6-parameter (elliptical) problems.

    :param coords: (B, P, 2) normalized pixel coordinates (padded).
    :param yv: (B, P) offset intensities.
    :param w: (B, P) pixel weights (0 = padding).
    :param params0: (B, 6) initialization (zeros by default).
    """
    coords = to_device(coords, _F32)
    yv = to_device(yv, _F32)
    w = to_device(w, _F32)
    B = coords.shape[0]
    dev = coords.device
    if params0 is None:
        params0 = torch.zeros((B, 6), dtype=_F32, device=dev)
    else:
        params0 = to_device(params0, _F32)
    alpha_arr = torch.full((B,), float(alpha), dtype=_F32, device=dev)
    kmask0 = torch.zeros((B, 0), dtype=_F32, device=dev)
    Q = _poly_basis(coords)
    params, f, conv, it, s, _ = _solve_batch_impl(
        params0, Q, None, yv, w, alpha_arr, 1.0, kmask0, int(maxiter), float(tol))
    return SolverResult(_host(params), _host(f), _host(conv), int(it), _host(s))


# ---------------------------------------------------------------------------
# Packed entry points: int16 crop-local pixel coordinates and int16-quantized
# intensities come in; normalized coordinates, the pixel-validity mask and
# the polynomial basis are rebuilt on the device; the foreground comes back
# bit-packed. The elliptical initialization and the full DSM solve run in one
# call.
# ---------------------------------------------------------------------------

def _unpack_inputs(pix, off, cnt, yq, yscale, denom):
    """Rebuilds float inputs from the packed format: int16 pixel coordinates
    and int16-quantized intensities (yv = yq * yscale / 32767)."""
    pixf = pix.to(_F32)
    coords = (pixf + off.to(_F32)[:, None, :]) * (1.0 / denom)[None, None, :]
    P = pix.shape[1]
    col = torch.arange(P, dtype=torch.int32, device=pix.device)[None, :]
    w = (col < cnt[:, None]).to(_F32)
    yv = yq.to(_F32) * (yscale * (1.0 / 32767.0))[:, None]
    return pixf, coords, yv, w


_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _packbits_fg(fg_bool):
    """Packs a (B, P) boolean foreground into (B, P // 8) uint8 on device
    (MSB-first, ``np.unpackbits`` layout). Requires P % 8 == 0 (every
    ``batching.P_BUCKETS`` entry is a multiple of 2048)."""
    B, P = fg_bool.shape
    bits = fg_bool.reshape(B, P // 8, 8).to(torch.int32)
    weights = torch.tensor(_PACK_WEIGHTS, dtype=torch.int32, device=fg_bool.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpack_fg(fg_packed, n_pixels):
    """Host-side inverse of :func:`_packbits_fg` for one row: returns the
    first ``n_pixels`` mask values as bool."""
    return np.unpackbits(np.asarray(fg_packed), count=n_pixels).astype(bool)


def _solve_poly_core(coords, yv, w, params0, maxiter, tol):
    """Shared body of the packed 6-parameter solve; returns (params, energy,
    conv, bad, fg uint8, per-lane convergence iterations).

    ``bad`` mirrors the reference's fallback rule
    (``superdsm/objects.py:394-411``): a non-converged solve that ended
    worse than the initialization, or a non-finite one, returns the
    initialization instead."""
    Q = _poly_basis(coords)
    B = coords.shape[0]
    dev = coords.device
    kmask0 = torch.zeros((B, 0), dtype=_F32, device=dev)
    alpha = torch.zeros(B, dtype=_F32, device=dev)
    s_init = _bmv(Q, params0)
    f_init = lane.softplus_energies(s_init, yv, w)
    start = _better_of(Q, yv, w, params0, _lsq_init(Q, yv, w))
    params, f, conv, it, s, it_lane = _solve_batch_impl(
        start, Q, None, yv, w, alpha, 1.0, kmask0, maxiter, tol)
    bad = ~torch.isfinite(f) | (~conv & (f > f_init))
    params = torch.where(bad[:, None], params0, params)
    f = torch.where(bad, f_init, f)
    s = torch.where(bad[:, None], s_init, s)
    fg = _packbits_fg((s > 0) & (w > 0))
    return params, f, conv, bad, fg, it_lane


def _solve_poly_packed(pix, off, cnt, yq, yscale, denom, params0, maxiter, tol):
    """Packed 6-parameter solve (numpy in, device tensors out)."""
    _, coords, yv, w = _unpack_inputs(
        to_device(pix, torch.int32), to_device(off, torch.int32),
        to_device(cnt, torch.int32), to_device(yq, torch.int32),
        to_device(yscale, _F32), to_device(denom, _F32))
    return _solve_poly_core(coords, yv, w, to_device(params0, _F32),
                            int(maxiter), float(tol))


def _solve_dsm_core(pixf, coords, yv, w, sub, kmask, warm, use_warm,
                    alpha, epsilon, maxiter, tol, sigma, cutoff, all_warm=None):
    """Combined elliptical + DSM solve of one packed batch.

    The full solve starts from the better of the elliptical solution and the
    optional warm start. Returns (params, energy, energy_elliptical, conv,
    bad, fg uint8, per-lane convergence iterations), where ``bad`` rows are
    restored to their initialization (reference fallback semantics,
    ``superdsm/objects.py:394-411``).

    ``all_warm`` (None: ``use_warm.all()``) skips the elliptical phase; a
    batch split over devices passes the whole chunk's value, so that each
    part takes the branch the whole chunk takes (:func:`solve_on_devices`).
    """
    from .smooth import build_smooth_matrix
    B, P = pixf.shape[:2]
    K = sub.shape[1]
    dev = pixf.device
    Q = _poly_basis(coords)

    # all-warm batches skip the elliptical phase (one host sync per solve)
    if bool(use_warm.all()) if all_warm is None else all_warm:
        p_ell = torch.zeros((B, 6), dtype=_F32, device=dev)
        f_ell = torch.full((B,), float('inf'), dtype=_F32, device=dev)
    else:
        kmask0 = torch.zeros((B, 0), dtype=_F32, device=dev)
        p_ell, f_ell, _, _, _, _ = _solve_batch_impl(
            _lsq_init(Q, yv, w), Q, None, yv, w,
            torch.zeros(B, dtype=_F32, device=dev), 1.0, kmask0, maxiter, tol)

    G = build_smooth_matrix(pixf, sub.to(_F32), sigma, cutoff, kmask)
    p_ell_full = torch.cat([p_ell, torch.zeros((B, K), dtype=_F32, device=dev)], dim=1)

    Bf = torch.cat([Q, G], dim=2)
    s_warm = _bmv(Bf, warm)
    f_warm = _energy_from_surface(s_warm, warm[:, 6:], yv, w, alpha, epsilon, kmask)
    # ~(f_ell < f_warm): a NaN warm energy still takes the warm start, so
    # the fallback below restores it
    take_warm = use_warm & ~(f_ell < f_warm)
    params0 = torch.where(take_warm[:, None], warm, p_ell_full)
    f_init = torch.where(take_warm, f_warm, f_ell)

    params, f, conv, it, s, it_lane = _solve_batch_impl(
        params0, Q, G, yv, w, alpha, epsilon, kmask, maxiter, tol, banded=True)
    bad = ~torch.isfinite(f) | (~conv & (f > f_init))
    s_init = _bmv(Bf, params0)
    params = torch.where(bad[:, None], params0, params)
    f = torch.where(bad, f_init, f)
    s = torch.where(bad[:, None], s_init, s)
    fg = _packbits_fg((s > 0) & (w > 0))
    return params, f, f_ell, conv, bad, fg, it_lane


def _solve_dsm_packed(pix, off, cnt, yq, yscale, denom, sub, kmask, warm, use_warm,
                      alpha, epsilon, maxiter, tol, sigma, cutoff, all_warm=None):
    """Packed combined elliptical + DSM solve (numpy in, device tensors
    out); see :func:`_solve_dsm_core`."""
    pixf, coords, yv, w = _unpack_inputs(
        to_device(pix, torch.int32), to_device(off, torch.int32),
        to_device(cnt, torch.int32), to_device(yq, torch.int32),
        to_device(yscale, _F32), to_device(denom, _F32))
    return _solve_dsm_core(
        pixf, coords, yv, w, to_device(sub, torch.int32), to_device(kmask, _F32),
        to_device(warm, _F32), to_device(use_warm, torch.bool),
        to_device(alpha, _F32), float(epsilon), int(maxiter), float(tol),
        float(sigma), int(cutoff), all_warm)


def solve_on_devices(solve, args, devices, **kwargs):
    """Runs a packed solve (:func:`_solve_poly_packed`,
    :func:`_solve_dsm_packed`) with its lanes split over ``devices``: each
    device solves its contiguous share of the lanes (``np.array_split``
    order) in a thread of its own, on that thread's stream of the device
    (:func:`superdsm_tpu_torch.parallel.worker_stream`), so the shares'
    Newton loops, which each wait on the host every few iterations, run at
    the same time; the outputs come back concatenated in lane order on the
    first device. ``None`` solves on the selected device in this thread.
    Every array argument but ``denom`` (position 5) has the lane axis
    first; the rest are scalars. Lanes freeze one by one in the Newton
    loop, so a lane's iterates do not depend on which others share its
    batch."""
    from ..parallel.pipelined import worker_stream
    if devices is None:
        return solve(*args, **kwargs)
    B = len(args[0])
    if B < len(devices):
        raise ValueError(f'{B} lanes cannot be split over {len(devices)} devices')

    def share(device, lanes):
        sub = tuple(a[lanes[0]:lanes[-1] + 1]
                    if i != 5 and isinstance(a, np.ndarray) else a
                    for i, a in enumerate(args))
        with thread_device(device), worker_stream() as stream:
            outs = solve(*sub, **kwargs)
            if stream is not None:
                stream.synchronize()  # read below on the caller's stream
        return outs

    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        parts = list(pool.map(share, devices,
                              np.array_split(np.arange(B), len(devices))))
    home = parts[0][0].device
    for t in (t for p in parts for t in p if t.is_cuda):
        # freed after the caller's stream has read them, not before
        t.record_stream(torch.cuda.current_stream(t.device))
    return tuple(torch.cat([p[k].to(home) for p in parts])
                 for k in range(len(parts[0])))


def _pack_poly_group(problems, img_shape, params0=None,
                     maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL, pb=None, Bp=None,
                     devices=None):
    """Packs one bucket batch and runs the packed 6-parameter solve, its
    lanes split over ``devices`` (:func:`solve_on_devices`); returns the
    device outputs (the caller copies them to the host)."""
    PIX = np.zeros((Bp, pb, 2), np.int16)
    OFF = np.zeros((Bp, 2), np.int32)
    CNT = np.zeros((Bp,), np.int32)
    YQ = np.zeros((Bp, pb), np.int16)
    YS = np.zeros((Bp,), np.float32)
    P0 = np.zeros((Bp, 6), np.float32)
    for j, p in enumerate(problems):
        npix = p.n_pixels
        PIX[j, :npix] = p.pts
        OFF[j] = p.offset
        CNT[j] = npix
        YQ[j, :npix] = p.yq
        YS[j] = p.yscale
        if params0 is not None and params0[j] is not None:
            P0[j] = params0[j][:6]
    denom = np.maximum(np.asarray(img_shape, np.float32) - 1.0, 1.0)
    return solve_on_devices(_solve_poly_packed,
                            (PIX, OFF, CNT, YQ, YS, denom, P0, maxiter, tol),
                            devices)


def pack_and_solve_poly(problems, img_shape, params0=None,
                        maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL, pb=None, Bp=None):
    """Host-side packing for :func:`_solve_poly_packed` over one bucket batch.

    :param problems: list of Problem-likes (``pts`` int, ``offset``, ``yv``).
    :return: list of ``(params, energy, converged, fg_bool)`` per problem.
    """
    out = _pack_poly_group(problems, img_shape, params0=params0,
                           maxiter=maxiter, tol=tol, pb=pb, Bp=Bp)
    params, f, conv, bad, fg, _it = (_host(t) for t in out)
    return [(params[j], float(f[j]), bool(conv[j]) and not bool(bad[j]),
             unpack_fg(fg[j], problems[j].n_pixels)) for j in range(len(problems))]


def _eval_fg_packed(pixf, off, cnt, denom, sub, kmask, params, sigma, cutoff):
    """Evaluates ``s(x) > 0`` of a fitted surface at packed pixels (one
    chunk). Used to recover the full-resolution foreground of regions that
    were solved on a pixel subsample."""
    coords = (pixf + off.to(_F32)[None, :]) * (1.0 / denom)[None, :]
    P = pixf.shape[0]
    idx = torch.arange(P, dtype=torch.int32, device=pixf.device)
    w = (idx < cnt).to(_F32)
    s = _poly_basis(coords) @ params[:6]
    if sub.shape[0] > 0:
        from .smooth import build_smooth_matrix
        G = build_smooth_matrix(pixf, sub, sigma, cutoff, kmask)
        s = s + G @ (params[6:] * kmask)
    return ((s > 0) & (w > 0)).to(torch.uint8)


def evaluate_foreground(problem, params, sigma, cutoff, chunk=524288):
    """Full-resolution foreground of ``problem`` from fitted ``params``,
    evaluated in pixel chunks on the device (bounds the (P, K) smooth-matrix
    slice regardless of region size)."""
    from .batching import K_BUCKETS, _bucket
    npix, k = problem.n_pixels, problem.n_deform
    if k > 0 and np.isfinite(sigma):
        kb = _bucket(max(k, 1), K_BUCKETS[1:])
        SUB = np.full((kb, 2), -10 * (cutoff + 1), np.int16)
        SUB[:k] = problem.sub
        KM = np.zeros(kb, np.float32)
        KM[:k] = 1.0
        PAR = np.zeros(6 + kb, np.float32)
        PAR[:6] = params[:6]
        PAR[6:6 + k] = params[6:6 + k]
    else:
        SUB = np.zeros((0, 2), np.int16)
        KM = np.zeros(0, np.float32)
        PAR = np.asarray(params[:6], np.float32)
    denom = to_device(np.maximum(np.asarray(problem.img_shape, np.float32) - 1.0, 1.0), _F32)
    off = to_device(np.asarray(problem.offset, np.int32), torch.int32)
    sub, km, par = to_device(SUB, _F32), to_device(KM, _F32), to_device(PAR, _F32)
    sig = float(sigma) if np.isfinite(sigma) else 1.0
    pending = []
    for start in range(0, npix, chunk):
        n = min(chunk, npix - start)
        PIX = np.zeros((chunk, 2), np.int16)
        PIX[:n] = problem.pts[start:start + n]
        pending.append((start, n, _eval_fg_packed(
            to_device(PIX, _F32), off, n, denom, sub, km, par, sig, int(cutoff))))
    # launch every chunk, then copy to the host
    fg = np.zeros(npix, bool)
    for start, n, chunk_fg in pending:
        fg[start:start + n] = _host(chunk_fg)[:n].astype(bool)
    return fg



def solve_problem_traced(problem, alpha=0.5, epsilon=1.0, smooth_amount=10,
                         gaussian_shape_multiplier=2,
                         maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL):
    """Debug re-solve of ONE problem recording the energy after every few
    Newton iterations (the replacement for the reference's per-object Ray
    worker logs, ``superdsm/objects.py:220-233``). Runs the batch solver at
    increasing iteration caps and returns a dict with the energy trace, the
    status and the solution, with the JAX package's keys."""
    from .batching import solve_problems

    trace = []
    last = None
    for it in range(0, maxiter + 1, max(1, maxiter // 16)):
        res = solve_problems([problem], alpha=alpha, epsilon=epsilon,
                             smooth_amount=smooth_amount,
                             gaussian_shape_multiplier=gaussian_shape_multiplier,
                             maxiter=max(it, 1), tol=tol)[0]
        trace.append({'iterations': max(it, 1), 'energy': float(res.energy)})
        last = res
    return {
        'n_pixels': int(problem.n_pixels),
        'n_deform': int(problem.n_deform),
        'status': last.status,
        'energy': float(last.energy),
        'params': np.asarray(last.params).tolist(),
        'energy_trace': trace,
        'warm_started': problem.init_params is not None,
    }
