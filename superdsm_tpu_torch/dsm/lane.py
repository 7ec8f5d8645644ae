"""Per-lane products and sums of the batched Newton solver.

Each output of :func:`matvec`, :func:`lane_sum`, :func:`lane_dot`,
:func:`softplus_energies` and :func:`pcg` belongs to one lane (the leading
axis) and is summed in an order fixed by the reduced length alone, so a
lane's result does not depend on which lanes share its batch. A library's
batched product or reduction does not promise that: cuBLAS picks its
kernel and PyTorch's CUDA reductions split a sum across threads and blocks
from the whole launch, and on the CPU a batch of one takes BLAS's
matrix-vector route while a batch of two takes its matrix-matrix one.
:func:`cholesky_kernel` factors and solves each lane's Newton system in an
order fixed by n alone, where cuSOLVER's batched routes give a lane other
bits than a batch of one.

Two implementations of each function live here:

- the hand-written CUDA kernels of ``csrc/lane_ops.cu`` (built and loaded
  as the gram kernels are, :mod:`superdsm_tpu_torch.dsm.gram`), for CUDA
  tensors;
- the plain PyTorch versions (``*_plain``), for CPU tensors, where a batch
  of one computes what a batch of two computes.

:func:`lane_dot` and :func:`softplus_energies` are sums of terms that the
solver used to build op by op into a tensor before :func:`lane_sum` read
it back; their kernels build each term in registers, rounding every
intermediate as that op-by-op expression does (their plain versions are
the expression), and sum the terms in :func:`lane_sum`'s order, so they
give its bits without the tensor. :func:`pcg` runs the solver's whole
Jacobi-preconditioned CG (:func:`pcg_chain`, a chain of :func:`matvec`,
:func:`lane_dot` and elementwise ops, some 17 launches a step) as one
kernel launch with the chain's bits on the card. :func:`cholesky_kernel`
runs the Newton direction ``-Hd^-1 g`` of every lane in one launch,
bitwise :func:`cholesky_chain` on the card; on the CPU the solver keeps
LAPACK (``solver._cholesky_direction``). :func:`lm_system` and
:func:`step_guard` are the two ends of a Newton step around the direction
solve (the damped system; the guard, decrement, line-search regularizer
candidates and Armijo thresholds), each bitwise its plain version, which
is the solver's former op-by-op expression (its sums :func:`lane_sum` and
:func:`lane_dot`); on the card :func:`newton_direction` runs both with
the direction between them as one launch (the damped system formed where
the direction kernel loads H, the guard where it holds the direction),
bitwise the three launches :func:`lm_system_kernel`, the direction kernel
and :func:`step_guard_kernel`. :func:`step_pick` and :func:`step_tail`,
the rest of the step (the line search's pick; the scale sweep's
regularizer sums and pick, the new mu, the convergence test and, in the
loop, the freeze writes), are one launch each on the card; in the Newton
loop :func:`step_sweep` runs the pick, the scale sweep's sums and the tail
as one launch (the pick its prologue, the tail in each lane's last
cluster), bitwise those three launches.

Every kernel launch adds one to :data:`LAUNCHES` (through
:func:`gram._count_launch`, so a captured CUDA graph counts its launches at
each replay).
"""

import math
from collections import namedtuple

import numpy as np
import torch

from . import gram

#: Kernel launches per kernel (``softplus``: the elementwise check of
#: :func:`softplus_kernel`, which no solver path launches).
LAUNCHES = {'lane_matvec': 0, 'lane_sum': 0, 'lane_dot': 0,
            'softplus_energies': 0, 'lane_pcg': 0, 'lane_cholesky': 0,
            'lane_lm_system': 0, 'lane_step_guard': 0, 'lane_chol_step': 0,
            'lane_pcg_step': 0, 'lane_step_pick': 0, 'lane_step_tail': 0,
            'lane_step_sweep': 0, 'softplus': 0}


def reset_launch_counts():
    gram.reset_launch_counts(LAUNCHES)


#: Callables told of every lane-kernel launch with its kernel's name and
#: shape (``lane_matvec`` (B, P, n), ``lane_sum`` (B, S, L) or (B, L)
#: summed over L, ``lane_dot`` (B, n), ``softplus_energies`` (mode, B, P),
#: ``lane_pcg``, ``lane_cholesky``, ``lane_lm_system``,
#: ``lane_step_guard`` and the direction launches ``lane_chol_step`` and
#: ``lane_pcg_step`` (B, n), ``lane_step_pick``, ``lane_step_tail`` and
#: ``lane_step_sweep`` (B, P, n), P = 0 without a surface);
#: under a replayed CUDA graph at each replay, as
#: :func:`gram._count_launch` counts.
LAUNCH_HOOKS = []


#: Slots of a lane sum (``csrc/lane_ops.cu``, ``ROW_THREADS``; checked
#: against the library when it loads).
ROW_THREADS = gram.LANE_CONSTANTS['row_threads']

#: :func:`cholesky_kernel`'s routes by number (:func:`cholesky_route`): one
#: block a lane up to ``CHOL_ONE_BLOCK_MAX_N`` (and up to n = 128 when a
#: batch has more lanes than the card holds 8-block clusters at once); a
#: cluster of eight blocks a lane, in panels of eight columns held in
#: shared memory, up to ``CHOL_CLUSTER_MAX_N``; a cluster of sixteen blocks
#: a lane, its panels in shared memory, up to ``CHOL_WIDE_MAX_N``; and
#: above, sixteen blocks whose panels live in the lane's global scratch
#: (``csrc/lane_ops.cu``; the bounds checked against the library when it
#: loads, and that the card holds a cluster of each).
CHOL_ROUTES = ('one block a lane, shared memory', 'cluster of 8, panels in shared memory',
               'cluster of 16, panels in shared memory',
               'cluster of 16, panels in the global scratch')
CHOL_ONE_BLOCK_MAX_N = gram.LANE_CONSTANTS['chol_one_block_max_n']
CHOL_CLUSTER_MAX_N = gram.LANE_CONSTANTS['chol_cluster_max_n']
CHOL_WIDE_MAX_N = gram.LANE_CONSTANTS['chol_wide_max_n']

#: :func:`pcg_kernel` keeps a lane's H in its cluster's registers up to this
#: n, in shared memory and L2 above (``csrc/lane_ops.cu``; the same bits,
#: checked against the library when it loads).
PCG_REG_MAX_N = gram.LANE_CONSTANTS['pcg_reg_max_n']

#: :func:`softplus_energies` modes of the C entry point.
_LINE_SEARCH, _SCALE_SWEEP, _SINGLE = 0, 1, 2
_MODE_NAMES = {_LINE_SEARCH: 'line_search', _SCALE_SWEEP: 'scale_sweep',
               _SINGLE: 'energy'}

def lane_sum_in_kernel_order(x):
    """The row sums of ``x`` (R, L) in the order of the lane-sum kernels, on
    the host in float32 (numpy), to hold the kernels to their order bitwise:
    slot t of :data:`ROW_THREADS` adds x[t], x[t + ROW_THREADS], ... in
    turn, from 0; then a tree adds slot t + m into slot t for m =
    ROW_THREADS / 2, ..., 1. Each float32 addition rounds as the card's
    does, and a slot's sum is never -0, so the zeros that pad L to a
    multiple of ROW_THREADS change nothing."""
    x = np.asarray(x, np.float32)
    R, L = x.shape
    cols = -(-L // ROW_THREADS) * ROW_THREADS
    padded = np.zeros((R, cols), np.float32)
    padded[:, :L] = x
    acc = np.zeros((R, ROW_THREADS), np.float32)
    for k in range(0, cols, ROW_THREADS):
        acc = acc + padded[:, k:k + ROW_THREADS]
    m = ROW_THREADS // 2
    while m:
        acc[:, :m] = acc[:, :m] + acc[:, m:2 * m]
        m //= 2
    return acc[:, 0]


def lanes2(t):
    """A batch of one as a batch of two (the same lane twice, no copy): the
    libraries' batched routes, which a batch of two or more takes."""
    return t.expand((2,) + tuple(t.shape[1:]))


def matvec_plain(A, x):
    """``A (B, P, n) @ x (B, n) -> (B, P)`` with ``torch.matmul``."""
    if A.shape[0] == 1:
        return (lanes2(A) @ lanes2(x)[..., None])[:1, :, 0]
    return (A @ x[..., None])[..., 0]


def lane_sum_plain(x, dim=-1):
    """``x.sum(dim)``; a batch of one is summed as one of two (PyTorch's CPU
    sum splits a single long row across threads)."""
    if x.shape[0] == 1:
        return lanes2(x).sum(dim)[:1]
    return x.sum(dim)


def lane_dot_plain(a, b):
    """``sum_i a_i b_i`` per lane: the product, then :func:`lane_sum_plain`."""
    return lane_sum_plain(a * b)


def softplus_plain(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``torch.logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softplus_terms(s, y, w, c=None, u=None):
    """The terms of :func:`softplus_energies`, op by op as the solver built
    them, and the axis they are summed over: ``s, y, w`` (B, P);

    - ``u`` and ``c`` (S,) given, the line search's candidates
      ``w softplus(-(y (s + u c_k)))`` (B, P, S), summed over P;
    - ``c`` alone, the scale sweep's ``w softplus((-(y s)) c_k)`` (B, P, S);
    - neither, one energy's ``w softplus(-(y s))`` (B, P) (also for ``s`` of
      shape (..., P)), summed over its last axis.
    """
    if u is not None:
        t = y[:, :, None] * (s[:, :, None] + u[:, :, None] * c)
        return w[:, :, None] * softplus_plain(-t), 1
    t = y * s
    if c is not None:
        return w[:, :, None] * softplus_plain(-t[:, :, None] * c), 1
    return w * softplus_plain(-t), -1


def softplus_energies_plain(s, y, w, c=None, u=None):
    """:func:`softplus_terms` summed by :func:`lane_sum_plain`."""
    return lane_sum_plain(*softplus_terms(s, y, w, c, u))


#: PCG's early exit (:func:`pcg_chain`) reads whether every lane is done (a
#: host sync) every this many steps.
PCG_SYNC_EVERY = 8


def pcg_chain(H, b, iters, rtol, early_exit=True):
    """Jacobi-preconditioned CG of the (B, n, n) systems ``H x = b`` op by
    op: the plain version of :func:`pcg_kernel` (:func:`matvec` and
    :func:`lane_dot`, so the lane kernels on the card).

    Residual-based: a lane iterates until ``||r|| <= rtol * ||b||`` or
    ``iters`` steps. Lanes that are done are frozen (their state is kept
    exactly), as the JAX package's vmapped ``while_loop`` freezes them; with
    ``early_exit`` the loop ends when every lane is done (a host sync every
    :data:`PCG_SYNC_EVERY` steps), else it runs all ``iters`` steps (inside
    a CUDA graph), with the same result.
    """
    dinv = 1.0 / torch.diagonal(H, dim1=-2, dim2=-1)
    x = b * dinv
    r = b - matvec(H, x)
    z = r * dinv
    p = z
    rz = lane_dot(r, z)
    r2_stop = (rtol * rtol) * lane_dot(b, b) + 1e-30
    live = lane_dot(r, r) > r2_stop
    for i in range(iters):
        if early_exit and i % PCG_SYNC_EVERY == 0 and not bool(live.any()):
            break
        Hp = matvec(H, p)
        a = rz / (lane_dot(p, Hp) + 1e-30)
        x_new = x + a[:, None] * p
        r_new = r - a[:, None] * Hp
        z = r_new * dinv
        rz_new = lane_dot(r_new, z)
        beta = rz_new / (rz + 1e-30)
        p_new = z + beta[:, None] * p
        keep = live[:, None]
        x = torch.where(keep, x_new, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, p_new, p)
        rz = torch.where(live, rz_new, rz)
        live = live & (lane_dot(r, r) > r2_stop)
    return x


def _fused_update(a, l, m):
    """``a - l m`` rounded to float64, then to float32: the product of two
    floats is exact in float64, so the difference is rounded twice, which
    matches a float32 fused multiply-add except in rare double-rounding
    cases."""
    return (a.double() - l.double() * m.double()).float()


def cholesky_chain(Hd, g):
    """``-Hd^-1 g`` per lane by Cholesky, op by op in the order of
    :func:`cholesky_kernel` (the plain version it equals bitwise on the
    card): ``Hd`` (B, n, n) float32 (its lower triangle is read), ``g`` (B,
    n). Right-looking, with the forward substitution in the same loop: for
    each column j the pivot ``p = a_jj`` (the lane fails unless ``p > 0``),
    ``L_jj = sqrt(p)``, the column ``l = a[j+1:, j] / L_jj``, ``y_j = b_j /
    L_jj``, ``b[j+1:] -= l y_j`` and ``a[j+1:, j+1:] -= l l^T``; then the
    back substitution ``x_j = y_j / L_jj``, ``y[:j] -= L[j, :j] x_j`` for j =
    n - 1, ..., 0. Each update's exact product is subtracted in float64 and
    the difference rounded to float32 (:func:`_fused_update`), which matches
    the float32 fused multiply-adds of cuSOLVER's and LAPACK's factors
    except in rare double-rounding cases: a product and a difference
    rounded apart leave the
    near-singular systems of the Newton loop with up to ten times
    cuSOLVER's error (``tests/data/torch_port/cholesky_orders.py``). A lane
    whose factorization fails is NaN in every entry, as ``cholesky_ex``'s
    ``info != 0`` made it. The trailing update also writes the upper
    triangle, which is never read. No solver path calls it; it is the
    kernel's oracle and, on the CPU, the kernel's arithmetic under test."""
    B, n = g.shape
    a = Hd.clone()
    b = g.clone()
    diag = torch.empty_like(g)
    fail = torch.zeros(B, dtype=torch.bool, device=g.device)
    for j in range(n):
        p = a[:, j, j]
        fail = fail | ~(p > 0)
        dj = torch.sqrt(p)
        col = a[:, j + 1:, j] / dj[:, None]
        yj = b[:, j] / dj
        diag[:, j] = dj
        a[:, j + 1:, j] = col
        b[:, j] = yj
        b[:, j + 1:] = _fused_update(b[:, j + 1:], col, yj[:, None])
        a[:, j + 1:, j + 1:] = _fused_update(a[:, j + 1:, j + 1:], col[:, :, None],
                                             col[:, None, :])
    for j in range(n - 1, -1, -1):
        xj = b[:, j] / diag[:, j]
        b[:, j] = xj
        b[:, :j] = _fused_update(b[:, :j], a[:, j, :j], xj[:, None])
    return torch.where(fail[:, None],
                       torch.full((), float('nan'), dtype=g.dtype, device=g.device),
                       -b)


def reg_grad_hess(params, alpha, epsilon, kmask):
    """The smooth-L1 deformation regularizer's ``term2 = sqrt(xi^2 +
    epsilon)``, gradient and Hessian diagonal (params (B, n), n > 6, xi =
    params[:, 6:]; alpha (B,), kmask (B, K)), op by op."""
    xi = params[..., 6:]
    a = torch.as_tensor(alpha, dtype=params.dtype, device=params.device)[..., None]
    term2 = torch.sqrt(xi * xi + epsilon)
    zeros6 = torch.zeros(params.shape[:-1] + (6,), dtype=params.dtype,
                         device=params.device)
    grad = torch.cat([zeros6, a * (xi / term2) * kmask], dim=-1)
    hdiag = a * (1.0 / term2 - (xi * xi) / (term2 ** 3))
    hdiag = torch.cat([zeros6, hdiag.clamp_min(0.0) * kmask + (1.0 - kmask)],
                      dim=-1)
    return term2, grad, hdiag


def lm_system_plain(params, mu, alpha, epsilon, kmask, g, H):
    """The Levenberg-Marquardt-damped Newton system of
    ``solver._newton_step`` op by op: at n > 6 the regularizer's gradient
    added to ``g`` (B, n), masked by ``[1] * 6 + kmask``, and its Hessian
    diagonal to ``H`` (B, n, n); then ``Hd = H + mu scale_h I`` with
    ``scale_h = lane_sum(diag H) / n + 1e-12``. Returns ``(g, Hd)``."""
    B, n = params.shape
    if n > 6:
        _, reg_g, reg_h = reg_grad_hess(params, alpha, epsilon, kmask)
        g = (g + reg_g) * torch.cat(
            [torch.ones((B, 6), dtype=g.dtype, device=g.device), kmask], dim=1)
        H = H + torch.diag_embed(reg_h)
    scale_h = lane_sum(torch.diagonal(H, dim1=-2, dim2=-1)) / n + 1e-12
    return g, H + (mu * scale_h)[:, None, None] * torch.eye(n, dtype=H.dtype,
                                                             device=H.device)


def step_guard_plain(direction, g, params, alpha, epsilon, kmask, steps, f0, armijo_c,
                     negate=False):
    """The guard of a Newton direction and what the line search needs of
    it, op by op as ``solver._newton_step`` computed them: ``delta`` is
    ``direction`` (B, n) (``-direction`` if ``negate``: PCG's solution),
    replaced in each lane holding a non-finite entry by the gradient step
    ``-g / (sqrt(g . g) + 1)``; the decrement ``-g . delta``; at n > 6 the
    regularizer of the candidates ``xi = params[:, 6:] + delta[:, 6:]
    steps_k`` (B, S), clamped at 0; and the Armijo thresholds ``f0 -
    armijo_c steps_k decrement`` (B, S). Returns ``(delta, decrement,
    reg_cand or None, thresholds)``."""
    delta = -direction if negate else direction
    bad = ~torch.isfinite(delta).all(dim=1)
    delta = torch.where(bad[:, None],
                        -g / (torch.sqrt(lane_dot(g, g)) + 1.0)[:, None], delta)
    decrement = -lane_dot(g, delta)  # lambda^2 >= 0 for the Newton step
    reg_cand = None
    if params.shape[1] > 6:
        xi_cand = params[:, 6:, None] + delta[:, 6:, None] * steps   # (B, K, S)
        term2c = torch.sqrt(xi_cand * xi_cand + epsilon)
        reg_cand = (alpha[:, None] * lane_sum(
            kmask[:, :, None] * (term2c - math.sqrt(epsilon)), 1)).clamp_min(0.0)
    return delta, decrement, reg_cand, f0[:, None] - armijo_c * steps * decrement[:, None]


def cholesky_lapack(Hd, g):
    """``-Hd^-1 g`` by LAPACK's ``cholesky_ex`` and ``cholesky_solve`` on
    the whole batch (LAPACK factors each matrix by itself; ``cholesky_ex``
    reports a failure instead of raising), NaN in the lanes whose factor
    fails: the Cholesky direction on the CPU."""
    L, info = torch.linalg.cholesky_ex(Hd)
    delta = -torch.cholesky_solve(g[..., None], L)[..., 0]
    return torch.where((info != 0)[:, None],
                       torch.full((), float('nan'), dtype=g.dtype, device=g.device),
                       delta)


def newton_direction_plain(params, mu, alpha, epsilon, kmask, g, H, steps, f0, armijo_c,
                           pcg=None):
    """A Newton step's direction and its guard, op by op: with ``mu``, the
    damped system :func:`lm_system_plain` of ``g`` and ``H``; with ``mu``
    None, ``(g, H)`` as given (a system the caller damped); its direction
    ``-Hd^-1 g'``, by PCG if ``pcg`` is ``(iters, rtol)`` (:func:`pcg_chain`,
    whose solution the guard negates; ``(iters, rtol, False)`` runs it
    without its early exit, the same bits), else by Cholesky
    (:func:`cholesky_chain` on the card, :func:`cholesky_lapack` on the
    CPU, as ``solver._cholesky_direction``); then :func:`step_guard_plain`.
    Returns ``(delta, decrement, reg_cand or None, thresholds)``."""
    if mu is not None:
        g, H = lm_system_plain(params, mu, alpha, epsilon, kmask, g, H)
    if pcg is not None:
        direction = pcg_chain(H, g, *pcg)
    else:
        direction = cholesky_chain(H, g) if H.is_cuda else cholesky_lapack(H, g)
    return step_guard_plain(direction, g, params, alpha, epsilon, kmask, steps, f0, armijo_c,
                            pcg is not None)


def step_pick_plain(data_cand, reg_cand, armijo_f, f0, steps, params, delta, s=None, u=None):
    """The line search's pick, op by op as ``solver._newton_step`` made it:
    the candidates' energies ``f_cand = data_cand + reg_cand`` (B, S)
    (``reg_cand`` None at n <= 6); the first step that passes the Armijo
    test ``f_cand <= armijo_f``, else the least ``f_cand``; ``improved`` if
    its energy is below ``f0``, and then ``t_step`` its step (0 else) and
    ``full_step`` if it is the first; ``new_params = params + t_step
    delta`` (B, n), ``new_s = s + t_step u`` (B, P) (None without ``s``),
    ``new_f``. Returns ``(t_step, new_params, new_s, new_f, improved,
    full_step)``."""
    dt, dev = params.dtype, params.device
    f_cand = data_cand + reg_cand if reg_cand is not None else data_cand
    armijo = f_cand <= armijo_f
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
    new_s = None if s is None else s + t_step[:, None] * u
    new_f = torch.where(improved, f_pick, f0)
    return t_step, new_params, new_s, new_f, improved, full_step


#: The Newton loop's state that :func:`step_tail` and :func:`step_sweep`
#: write in place: params (B, n), s (B, P), fval (B,) float32, it_lane (B,)
#: int32, it_dev () int32 (the iterations run, added to before the step)
#: and conv (B,) bool; s, fval, it_lane and it_dev may be None (the sharded
#: solver keeps params, mu and conv; :func:`step_sweep` needs params, s and
#: fval). The step's ``mu`` is the loop's own and is written in place too.
#: ``scratch``: the solve's :func:`sweep_scratch`, which
#: :func:`step_sweep_kernel` takes (None: a scratch of its own a call).
FreezeState = namedtuple('FreezeState', 'params s fval it_lane it_dev conv scratch',
                         defaults=(None,))

#: :func:`step_sweep_kernel`'s scratch for lanes whose scales it splits
#: over more than one tile: ``arrivals`` (B,) int32, each lane's count of
#: its scale candidates' energies stored, 0 between launches (each launch
#: leaves it 0), and ``sums`` (B, S) float32, those energies. A solve
#: allocates its own with its loop state (:func:`sweep_scratch`), so that
#: concurrent solves and their CUDA graphs share none.
SweepScratch = namedtuple('SweepScratch', 'arrivals sums')


def sweep_scratch(B, S, device):
    """A :class:`SweepScratch` for ``B`` lanes of ``S`` scales on
    ``device``."""
    return SweepScratch(torch.zeros((B,), dtype=torch.int32, device=device),
                        torch.empty((B, S), dtype=torch.float32, device=device))


def step_tail_plain(data_sc, new_params, new_s, new_f, improved, full_step, mu, f0, decrement,
                    alpha, epsilon, kmask, scales, tol, mu_min, mu_max, state=None):
    """The rest of a Newton step after the scale sweep's data energies
    ``data_sc`` (B, S), op by op as ``solver._newton_step`` and the loop's
    iteration made it: at n > 6 the regularizer of the candidates
    ``new_params[:, 6:] scales_k``, clamped at 0, added; the least candidate
    ``f_sc``, taken (``boost``) if finite and below ``new_f``, scales
    ``new_params`` and ``new_s`` (None: no surface) by ``c_best`` and gives
    ``new_f``; the new mu (a quarter after a full step, at least
    ``mu_min``; kept after a shorter one; else eight times, at most
    ``mu_max``) and the convergence test on the old ``mu``, ``f0`` and
    ``decrement`` at ``tol``. Returns ``(new_params, new_s, new_f,
    converged, new_mu)``; given ``state`` (:class:`FreezeState`) writes
    them instead, as the loop's freeze did: a lane whose ``state.conv`` is
    set keeps its state, the others take the new values (``mu`` in place,
    ``it_lane`` from ``it_dev``), and ``conv |= converged``; returns
    None."""
    dt, dev = new_params.dtype, new_params.device
    if new_params.shape[1] > 6:
        xi_sc = new_params[:, 6:, None] * scales
        term2sc = torch.sqrt(xi_sc * xi_sc + epsilon)
        reg_sc = (alpha[:, None] * lane_sum(kmask[:, :, None] * (term2sc - math.sqrt(epsilon)), 1)
                  ).clamp_min(0.0)
        f_sc = data_sc + reg_sc
    else:
        f_sc = data_sc
    pick_sc = torch.argmin(f_sc, dim=1)
    f_sc_pick = f_sc.gather(1, pick_sc[:, None])[:, 0]
    boost = (f_sc_pick < new_f) & torch.isfinite(f_sc_pick)
    c_best = torch.where(boost, scales[pick_sc], torch.ones((), dtype=dt, device=dev))
    new_params = new_params * c_best[:, None]
    new_s = None if new_s is None else new_s * c_best[:, None]
    new_f = torch.where(boost, f_sc_pick, new_f)

    new_mu = torch.where(full_step, (mu * 0.25).clamp_min(mu_min),
                         torch.where(improved, mu, (mu * 8.0).clamp_max(mu_max)))
    tiny_gain = (f0 - new_f) <= tol * (1.0 + f0.abs())
    converged = (((0.5 * decrement <= tol * (1.0 + f0.abs())) & (mu <= 1e-4)
                  & tiny_gain)
                 | ((~improved) & (mu >= mu_max) & tiny_gain))
    if state is None:
        return new_params, new_s, new_f, converged, new_mu
    conv = state.conv
    keep = conv[:, None]
    state.params.copy_(torch.where(keep, state.params, new_params))
    if state.s is not None:
        state.s.copy_(torch.where(keep, state.s, new_s))
    if state.fval is not None:
        state.fval.copy_(torch.where(conv, state.fval, new_f))
    mu.copy_(torch.where(conv, mu, new_mu))
    if state.it_lane is not None:
        state.it_lane.copy_(torch.where(conv, state.it_lane, state.it_dev))
    conv.logical_or_(converged)
    return None


def step_sweep_plain(data_cand, reg_cand, armijo_f, steps, delta, u, yv, w, mu, decrement,
                     alpha, epsilon, kmask, scales, tol, mu_min, mu_max, state):
    """The rest of a Newton step in the loop after the line search's data
    energies ``data_cand`` (B, S), op by op as ``solver._newton_step`` ran
    it: :func:`step_pick_plain` on the loop's ``state`` (its params, s and
    fval are the step's params, surface and f0), the scale sweep's data
    energies of ``new_s`` (the terms of :func:`softplus_terms` summed by
    :func:`lane_sum`: on the CPU :func:`softplus_energies_plain`, on the
    card the kernels' order), then :func:`step_tail_plain` writing the
    state in place; returns None."""
    _, new_params, new_s, new_f, improved, full_step = step_pick_plain(
        data_cand, reg_cand, armijo_f, state.fval, steps, state.params, delta, state.s, u)
    data_sc = lane_sum(*softplus_terms(new_s, yv, w, scales))
    return step_tail_plain(data_sc, new_params, new_s, new_f, improved, full_step, mu,
                           state.fval, decrement, alpha, epsilon, kmask, scales, tol, mu_min,
                           mu_max, state)


def _launch(name, shape, fn, *args):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')
    gram._count_launch(name, (name, shape), table=LAUNCHES, hooks=LAUNCH_HOOKS)


def _check_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'{name} needs CUDA tensors, got {t.device}')
        if t.dtype != torch.float32:
            raise ValueError(f'{name} takes float32, got {t.dtype}')


def _int32(name, *values):
    if any(not 0 <= v < 2 ** 31 for v in values):
        raise ValueError(f'{name}: sizes or strides {values} do not fit in '
                         'int32')


def matvec_kernel(A, x, warp_rows=False):
    """The CUDA kernel of :func:`matvec` on the current stream. At n <= 32
    one thread computes a row; ``warp_rows`` takes the warp-per-row kernel
    there too (the same bits, to hold the two against each other)."""
    B, P, n = A.shape
    _check_cuda('matvec_kernel', A, x)
    A = A.contiguous()
    x = x.contiguous()
    gram._check('x', x, torch.float32, (B, n), A.device)
    gram._check('A', A, torch.float32, (B, P, n), A.device)
    out = torch.empty((B, P), dtype=torch.float32, device=A.device)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(A.device):
        _launch('lane_matvec', (B, P, n), lib.sdsm_lane_matvec, A.data_ptr(),
                x.data_ptr(), out.data_ptr(), B, P, n, int(warp_rows))
    return out


def _collapse(sizes, strides):
    """``(size, stride)`` of consecutive axes read as one, or None where
    their strides do not allow it (axes of size 1 left out)."""
    size, stride = 1, 0
    for n, st in zip(reversed(sizes), reversed(strides)):
        if n == 1:
            continue
        if size == 1:
            size, stride = n, st
        elif st != stride * size:
            return None
        else:
            size *= n
    return size, stride


def _as_ols(x, dim):
    """``x`` read as (O, L, S), L its axis ``dim``: ``((O, L, S), (sO, sL,
    sS))`` in elements, or None where its strides do not allow it."""
    shape, strides = tuple(x.shape), x.stride()
    outer = _collapse(shape[:dim], strides[:dim])
    inner = _collapse(shape[dim + 1:], strides[dim + 1:])
    if outer is None or inner is None:
        return None
    return (outer[0], shape[dim], inner[0]), (outer[1], strides[dim], inner[1])


def lane_sum_kernel(x, dim=-1):
    """The CUDA kernel of :func:`lane_sum` on the current stream. It reads
    ``x`` with its strides (a (B, K, S) tensor summed over K, a diagonal
    view); only a layout whose leading or trailing axes cannot be read as
    one is copied first."""
    _check_cuda('lane_sum_kernel', x)
    dim = dim % x.dim()
    shape = tuple(x.shape[:dim]) + tuple(x.shape[dim + 1:])
    ols = _as_ols(x, dim)
    if ols is None:
        x = x.contiguous()
        ols = _as_ols(x, dim)
    (O, L, S), (sO, sL, sS) = ols
    _int32('lane_sum_kernel', O, L, S, sO, sL, sS)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(x.device):
        _launch('lane_sum', (O, L) if S == 1 else (O, S, L),
                lib.sdsm_lane_strided_sum, x.data_ptr(),
                out.data_ptr(), O, L, S, sO, sL, sS)
    return out


def lane_dot_kernel(a, b):
    """The CUDA kernel of :func:`lane_dot` on the current stream."""
    _check_cuda('lane_dot_kernel', a, b)
    a = a.contiguous()
    b = b.contiguous()
    gram._check('b', b, torch.float32, tuple(a.shape), a.device)
    if a.dim() != 2:
        raise ValueError(f'lane_dot_kernel takes (B, n), got {tuple(a.shape)}')
    O, L = a.shape
    _int32('lane_dot_kernel', O, L)
    out = torch.empty((O,), dtype=torch.float32, device=a.device)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(a.device):
        _launch('lane_dot', (O, L), lib.sdsm_lane_dot, a.data_ptr(),
                b.data_ptr(), out.data_ptr(), O, L)
    return out


def softplus_energies_kernel(s, y, w, c=None, u=None):
    """The CUDA kernel of :func:`softplus_energies` on the current stream
    (one launch, the terms built in registers, a thread every output of its
    tile for one pixel)."""
    _check_cuda('softplus_energies_kernel', s, y, w)
    if u is not None and c is None:
        raise ValueError('softplus_energies: the line search needs c with u')
    lead = tuple(s.shape[:-1])
    P = s.shape[-1]
    s, y, w = (t.reshape(-1, P).contiguous() for t in (s, y, w))
    O = s.shape[0]
    for name, t in (('y', y), ('w', w)):
        gram._check(name, t, torch.float32, (O, P), s.device)
    mode, S, ptrs = _SINGLE, 1, [0, 0]
    if c is not None:
        _check_cuda('softplus_energies_kernel', c)
        c = c.contiguous()
        if c.dim() != 1:
            raise ValueError('softplus_energies: c must be (S,), got '
                             f'{tuple(c.shape)}')
        S = c.shape[0]
        mode, ptrs = _SCALE_SWEEP, [0, c.data_ptr()]
        if u is not None:
            _check_cuda('softplus_energies_kernel', u)
            u = u.reshape(-1, P).contiguous()
            gram._check('u', u, torch.float32, (O, P), s.device)
            mode, ptrs = _LINE_SEARCH, [u.data_ptr(), c.data_ptr()]
    _int32('softplus_energies_kernel', O, P, S)
    out = torch.empty((O, S), dtype=torch.float32, device=s.device)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(s.device):
        _launch('softplus_energies', (_MODE_NAMES[mode], O, P),
                lib.sdsm_lane_softplus_energies,
                s.data_ptr(), ptrs[0], y.data_ptr(), w.data_ptr(), ptrs[1],
                out.data_ptr(), O, P, S, mode)
    return out.reshape(lead + ((S,) if c is not None else ()))


def softplus_kernel(x):
    """``logaddexp(x, 0)`` elementwise with the device function of the
    softplus sums, to hold it bitwise against :func:`softplus_plain` on the
    card; no solver path calls it."""
    _check_cuda('softplus_kernel', x)
    x = x.contiguous()
    _int32('softplus_kernel', x.numel())
    out = torch.empty_like(x)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(x.device):
        _launch('softplus', (x.numel(),), lib.sdsm_lane_softplus, x.data_ptr(),
                out.data_ptr(), x.numel())
    return out


def pcg_kernel(H, b, iters, rtol):
    """The CUDA kernel of :func:`pcg` on the current stream: one launch for
    every step of every lane, bitwise :func:`pcg_chain` on the card, with no
    host sync; a lane's H in its cluster's registers at n <=
    :data:`PCG_REG_MAX_N`, in shared memory and L2 above (the route from n
    alone, the same bits on either)."""
    _check_cuda('pcg_kernel', H, b)
    H = H.contiguous()
    b = b.contiguous()
    if b.dim() != 2:
        raise ValueError(f'pcg_kernel takes b (B, n), got {tuple(b.shape)}')
    B, n = b.shape
    gram._check('H', H, torch.float32, (B, n, n), b.device)
    _int32('pcg_kernel', B, n, iters)
    x = torch.empty((B, n), dtype=torch.float32, device=b.device)
    lib = gram._load(gram.LANE_SRC)
    # the float32 values the chain's scalar ops use
    stop2, eps = (float(np.float32(v)) for v in (rtol * rtol, 1e-30))
    with torch.cuda.device(b.device):
        _launch('lane_pcg', (B, n), lib.sdsm_lane_pcg, H.data_ptr(), b.data_ptr(),
                x.data_ptr(), B, n, iters, stop2, eps)
    return x


def cholesky_route(B, n):
    """The number of :func:`cholesky_kernel`'s route at (B, n) on the card
    (:data:`CHOL_ROUTES`), as the library picks it."""
    return gram._load(gram.LANE_SRC).sdsm_lane_chol_route(B, n, None)


def cholesky_clusters(B, n):
    """The clusters of :func:`cholesky_kernel`'s launch at (B, n) that the
    current card holds at once (``cudaOccupancyMaxActiveClusters``; 0 on
    the one-block route); more lanes than that run in waves."""
    clusters = gram._load(gram.LANE_SRC).sdsm_lane_chol_clusters(B, n, None)
    if clusters < 0:
        raise RuntimeError(f'cholesky_clusters({B}, {n}): CUDA error {-clusters}')
    return clusters


def cholesky_kernel(Hd, g):
    """The CUDA kernel of the Newton direction ``-Hd^-1 g`` (``Hd`` (B, n, n)
    float32 SPD, its lower triangle read; ``g`` (B, n)) on the current
    stream: one launch, bitwise :func:`cholesky_chain` on the card, NaN in
    every entry of a lane whose factorization fails; no host sync. Off the
    shared one-block route it takes a scratch allocated here, of the size
    the library asks for; a launch the card refuses raises."""
    _check_cuda('cholesky_kernel', Hd, g)
    Hd = Hd.contiguous()
    g = g.contiguous()
    if g.dim() != 2:
        raise ValueError(f'cholesky_kernel takes g (B, n), got {tuple(g.shape)}')
    B, n = g.shape
    gram._check('Hd', Hd, torch.float32, (B, n, n), g.device)
    _int32('cholesky_kernel', B, n)
    out = torch.empty((B, n), dtype=torch.float32, device=g.device)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(g.device):
        floats = lib.sdsm_lane_chol_scratch_floats(B, n, None)
        scratch = None if floats == 0 else torch.empty(
            (B, floats), dtype=torch.float32, device=g.device)
        _launch('lane_cholesky', (B, n), lib.sdsm_lane_cholesky, Hd.data_ptr(),
                g.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, n)
    return out


def _f32(value):
    """The float32 value ATen computes with for a Python scalar."""
    return float(np.float32(value))


def lm_system_kernel(params, mu, alpha, epsilon, kmask, g, H):
    """The CUDA kernel of :func:`lm_system` on the current stream: one
    launch, bitwise :func:`lm_system_plain` on the card (a block writes 16
    rows of a lane's Hd and recomputes the lane's ``scale_h`` in
    :func:`lane_sum`'s order). At n <= 6 ``g`` comes back as it is."""
    _check_cuda('lm_system_kernel', params, mu, alpha, kmask, g, H)
    params, mu, alpha, kmask, g, H = (t.contiguous() for t in (params, mu, alpha, kmask, g, H))
    if params.dim() != 2:
        raise ValueError(f'lm_system_kernel takes params (B, n), got {tuple(params.shape)}')
    B, n = params.shape
    dev = params.device
    for name, t, shape in (('mu', mu, (B,)), ('g', g, (B, n)), ('H', H, (B, n, n))) + (
            (('alpha', alpha, (B,)), ('kmask', kmask, (B, n - 6))) if n > 6 else ()):
        gram._check(name, t, torch.float32, shape, dev)
    _int32('lm_system_kernel', B, n)
    g_out = torch.empty_like(g) if n > 6 else g
    Hd = torch.empty_like(H)
    lib = gram._load(gram.LANE_SRC)
    # ATen divides a CUDA tensor by a Python number as a product with the
    # number's float32 reciprocal: scale_h's / n is * (1 / n)
    with torch.cuda.device(dev):
        _launch('lane_lm_system', (B, n), lib.sdsm_lane_lm_system, params.data_ptr(),
                mu.data_ptr(), alpha.data_ptr(), kmask.data_ptr(), g.data_ptr(),
                H.data_ptr(), g_out.data_ptr(), Hd.data_ptr(), B, n, _f32(epsilon),
                _f32(np.float32(1.0) / np.float32(n)), _f32(1e-12))
    return g_out, Hd


def step_guard_kernel(direction, g, params, alpha, epsilon, kmask, steps, f0, armijo_c,
                      negate=False):
    """The CUDA kernel of :func:`step_guard` on the current stream: one
    block a lane, bitwise :func:`step_guard_plain` on the card (its sums in
    :func:`lane_dot`'s and :func:`lane_sum`'s order, no tensor between)."""
    _check_cuda('step_guard_kernel', direction, g, params, alpha, kmask, steps, f0)
    direction, g, params, alpha, kmask, steps, f0 = (
        t.contiguous() for t in (direction, g, params, alpha, kmask, steps, f0))
    if direction.dim() != 2 or steps.dim() != 1:
        raise ValueError('step_guard_kernel takes direction (B, n) and steps (S,), got '
                         f'{tuple(direction.shape)} and {tuple(steps.shape)}')
    B, n = direction.shape
    S = steps.shape[0]
    dev = direction.device
    for name, t, shape in (('g', g, (B, n)), ('params', params, (B, n)), ('f0', f0, (B,))) + (
            (('alpha', alpha, (B,)), ('kmask', kmask, (B, n - 6))) if n > 6 else ()):
        gram._check(name, t, torch.float32, shape, dev)
    _int32('step_guard_kernel', B, n, S)
    delta = torch.empty_like(direction)
    decrement = torch.empty((B,), dtype=torch.float32, device=dev)
    thresholds = torch.empty((B, S), dtype=torch.float32, device=dev)
    reg_cand = torch.empty((B, S), dtype=torch.float32, device=dev) if n > 6 else None
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(dev):
        _launch('lane_step_guard', (B, n), lib.sdsm_lane_step_guard, direction.data_ptr(),
                g.data_ptr(), params.data_ptr(), alpha.data_ptr(), kmask.data_ptr(),
                steps.data_ptr(), f0.data_ptr(), delta.data_ptr(), decrement.data_ptr(),
                None if reg_cand is None else reg_cand.data_ptr(), thresholds.data_ptr(),
                B, n, S, int(negate), _f32(epsilon), _f32(math.sqrt(epsilon)),
                _f32(armijo_c))
    return delta, decrement, reg_cand, thresholds


def _ptr(t):
    """A tensor's address, or None for no tensor."""
    return t.data_ptr() if t is not None else None


def newton_direction_kernel(params, mu, alpha, epsilon, kmask, g, H, steps, f0, armijo_c,
                            pcg=None):
    """The CUDA kernel of :func:`newton_direction` on the current stream:
    one launch (``lane_pcg_step`` with ``pcg``, else ``lane_chol_step``),
    bitwise :func:`newton_direction_plain` on the card and the three
    launches :func:`lm_system_kernel`, the direction kernel and
    :func:`step_guard_kernel`: the direction kernel's step variant, which
    forms the damped system where it loads H (with ``mu``) and runs the
    guard where it holds the direction; no Hd, g' or direction in device
    memory. PCG's route above :data:`PCG_REG_MAX_N` takes a damped system,
    so there :func:`lm_system_kernel` launches first. A launch the card
    refuses raises."""
    _check_cuda('newton_direction_kernel', params, g, H, steps, f0,
                *(t for t in (mu, alpha, kmask) if t is not None))
    if params.dim() != 2 or steps.dim() != 1:
        raise ValueError('newton_direction_kernel takes params (B, n) and steps (S,), got '
                         f'{tuple(params.shape)} and {tuple(steps.shape)}')
    params, g, H, steps, f0 = (t.contiguous() for t in (params, g, H, steps, f0))
    mu, alpha, kmask = (None if t is None else t.contiguous() for t in (mu, alpha, kmask))
    B, n = params.shape
    S = steps.shape[0]
    dev = params.device
    checks = (('g', g, (B, n)), ('H', H, (B, n, n)), ('f0', f0, (B,)))
    if mu is not None:
        checks += (('mu', mu, (B,)),)
    if n > 6:
        checks += (('alpha', alpha, (B,)), ('kmask', kmask, (B, n - 6)))
    for name, t, shape in checks:
        gram._check(name, t, torch.float32, shape, dev)
    _int32('newton_direction_kernel', B, n, S)
    if pcg is not None and mu is not None and n > PCG_REG_MAX_N:
        g, H = lm_system_kernel(params, mu, alpha, epsilon, kmask, g, H)
        mu = None
    delta = torch.empty((B, n), dtype=torch.float32, device=dev)
    decrement = torch.empty((B,), dtype=torch.float32, device=dev)
    thresholds = torch.empty((B, S), dtype=torch.float32, device=dev)
    reg_cand = torch.empty((B, S), dtype=torch.float32, device=dev) if n > 6 else None
    iters, rtol = pcg[:2] if pcg is not None else (0, 0.0)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(dev):
        floats = 0 if pcg is not None else lib.sdsm_lane_chol_scratch_floats(B, n, None)
        scratch = None if floats == 0 else torch.empty((B, floats), dtype=torch.float32,
                                                       device=dev)
        # the float32 values ATen computes with: lm_system_kernel's eps, 1 /
        # n and 1e-12, step_guard_kernel's eps, sqrt(eps) and Armijo
        # constant, pcg_kernel's rtol^2 and 1e-30
        _launch('lane_chol_step' if pcg is None else 'lane_pcg_step', (B, n),
                lib.sdsm_lane_newton_direction, H.data_ptr(), g.data_ptr(), params.data_ptr(),
                _ptr(mu), _ptr(alpha) if n > 6 else None, _ptr(kmask) if n > 6 else None,
                steps.data_ptr(), f0.data_ptr(), delta.data_ptr(), decrement.data_ptr(),
                _ptr(reg_cand), thresholds.data_ptr(), _ptr(scratch), B, n, S,
                int(pcg is not None), int(mu is not None), iters, _f32(epsilon),
                _f32(np.float32(1.0) / np.float32(n)), _f32(1e-12), _f32(math.sqrt(epsilon)),
                _f32(armijo_c), _f32(rtol * rtol), _f32(1e-30))
    return delta, decrement, reg_cand, thresholds


def step_pick_kernel(data_cand, reg_cand, armijo_f, f0, steps, params, delta, s=None, u=None):
    """The CUDA kernel of :func:`step_pick` on the current stream: one
    launch, bitwise :func:`step_pick_plain` on the card (eight blocks a
    lane, each recomputing the lane's pick and writing an eighth of its
    surface)."""
    _check_cuda('step_pick_kernel', data_cand, armijo_f, f0, steps, params, delta)
    data_cand, armijo_f, f0, steps, params, delta = (
        t.contiguous() for t in (data_cand, armijo_f, f0, steps, params, delta))
    if params.dim() != 2 or data_cand.dim() != 2 or steps.dim() != 1:
        raise ValueError('step_pick_kernel takes data_cand (B, S), params (B, n) and steps (S,), '
                         f'got {tuple(data_cand.shape)}, {tuple(params.shape)} and '
                         f'{tuple(steps.shape)}')
    B, n = params.shape
    S = steps.shape[0]
    dev = params.device
    checks = [('data_cand', data_cand, (B, S)), ('armijo_f', armijo_f, (B, S)),
              ('f0', f0, (B,)), ('delta', delta, (B, n))]
    if reg_cand is not None:
        _check_cuda('step_pick_kernel', reg_cand)
        reg_cand = reg_cand.contiguous()
        checks.append(('reg_cand', reg_cand, (B, S)))
    P = 0
    if s is not None:
        _check_cuda('step_pick_kernel', s, u)
        s, u = s.contiguous(), u.contiguous()
        P = s.shape[1]
        checks += [('s', s, (B, P)), ('u', u, (B, P))]
    for name, t, shape in checks:
        gram._check(name, t, torch.float32, shape, dev)
    _int32('step_pick_kernel', B, n, P, S)
    t_step = torch.empty((B,), dtype=torch.float32, device=dev)
    new_params = torch.empty_like(params)
    new_s = None if s is None else torch.empty_like(s)
    new_f = torch.empty((B,), dtype=torch.float32, device=dev)
    improved = torch.empty((B,), dtype=torch.bool, device=dev)
    full_step = torch.empty((B,), dtype=torch.bool, device=dev)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(dev):
        _launch('lane_step_pick', (B, P, n), lib.sdsm_lane_step_pick, data_cand.data_ptr(),
                _ptr(reg_cand), armijo_f.data_ptr(), f0.data_ptr(), steps.data_ptr(),
                params.data_ptr(), delta.data_ptr(), _ptr(s), _ptr(u),
                t_step.data_ptr(), new_params.data_ptr(), _ptr(new_s), new_f.data_ptr(),
                improved.data_ptr(), full_step.data_ptr(), B, n, P, S)
    return t_step, new_params, new_s, new_f, improved, full_step


def step_tail_kernel(data_sc, new_params, new_s, new_f, improved, full_step, mu, f0, decrement,
                     alpha, epsilon, kmask, scales, tol, mu_min, mu_max, state=None):
    """The CUDA kernel of :func:`step_tail` on the current stream: one
    launch (a cluster of eight blocks a lane), bitwise
    :func:`step_tail_plain` on the card, in either mode; with ``state`` it
    writes the loop's tensors in place (each must be contiguous, ``mu``
    too)."""
    _check_cuda('step_tail_kernel', data_sc, new_params, new_f, mu, f0, decrement, scales)
    data_sc, new_params, new_f, improved, full_step, f0, decrement, scales = (
        t.contiguous() for t in (data_sc, new_params, new_f, improved, full_step, f0,
                                 decrement, scales))
    if new_params.dim() != 2 or scales.dim() != 1:
        raise ValueError('step_tail_kernel takes new_params (B, n) and scales (S,), got '
                         f'{tuple(new_params.shape)} and {tuple(scales.shape)}')
    B, n = new_params.shape
    S = scales.shape[0]
    dev = new_params.device
    checks = [('data_sc', data_sc, torch.float32, (B, S)), ('new_f', new_f, torch.float32, (B,)),
              ('improved', improved, torch.bool, (B,)),
              ('full_step', full_step, torch.bool, (B,)), ('f0', f0, torch.float32, (B,)),
              ('decrement', decrement, torch.float32, (B,))]
    ptrs = [None, None]
    if n > 6:
        _check_cuda('step_tail_kernel', alpha, kmask)
        alpha, kmask = alpha.contiguous(), kmask.contiguous()
        checks += [('alpha', alpha, torch.float32, (B,)),
                   ('kmask', kmask, torch.float32, (B, n - 6))]
        ptrs = [alpha.data_ptr(), kmask.data_ptr()]
    P = 0
    if new_s is not None:
        _check_cuda('step_tail_kernel', new_s)
        new_s = new_s.contiguous()
        P = new_s.shape[1]
        checks.append(('new_s', new_s, torch.float32, (B, P)))
    if state is None:
        mu = mu.contiguous()
        out = (torch.empty_like(new_params), None if new_s is None else torch.empty_like(new_s),
               torch.empty_like(new_f), torch.empty((B,), dtype=torch.bool, device=dev),
               torch.empty_like(mu))
        params, s, fval, conv, mu_out = out
        it_lane = it_dev = None
    else:
        params, s, fval, it_lane, it_dev, conv = state[:6]
        mu_out = mu
        if (s is None) != (new_s is None) or (it_lane is None) != (it_dev is None):
            raise ValueError('step_tail_kernel: the state has s exactly where new_s is given, '
                             'and it_lane exactly with it_dev')
        checks += [('params', params, torch.float32, (B, n)),
                   ('conv', conv, torch.bool, (B,))]
        checks += [(name, t, dtype, shape) for name, t, dtype, shape in (
            ('s', s, torch.float32, (B, P)), ('fval', fval, torch.float32, (B,)),
            ('it_lane', it_lane, torch.int32, (B,)), ('it_dev', it_dev, torch.int32, ()))
            if t is not None]
    checks.append(('mu', mu, torch.float32, (B,)))
    for name, t, dtype, shape in checks:
        gram._check(name, t, dtype, shape, dev)
    _int32('step_tail_kernel', B, n, P, S)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(dev):
        _launch('lane_step_tail', (B, P, n), lib.sdsm_lane_step_tail, data_sc.data_ptr(),
                new_params.data_ptr(), _ptr(new_s), new_f.data_ptr(),
                improved.data_ptr(), full_step.data_ptr(), mu.data_ptr(), f0.data_ptr(),
                decrement.data_ptr(), *ptrs, scales.data_ptr(), params.data_ptr(),
                _ptr(s), _ptr(fval), mu_out.data_ptr(), conv.data_ptr(),
                _ptr(it_lane), _ptr(it_dev), B, n, P, S, int(state is not None),
                _f32(epsilon), _f32(math.sqrt(epsilon)), _f32(tol), _f32(mu_min),
                _f32(mu_max), _f32(1e-4))
    return out if state is None else None


def step_sweep_kernel(data_cand, reg_cand, armijo_f, steps, delta, u, yv, w, mu, decrement,
                      alpha, epsilon, kmask, scales, tol, mu_min, mu_max, state, k_tiles=None):
    """The CUDA kernel of :func:`step_sweep` on the current stream: one
    launch (``lane_step_sweep``, a mode of the softplus sums: each tile's
    blocks recompute the pick, sum the scale sweep's terms over ``s +
    t_step u`` and, in a lane's last cluster, run the tail and the freeze
    writes), bitwise :func:`step_pick_kernel`, the sweep's
    :func:`softplus_energies_kernel` and :func:`step_tail_kernel` given the
    state, and :func:`step_sweep_plain`. The state's tensors (and ``mu``,
    the loop's) must be contiguous; its ``scratch`` (a
    :func:`sweep_scratch`) is used, else one is allocated. ``k_tiles``
    forces the tiles of each lane's scales (None: the plan's; the bits do
    not depend on it). A launch the card refuses raises."""
    _check_cuda('step_sweep_kernel', data_cand, armijo_f, steps, delta, u, yv, w, mu,
                decrement, scales)
    data_cand, armijo_f, steps, delta, u, yv, w, decrement, scales = (
        t.contiguous() for t in (data_cand, armijo_f, steps, delta, u, yv, w, decrement,
                                 scales))
    if delta.dim() != 2 or u.dim() != 2 or steps.dim() != 1 or scales.dim() != 1:
        raise ValueError('step_sweep_kernel takes delta (B, n), u (B, P), steps (S,) and '
                         f'scales (S,), got {tuple(delta.shape)}, {tuple(u.shape)}, '
                         f'{tuple(steps.shape)} and {tuple(scales.shape)}')
    params, s, fval, it_lane, it_dev, conv, scratch = state
    if s is None or fval is None or (it_lane is None) != (it_dev is None):
        raise ValueError('step_sweep_kernel: the state needs s and fval, and it_lane '
                         'exactly with it_dev')
    B, n = delta.shape
    P = u.shape[1]
    S, SC = steps.shape[0], scales.shape[0]
    dev = delta.device
    if scratch is None:
        scratch = sweep_scratch(B, SC, dev)
    f32 = torch.float32
    checks = [('data_cand', data_cand, f32, (B, S)), ('armijo_f', armijo_f, f32, (B, S)),
              ('yv', yv, f32, (B, P)), ('w', w, f32, (B, P)),
              ('decrement', decrement, f32, (B,)), ('mu', mu, f32, (B,)),
              ('params', params, f32, (B, n)), ('s', s, f32, (B, P)),
              ('fval', fval, f32, (B,)), ('conv', conv, torch.bool, (B,)),
              ('arrivals', scratch.arrivals, torch.int32, (B,)),
              ('sums', scratch.sums, f32, (B, SC))]
    checks += [(name, t, torch.int32, shape) for name, t, shape in (
        ('it_lane', it_lane, (B,)), ('it_dev', it_dev, ())) if t is not None]
    ptrs = [None, None, None]
    if n > 6:
        _check_cuda('step_sweep_kernel', reg_cand, alpha, kmask)
        reg_cand, alpha, kmask = reg_cand.contiguous(), alpha.contiguous(), kmask.contiguous()
        checks += [('reg_cand', reg_cand, f32, (B, S)), ('alpha', alpha, f32, (B,)),
                   ('kmask', kmask, f32, (B, n - 6))]
        ptrs = [reg_cand.data_ptr(), alpha.data_ptr(), kmask.data_ptr()]
    for name, t, dtype, shape in checks:
        gram._check(name, t, dtype, shape, dev)
    tiles = 0 if k_tiles is None else int(k_tiles)
    if not 0 <= tiles <= SC:
        raise ValueError(f'step_sweep_kernel: k_tiles must be 1 to {SC}, got {k_tiles}')
    _int32('step_sweep_kernel', B, n, P, S, SC)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(dev):
        _launch('lane_step_sweep', (B, P, n), lib.sdsm_lane_step_sweep, data_cand.data_ptr(),
                ptrs[0], armijo_f.data_ptr(), steps.data_ptr(), delta.data_ptr(),
                u.data_ptr(), yv.data_ptr(), w.data_ptr(), decrement.data_ptr(), ptrs[1],
                ptrs[2], scales.data_ptr(), params.data_ptr(), s.data_ptr(), fval.data_ptr(),
                mu.data_ptr(), conv.data_ptr(), _ptr(it_lane), _ptr(it_dev),
                scratch.arrivals.data_ptr(), scratch.sums.data_ptr(), B, n, P, S, SC, tiles,
                _f32(epsilon), _f32(math.sqrt(epsilon)), _f32(tol), _f32(mu_min),
                _f32(mu_max), _f32(1e-4))
    return None


def matvec(A, x):
    """Per-lane matrix-vector product ``A (B, P, n) @ x (B, n) -> (B, P)``,
    float32."""
    if A.device.type == 'cpu':
        return matvec_plain(A, x)
    return matvec_kernel(A, x)


def lane_sum(x, dim=-1):
    """Per-lane sum over axis ``dim`` (not the leading lane axis) of a
    float32 tensor."""
    if x.device.type == 'cpu':
        return lane_sum_plain(x, dim)
    return lane_sum_kernel(x, dim)


def lane_dot(a, b):
    """Per-lane dot product ``sum_i a_i b_i`` of two (B, n) float32 tensors
    -> (B,): :func:`lane_sum` of ``a * b``, bitwise."""
    if a.device.type == 'cpu':
        return lane_dot_plain(a, b)
    return lane_dot_kernel(a, b)


def softplus_energies(s, y, w, c=None, u=None):
    """The solver's logistic energies (see :func:`softplus_energies_plain`
    for the modes), float32: bitwise the op-by-op expression followed by
    :func:`lane_sum`."""
    if s.device.type == 'cpu':
        return softplus_energies_plain(s, y, w, c, u)
    return softplus_energies_kernel(s, y, w, c, u)


def pcg(H, b, iters, rtol, early_exit=True):
    """Jacobi-preconditioned CG of the (B, n, n) float32 systems ``H x = b``
    -> x (B, n), each lane frozen once ``||r|| <= rtol * ||b||``, at most
    ``iters`` steps: :func:`pcg_chain` (``early_exit`` its host syncs) on the
    CPU, one :func:`pcg_kernel` launch on the card (no host sync; the same
    bits whatever ``early_exit``)."""
    if H.device.type == 'cpu':
        return pcg_chain(H, b, iters, rtol, early_exit)
    return pcg_kernel(H, b, iters, rtol)


def lm_system(params, mu, alpha, epsilon, kmask, g, H):
    """The damped Newton system ``(g, Hd)`` of ``solver._newton_step`` (see
    :func:`lm_system_plain`), float32: the plain version on the CPU, one
    :func:`lm_system_kernel` launch on the card (bitwise the same)."""
    if params.device.type == 'cpu':
        return lm_system_plain(params, mu, alpha, epsilon, kmask, g, H)
    return lm_system_kernel(params, mu, alpha, epsilon, kmask, g, H)


def step_guard(direction, g, params, alpha, epsilon, kmask, steps, f0, armijo_c,
               negate=False):
    """The guarded Newton step ``(delta, decrement, reg_cand, thresholds)``
    (see :func:`step_guard_plain`), float32: the plain version on the CPU,
    one :func:`step_guard_kernel` launch on the card (bitwise the same)."""
    if direction.device.type == 'cpu':
        return step_guard_plain(direction, g, params, alpha, epsilon, kmask, steps, f0,
                                armijo_c, negate)
    return step_guard_kernel(direction, g, params, alpha, epsilon, kmask, steps, f0,
                             armijo_c, negate)


def newton_direction(params, mu, alpha, epsilon, kmask, g, H, steps, f0, armijo_c, pcg=None):
    """A Newton step's guarded direction ``(delta, decrement, reg_cand,
    thresholds)`` from its system (see :func:`newton_direction_plain`),
    float32: the plain version on the CPU, one :func:`newton_direction_kernel`
    launch on the card (bitwise the same)."""
    args = (params, mu, alpha, epsilon, kmask, g, H, steps, f0, armijo_c, pcg)
    if params.device.type == 'cpu':
        return newton_direction_plain(*args)
    return newton_direction_kernel(*args)


def step_pick(data_cand, reg_cand, armijo_f, f0, steps, params, delta, s=None, u=None):
    """The line search's pick ``(t_step, new_params, new_s, new_f, improved,
    full_step)`` (see :func:`step_pick_plain`): the plain version on the CPU,
    one :func:`step_pick_kernel` launch on the card (bitwise the same)."""
    if params.device.type == 'cpu':
        return step_pick_plain(data_cand, reg_cand, armijo_f, f0, steps, params, delta, s, u)
    return step_pick_kernel(data_cand, reg_cand, armijo_f, f0, steps, params, delta, s, u)


def step_tail(data_sc, new_params, new_s, new_f, improved, full_step, mu, f0, decrement, alpha,
              epsilon, kmask, scales, tol, mu_min, mu_max, state=None):
    """The rest of a Newton step after the scale sweep's data energies (see
    :func:`step_tail_plain`), returned or, given ``state``, written into the
    loop's tensors: the plain version on the CPU, one
    :func:`step_tail_kernel` launch on the card (bitwise the same)."""
    args = (data_sc, new_params, new_s, new_f, improved, full_step, mu, f0, decrement, alpha,
            epsilon, kmask, scales, tol, mu_min, mu_max, state)
    if new_params.device.type == 'cpu':
        return step_tail_plain(*args)
    return step_tail_kernel(*args)


def step_sweep(data_cand, reg_cand, armijo_f, steps, delta, u, yv, w, mu, decrement, alpha,
               epsilon, kmask, scales, tol, mu_min, mu_max, state):
    """The rest of a Newton step in the loop after the line search's data
    energies (see :func:`step_sweep_plain`): the pick, the scale sweep's
    data energies over the new surface and the tail, written into the
    loop's ``state``: the plain version on the CPU, one
    :func:`step_sweep_kernel` launch on the card (bitwise the same)."""
    args = (data_cand, reg_cand, armijo_f, steps, delta, u, yv, w, mu, decrement, alpha,
            epsilon, kmask, scales, tol, mu_min, mu_max, state)
    if delta.device.type == 'cpu':
        return step_sweep_plain(*args)
    return step_sweep_kernel(*args)
