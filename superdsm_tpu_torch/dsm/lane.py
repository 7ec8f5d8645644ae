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
LAPACK (``solver._cholesky_direction``).

Every kernel launch adds one to :data:`LAUNCHES` (through
:func:`gram._count_launch`, so a captured CUDA graph counts its launches at
each replay).
"""

import numpy as np
import torch

from . import gram

#: Kernel launches per kernel (``softplus``: the elementwise check of
#: :func:`softplus_kernel`, which no solver path launches).
LAUNCHES = {'lane_matvec': 0, 'lane_sum': 0, 'lane_dot': 0,
            'softplus_energies': 0, 'lane_pcg': 0, 'lane_cholesky': 0,
            'softplus': 0}


def reset_launch_counts():
    gram.reset_launch_counts(LAUNCHES)


#: Callables told of every lane-kernel launch with its kernel's name and
#: shape (``lane_matvec`` (B, P, n), ``lane_sum`` (B, S, L) or (B, L)
#: summed over L, ``lane_dot`` (B, n), ``softplus_energies`` (mode, B, P),
#: ``lane_pcg`` and ``lane_cholesky`` (B, n));
#: under a replayed CUDA graph at each replay, as
#: :func:`gram._count_launch` counts.
LAUNCH_HOOKS = []


#: Slots of a lane sum (``csrc/lane_ops.cu``, ``ROW_THREADS``; checked
#: against the library when it loads).
ROW_THREADS = gram.LANE_CONSTANTS['row_threads']

#: Largest n whose lanes :func:`cholesky_kernel` factors in shared memory;
#: above it their work space is a global scratch (``csrc/lane_ops.cu``,
#: ``CHOL_SHARED_MAX_N``; checked against the library when it loads).
CHOL_SHARED_MAX_N = gram.LANE_CONSTANTS['chol_shared_max_n']

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
    (one launch, the terms built in registers)."""
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
    host sync."""
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


def cholesky_kernel(Hd, g):
    """The CUDA kernel of the Newton direction ``-Hd^-1 g`` (``Hd`` (B, n, n)
    float32 SPD, its lower triangle read; ``g`` (B, n)) on the current
    stream: one launch, one block a lane, bitwise :func:`cholesky_chain` on
    the card, NaN in every entry of a lane whose factorization fails; no
    host sync. Above :data:`CHOL_SHARED_MAX_N` the lanes' work space is a
    scratch allocated here."""
    _check_cuda('cholesky_kernel', Hd, g)
    Hd = Hd.contiguous()
    g = g.contiguous()
    if g.dim() != 2:
        raise ValueError(f'cholesky_kernel takes g (B, n), got {tuple(g.shape)}')
    B, n = g.shape
    gram._check('Hd', Hd, torch.float32, (B, n, n), g.device)
    _int32('cholesky_kernel', B, n)
    out = torch.empty((B, n), dtype=torch.float32, device=g.device)
    scratch = None
    if n > CHOL_SHARED_MAX_N:
        scratch = torch.empty((B, n * (n + 1) // 2 + 5 * n), dtype=torch.float32,
                              device=g.device)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(g.device):
        _launch('lane_cholesky', (B, n), lib.sdsm_lane_cholesky, Hd.data_ptr(),
                g.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, n)
    return out


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
