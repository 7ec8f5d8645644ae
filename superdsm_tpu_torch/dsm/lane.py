"""Per-lane products and sums of the batched Newton solver.

Each output of :func:`matvec` and :func:`lane_sum` belongs to one lane (the
leading axis) and is summed in an order fixed by the reduced length alone,
so a lane's result does not depend on which lanes share its batch. A
library's batched product or reduction does not promise that: cuBLAS picks
its kernel and PyTorch's CUDA reductions split a sum across threads and
blocks from the whole launch, and on the CPU a batch of one takes BLAS's
matrix-vector route while a batch of two takes its matrix-matrix one.

Two implementations of each function live here:

- the hand-written CUDA kernels of ``csrc/lane_ops.cu`` (built and loaded
  as the gram kernels are, :mod:`superdsm_tpu_torch.dsm.gram`), for CUDA
  tensors;
- the plain PyTorch versions :func:`matvec_plain` and :func:`lane_sum_plain`,
  for CPU tensors, where a batch of one computes what a batch of two
  computes.

Every kernel launch adds one to :data:`LAUNCHES` (through
:func:`gram._count_launch`, so a captured CUDA graph counts its launches at
each replay).
"""

import numpy as np
import torch

from . import gram

#: Kernel launches per kernel.
LAUNCHES = {'lane_matvec': 0, 'lane_sum': 0}


def reset_launch_counts():
    gram.reset_launch_counts(LAUNCHES)


#: Threads of the row-sum kernel (``csrc/lane_ops.cu``, ``ROW_THREADS``;
#: checked against the library when it loads).
ROW_THREADS = gram.LANE_CONSTANTS['row_threads']


def lane_sum_in_kernel_order(x):
    """The row sums of ``x`` (R, L) in the order of the row-sum kernel, on
    the host in float32 (numpy), to hold the kernel to its order bitwise:
    thread t of :data:`ROW_THREADS` adds x[t], x[t + ROW_THREADS], ... in
    turn, from 0; then a tree adds slot t + m into slot t for m =
    ROW_THREADS / 2, ..., 1. Each float32 addition rounds as the card's
    does, and a thread's sum is never -0, so the zeros that pad L to a
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


def _launch(name, fn, *args):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')
    gram._count_launch(name, table=LAUNCHES)


def matvec_kernel(A, x, warp_rows=False):
    """The CUDA kernel of :func:`matvec` on the current stream. At n <= 8
    one thread computes a row; ``warp_rows`` takes the warp-per-row kernel
    there too (the same bits, to hold the two against each other)."""
    B, P, n = A.shape
    if A.device.type != 'cuda':
        raise ValueError(f'matvec_kernel needs CUDA tensors, got {A.device}')
    A = A.contiguous()
    x = x.contiguous()
    gram._check('x', x, torch.float32, (B, n), A.device)
    gram._check('A', A, torch.float32, (B, P, n), A.device)
    out = torch.empty((B, P), dtype=torch.float32, device=A.device)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(A.device):
        _launch('lane_matvec', lib.sdsm_lane_matvec, A.data_ptr(), x.data_ptr(),
                out.data_ptr(), B, P, n, int(warp_rows))
    return out


def lane_sum_kernel(x, dim=-1):
    """The CUDA kernel of :func:`lane_sum` on the current stream."""
    if x.device.type != 'cuda':
        raise ValueError(f'lane_sum_kernel needs CUDA tensors, got {x.device}')
    if x.dtype != torch.float32:
        raise ValueError(f'lane_sum_kernel sums float32, got {x.dtype}')
    rows = x.movedim(dim, -1)
    shape = rows.shape[:-1]
    rows = rows.reshape(-1, rows.shape[-1]).contiguous()
    out = torch.empty((rows.shape[0],), dtype=torch.float32, device=x.device)
    lib = gram._load(gram.LANE_SRC)
    with torch.cuda.device(x.device):
        _launch('lane_sum', lib.sdsm_lane_row_sum, rows.data_ptr(),
                out.data_ptr(), rows.shape[0], rows.shape[1])
    return out.reshape(shape)


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
