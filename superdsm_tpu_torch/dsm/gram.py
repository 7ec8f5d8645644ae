"""The Newton gram: fused logistic gradient and Gauss-Newton Hessian.

The per-iteration hot op of the batched solver is, for each lane, given the
feature matrix ``Bf (P, n)``, the carried surface ``s`` and data ``yv, w``::

    term1 = -yv * sigmoid(-yv s) * w            (P,)
    kappa =  w  * yv^2 * sig * (1 - sig)        (P,)
    g     = Bf^T term1                          (n,)
    H     = Bf^T diag(kappa) Bf                 (n, n)

Two implementations of the same function live here:

- :func:`grad_hess_kernel`, the hand-written CUDA kernel
  (``csrc/gram_grad_hess.cu``), compiled with ``nvcc`` for ``sm_90a`` into
  the build directory on first use and bound with ``ctypes``;
- :func:`grad_hess_plain`, the plain PyTorch version (batched matmuls with
  float64 sums), which the solver also uses for the sizes the kernel does
  not serve (n = 6, 32, 64).

:func:`fused_grad_hess_batched` dispatches: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises — there is no fallback.
It keeps the JAX package's selection rule (``pallas_kernels.py``): the
kernel serves n % 128 == 0, in banded mode for n in {512, 1024} when a band
table is given, in dense (upper-triangle) mode otherwise.

Every launch adds one to :data:`LAUNCHES` under the route it stands for:
``'dense'`` (the full dense Pallas kernel, n = 128 and n = 2048),
``'triangle'`` (the triangle-blocked one, 256 <= n <= 1024 without a band)
and ``'banded'``.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from ..native import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    'csrc', 'gram_grad_hess.cu')
_LIB = os.path.join(BUILD_DIR, 'libsdsm_gram.so')

#: Column tile and pixel-row chunk of the kernel (checked against the
#: compiled library on load).
TILE = 64
ROWS = 32

#: Problem sizes n = 6 + K that take the banded mode (the JAX package's
#: ``_NBAND_BY_N`` keys).
BANDED_N = (512, 1024)

#: Kernel launches per route; only :func:`grad_hess_kernel` adds to them.
LAUNCHES = {'dense': 0, 'triangle': 0, 'banded': 0}

#: The last ``nvcc`` build's output (``-Xptxas -v``: registers, shared
#: memory, spills).
BUILD_LOG = ''

_lock = threading.Lock()
_lib = None


def reset_launch_counts():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def route_for(n, banded):
    """The TPU kernel a launch at size ``n`` stands for."""
    if banded:
        return 'banded'
    return 'triangle' if 2 <= n // 128 <= 8 else 'dense'


def _logistic_weights(s, yv, w):
    t = yv * s
    sig = torch.sigmoid(-t)
    term1 = -yv * sig * w
    kappa = w * yv * yv * sig * (1.0 - sig)
    return term1, kappa


def grad_hess_plain(Bf, s, yv, w, active=None):
    """Plain PyTorch version: ``(g (..., n), H (..., n, n))`` float32.

    The float32 inputs are multiplied and summed over the pixels in float64
    and rounded once: a float32 reduction over 10^4 pixels in the order a
    library picks (cuBLAS sums a long ``k`` almost sequentially, measured
    4e-5 relative error on the n = 6 gram on an H100) is too coarse for the
    near-singular Newton systems, whose condition reaches ~1e5. The kernel
    gets the same effect from float64 running sums. Frozen lanes
    (``active == 0``) give zeros, as the kernel's do."""
    term1, kappa = _logistic_weights(s, yv, w)
    Bd = Bf.double()
    g = (Bd.transpose(-1, -2) @ term1.double()[..., None])[..., 0]
    H = (Bd * kappa.double()[..., None]).transpose(-1, -2) @ Bd
    g, H = g.float(), H.float()
    if active is not None:
        keep = active != 0
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        g = torch.where(keep[:, None], g, zero)
        H = torch.where(keep[:, None, None], H, zero)
    return g, H


def band_ranges(Bf, w):
    """Per-(lane, row chunk) band table of the kernel's banded mode.

    :return: ``(B, P // ROWS, 3)`` int32: whether column tile 0 is nonzero,
        and the first and last column tile >= 1 holding a nonzero entry
        among the chunk's valid pixels (``w > 0``); an empty range is
        ``(nt, 0)``. Padded pixels contribute exact zeros, so they are left
        out. Any band width is allowed.
    """
    B, P, n = Bf.shape
    nt, nc = n // TILE, P // ROWS
    nz = (Bf != 0) & (w > 0)[..., None]
    nz = nz.view(B, nc, ROWS, nt, TILE).any(dim=4).any(dim=2)  # (B, nc, nt)
    idx = torch.arange(1, nt, device=Bf.device, dtype=torch.int32)
    rest = nz[..., 1:]
    lo = torch.where(rest, idx, nt).amin(dim=-1)
    hi = torch.where(rest, idx, 0).amax(dim=-1)
    return torch.stack([nz[..., 0].to(torch.int32), lo.to(torch.int32),
                        hi.to(torch.int32)], dim=-1).contiguous()


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the gram kernel is built from '
                       f'{_SRC} with the CUDA toolkit')


def build():
    """Compiles the kernel library (always anew) and returns the seconds
    the build took."""
    global BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{_LIB}.{os.getpid()}.tmp'
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
           '-O3', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC',
           '-o', tmp, _SRC]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, _LIB)
    BUILD_LOG = proc.stdout + proc.stderr
    return time.time() - t0


def _load():
    """Builds (if missing or stale) and loads the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            build()
        lib = ctypes.CDLL(_LIB)
        lib.sdsm_gram_grad_hess.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.sdsm_gram_grad_hess.restype = ctypes.c_int
        lib.sdsm_gram_tile.restype = ctypes.c_int
        lib.sdsm_gram_rows.restype = ctypes.c_int
        if (lib.sdsm_gram_tile(), lib.sdsm_gram_rows()) != (TILE, ROWS):
            raise RuntimeError('gram kernel library does not match '
                               f'TILE={TILE}, ROWS={ROWS}')
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise ValueError(f'{name}: dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {shape}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: not contiguous')


def grad_hess_kernel(Bf, s, yv, w, active, band=None):
    """Launches the CUDA kernel on the current stream; ``band`` (from
    :func:`band_ranges`) selects the banded mode. Returns ``(g, H)``."""
    B, P, n = Bf.shape
    dev = Bf.device
    if dev.type != 'cuda':
        raise ValueError(f'grad_hess_kernel needs CUDA tensors, got {dev}')
    if n % TILE or P % ROWS:
        raise ValueError(f'gram kernel needs n % {TILE} == 0 and '
                         f'P % {ROWS} == 0, got n={n}, P={P}')
    f32 = torch.float32
    _check('Bf', Bf, f32, (B, P, n), dev)
    for name, t in (('s', s), ('yv', yv), ('w', w)):
        _check(name, t, f32, (B, P), dev)
    _check('active', active, torch.int32, (B,), dev)
    if band is not None:
        _check('band', band, torch.int32, (B, P // ROWS, 3), dev)
    if Bf.data_ptr() % 16:
        raise ValueError('Bf must be 16-byte aligned')
    lib = _load()
    g = torch.empty((B, n), dtype=f32, device=dev)
    H = torch.empty((B, n, n), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sdsm_gram_grad_hess(
            Bf.data_ptr(), s.data_ptr(), yv.data_ptr(), w.data_ptr(),
            active.data_ptr(), None if band is None else band.data_ptr(),
            g.data_ptr(), H.data_ptr(), B, P, n, stream)
    if err != 0:
        raise RuntimeError(f'gram kernel launch failed: CUDA error {err}')
    LAUNCHES[route_for(n, band is not None)] += 1
    return g, H


def fused_grad_hess_batched(Bf, s, yv, w, active=None, band=None):
    """Fused logistic gradient and Gauss-Newton Hessian, batched.

    :param Bf: (B, P, n) float32 feature matrices, n a multiple of 128.
    :param s, yv, w: (B, P) float32 surface, intensities, pixel weights.
    :param active: optional (B,) per-lane activity flag (1 = compute);
        frozen lanes return zeros (the Newton driver discards their g/H).
    :param band: optional band table (:func:`band_ranges`); used for
        n in :data:`BANDED_N`.
    :return: ``(g (B, n), H (B, n, n))`` float32.
    """
    B, P, n = Bf.shape
    if active is None:
        active = torch.ones((B,), dtype=torch.int32, device=Bf.device)
    else:
        active = active.to(torch.int32)
    if Bf.device.type == 'cpu':
        return grad_hess_plain(Bf, s, yv, w, active)
    if n % 128:
        raise ValueError(f'the gram kernel serves n % 128 == 0, got n={n}')
    use_band = band if n in BANDED_N else None
    return grad_hess_kernel(Bf.contiguous(), s.contiguous(), yv.contiguous(),
                            w.contiguous(), active.contiguous(), use_band)
