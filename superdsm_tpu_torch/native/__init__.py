"""Native (C++) host runtime ops, loaded via ctypes.

The C++ source is the port's own, ``superdsm_tpu_torch/csrc/watershed.cpp``
(a copy of the JAX package's native source, kept equal in behaviour), and is
compiled with the JAX package's ``g++`` line into the port's build directory
(``build/superdsm_tpu_torch/`` at the repository root) the first time it is
needed. Every entry point has a pure-Python fallback in the
:mod:`superdsm_tpu_torch.ops` modules, so the port works without a C++
toolchain.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_REPO = os.path.dirname(_PKG)
_SRC = os.path.join(_PKG, 'csrc', 'watershed.cpp')
#: Build directory of the port's compiled artifacts (gitignored).
BUILD_DIR = os.path.join(_REPO, 'build', 'superdsm_tpu_torch')
_LIB = os.path.join(BUILD_DIR, '_sdsm_native.so')

_lock = threading.Lock()
_lib = None
_load_failed = False


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a process-unique name, then rename: several test workers
    # may build at once, and a half-written library must never be loaded
    tmp = f'{_LIB}.{os.getpid()}.tmp'
    cmd = ['g++', '-O3', '-march=native', '-shared', '-fPIC', '-std=c++17',
           '-o', tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def get_lib():
    """Returns the loaded native library, or ``None`` if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not os.path.exists(_SRC):
                raise FileNotFoundError(_SRC)
            if (not os.path.exists(_LIB)) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
                _build()
            lib = ctypes.CDLL(_LIB)
            lib.sdsm_watershed.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
            lib.sdsm_watershed.restype = None
            lib.sdsm_subsample_grid.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.sdsm_subsample_grid.restype = ctypes.c_int32
            lib.sdsm_edt.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_double)]
            lib.sdsm_edt.restype = None
            lib.sdsm_maxfilt3.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]
            lib.sdsm_maxfilt3.restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _load_failed = True
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def watershed_native(image, markers, mask=None, connectivity=4):
    """Native watershed; returns ``None`` if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    image = np.ascontiguousarray(image, dtype=np.float32)
    markers = np.ascontiguousarray(markers, dtype=np.int32)
    H, W = image.shape
    out = np.zeros((H, W), dtype=np.int32)
    mask_arr = None
    mask_ptr = ctypes.POINTER(ctypes.c_uint8)()
    if mask is not None:
        mask_arr = np.ascontiguousarray(mask, dtype=np.uint8)
        mask_ptr = _ptr(mask_arr, ctypes.c_uint8)
    lib.sdsm_watershed(_ptr(image, ctypes.c_float), _ptr(markers, ctypes.c_int32),
                       mask_ptr, H, W, int(connectivity), _ptr(out, ctypes.c_int32))
    return out


def edt_native(mask):
    """Exact euclidean distance transform (distances of nonzero pixels to
    the nearest zero pixel); scipy-identical. ``None`` if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    H, W = mask.shape
    out = np.zeros((H, W), dtype=np.float64)
    lib.sdsm_edt(_ptr(mask, ctypes.c_uint8), H, W, _ptr(out, ctypes.c_double))
    return out


def maxfilt3_native(img, connectivity=8):
    """3x3 maximum filter (cross for connectivity 4, full square for 8),
    reflect borders; scipy-identical. ``None`` if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.float64)
    H, W = img.shape
    out = np.empty((H, W), dtype=np.float64)
    lib.sdsm_maxfilt3(_ptr(img, ctypes.c_double), H, W, int(connectivity),
                      _ptr(out, ctypes.c_double))
    return out


def subsample_grid_native(mask, stride, offset=(0, 0)):
    lib = get_lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    H, W = mask.shape
    grid = np.zeros((H, W), dtype=np.uint8)
    lib.sdsm_subsample_grid(_ptr(mask, ctypes.c_uint8), H, W, int(stride),
                            int(offset[0]) % int(stride), int(offset[1]) % int(stride),
                            _ptr(grid, ctypes.c_uint8))
    return grid.astype(bool)
