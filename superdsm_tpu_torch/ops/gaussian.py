"""Separable Gaussian filtering on the selected torch device.

Port of :mod:`superdsm_tpu.ops.gaussian`. The kernel is the sampled,
truncated, sum-normalized Gaussian that scipy uses, and boundary handling
matches scipy's default ``reflect`` mode (numpy ``symmetric``), built from
flips since torch has no such padding mode. Short kernels run as
convolutions (``conv2d`` is a cross-correlation, as ``_conv1d`` was); kernels
with at least :data:`TOEPLITZ_MIN_TAPS` taps run as banded-Toeplitz
matmuls over the padded axis, which keeps long filters exact float32.
Both stay plain PyTorch, as the JAX package left them to XLA. The package
turns TF32 off for convolutions and matmuls at import.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

#: Kernels with at least this many taps run as banded-Toeplitz matmuls
#: (``SDSM_GAUSS_TOEPLITZ_TAPS``, as in the JAX package).
TOEPLITZ_MIN_TAPS = int(os.environ.get('SDSM_GAUSS_TOEPLITZ_TAPS', '64'))


def gaussian_kernel1d(sigma, truncate=4.0, radius=None, dtype=np.float32):
    """Sampled truncated Gaussian, normalized to sum 1 (scipy-compatible)."""
    if radius is None:
        radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    k /= k.sum()
    return k.astype(dtype)


def _pad_symmetric(x, pad, axis):
    """numpy ``symmetric`` padding (edge repeated), also for pad widths
    larger than the axis size. An empty axis cannot be padded."""
    if pad > 0 and x.shape[axis] == 0:
        raise ValueError(f'cannot pad an empty axis {axis} symmetrically')
    while pad > 0:
        size = x.shape[axis]
        step = min(pad, size)
        left = x.narrow(axis, 0, step).flip(axis)
        right = x.narrow(axis, size - step, step).flip(axis)
        x = torch.cat([left, x, right], dim=axis)
        pad -= step
    return x


def _conv1d(x, kernel, axis):
    """Cross-correlates a 2D array with a 1D kernel along ``axis`` (VALID)."""
    shape = (1, 1) + ((len(kernel), 1) if axis == 0 else (1, len(kernel)))
    return F.conv2d(x[None, None], kernel.reshape(shape))[0, 0]


def _toeplitz1d(x, kernel, axis):
    """Same contraction as :func:`_conv1d` as a banded-Toeplitz matmul."""
    K = len(kernel)
    n = x.shape[axis] - (K - 1)
    idx = (torch.arange(x.shape[axis], device=x.device)[:, None]
           - torch.arange(n, device=x.device)[None, :])
    band = torch.where((idx >= 0) & (idx < K), kernel[idx.clamp(0, K - 1)],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    if axis == 0:
        return band.T @ x
    return x @ band


def _gaussian_filter_2d(x, sigma, truncate):
    """Filters a 2D float tensor with per-axis sigmas ``(s0, s1)``."""
    for axis, s in enumerate(sigma):
        if s <= 0:
            continue
        kernel = torch.from_numpy(gaussian_kernel1d(s, truncate, dtype=np.float32)
                                  ).to(device=x.device, dtype=x.dtype)
        radius = (len(kernel) - 1) // 2
        x = _pad_symmetric(x, radius, axis)
        if len(kernel) >= TOEPLITZ_MIN_TAPS:
            x = _toeplitz1d(x, kernel, axis)
        else:
            x = _conv1d(x, kernel, axis)
    return x


def gaussian_filter(img, sigma, truncate=4.0):
    """Gaussian-filters a 2D float tensor (tensor in, tensor out).

    ``sigma`` may be a scalar or a per-axis pair; ``sigma == 0`` along an
    axis is the identity."""
    if np.isscalar(sigma):
        sigma = (float(sigma), float(sigma))
    else:
        sigma = tuple(float(s) for s in sigma)
    return _gaussian_filter_2d(img, sigma, float(truncate))
