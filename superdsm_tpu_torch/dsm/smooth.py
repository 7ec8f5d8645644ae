"""Deformation basis (the matrix G̃_ω) built on device from coordinates.

The reference materializes G̃_ω as a block-Toeplitz slice via
``skimage.util.view_as_windows`` — so memory-hungry that concurrent
allocations are throttled with a POSIX semaphore
(``superdsm/dsm.py:137-239``, ``_aux.py:63-96``). Here the
matrix entries are evaluated analytically on the device:

    G[p, k] = exp(-(dr^2 + dc^2) / (2 sigma^2)) * [|dr| <= R] * [|dc| <= R]

with ``dr, dc`` the integer pixel offsets between mask pixel ``p`` and
subsample point ``k``, followed by row normalization to sum 1 — exactly the
kernel the reference obtains by Gaussian-filtering a delta image and
row-normalizing (``superdsm/dsm.py:184-195``; the per-axis
kernel normalization cancels in the row normalization).

The subsample grid is the reference's greedy chessboard-coverage grid
(``superdsm/dsm.py:164-181``), computed by the native C++
runtime with a numpy fallback.
"""

import numpy as np

from ..native import subsample_grid_native


def smooth_matrix_params(smooth_amount, shape_multiplier):
    """Returns ``(kernel_shape, cutoff_radius)`` of the Gaussian PSF.

    ``kernel_shape`` mirrors ``round(1 + 4 * sigma * multiplier)``
    (``superdsm/dsm.py:137-142``); the effective support
    radius per axis is ``min(kernel_shape // 2, int(4 * sigma + 0.5))``.
    """
    if not np.isfinite(smooth_amount):
        return 0, 0
    S = int(round(1 + smooth_amount * 4 * shape_multiplier))
    R = min(S // 2, int(4 * smooth_amount + 0.5))
    return S, R


def subsample_grid(mask, stride, offset=(0, 0)):
    """Greedy chessboard-coverage subsample grid of a boolean mask.

    Starts from a regular ``stride`` grid intersected with the mask and adds
    the masked pixel with the smallest chessboard distance >= stride until
    every masked pixel is within ``stride`` of a grid point.
    """
    stride = int(stride)
    grid = subsample_grid_native(mask, stride, offset)
    if grid is not None:
        return grid
    return _subsample_grid_py(mask, stride, offset)


def _subsample_grid_py(mask, stride, offset=(0, 0)):
    import scipy.ndimage as ndi
    mask = np.asarray(mask, bool)
    go = (int(offset[0]) % stride, int(offset[1]) % stride)
    grid = np.zeros_like(mask)
    grid[go[0]::stride, go[1]::stride] = True
    grid &= mask
    # cdt returns -1 when there is no source pixel at all; the reference's
    # distance_transform_bf returns uint32 max there (i.e. +inf), so a mask
    # missed entirely by the regular grid still receives greedy points
    # (superdsm/dsm.py:164-181)
    d = ndi.distance_transform_cdt(~grid, metric='chessboard').astype(np.int64)
    dist = mask * np.where(d < 0, np.iinfo(np.int32).max, d)
    H, W = mask.shape
    rr, cc = np.indices((H, W))
    while True:
        outside = dist >= stride
        if not outside.any():
            break
        best = dist[outside].min()
        pos = np.argwhere(dist == best)[0]
        grid[pos[0], pos[1]] = True
        cheb = np.maximum(np.abs(rr - pos[0]), np.abs(cc - pos[1]))
        dist = np.where(mask, np.minimum(dist, cheb), 0)
    return grid


def prepare_deformation(mask_crop, smooth_amount, shape_multiplier, smooth_subsample):
    """Returns the subsample-point coordinates for a cropped region mask.

    Returns an ``(K, 2) int32`` array of crop-local subsample coordinates, or
    an empty array if deformations are disabled for this region (infinite
    ``smooth_amount``, or the kernel is too large for the mask — the
    reference's NULL-matrix case, ``superdsm/dsm.py:184-187,229-231``).
    """
    if not np.isfinite(smooth_amount):
        return np.zeros((0, 2), np.int32)
    S, _ = smooth_matrix_params(smooth_amount, shape_multiplier)
    if (np.asarray(mask_crop.shape) <= S // 2).any():
        return np.zeros((0, 2), np.int32)
    grid = subsample_grid(mask_crop, smooth_subsample)
    grid &= mask_crop
    pts = np.argwhere(grid).astype(np.int32)
    return pts


def build_smooth_matrix(pix, sub, sigma, cutoff, kmask=None):
    """Builds the row-normalized (..., P, K) deformation matrix on device.

    :param pix: (..., P, 2) float32 tensor of pixel coordinates (crop-local).
    :param sub: (..., K, 2) float32 tensor of subsample-point coordinates
        (same frame).
    :param sigma: Gaussian sigma (``smooth_amount``).
    :param cutoff: per-axis support radius R.
    :param kmask: optional (..., K) 0/1 float32 tensor of valid subsample
        points (padding).
    """
    import torch
    dr = pix[..., :, None, 0] - sub[..., None, :, 0]
    dc = pix[..., :, None, 1] - sub[..., None, :, 1]
    supp = (dr.abs() <= cutoff) & (dc.abs() <= cutoff)
    g = torch.exp(-(dr * dr + dc * dc) / (2.0 * sigma * sigma))
    g = torch.where(supp, g, torch.zeros((), dtype=g.dtype, device=g.device))
    if kmask is not None:
        g = g * kmask[..., None, :]
    norm = g.sum(dim=-1, keepdim=True)
    return g / norm.clamp_min(1e-30)
