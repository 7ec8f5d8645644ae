"""Determinant-of-Hessian blob detection on the selected torch device.

Port of :mod:`superdsm_tpu.ops.blob`. The scale-normalized Hessian
determinant is computed analytically from separable Gaussian-derivative
convolutions::

    DoH(x; sigma) = sigma^4 (L_xx L_yy - L_xy^2),   L = G_sigma * image

with the LoG-negativity mask (bright-blob selection) from the same
convolutions. Sigmas above :data:`SIGMA_OCTAVE_MAX` are evaluated on a
2x-downsampled octave and nearest-upsampled with ``jax.image.resize``'s
pixel convention. Peaks are the 3x3x3 local maxima of the (sigma, row, col)
cube with constant-0 padding on every axis, as
``ndi.maximum_filter(cube, mode='constant')``; overlapping blobs are pruned
on the host. The convolutions are plain float32 ``conv2d`` (the package
turns TF32 off at import: peak finding is an equality test, so a TF32 conv
would change which pixels are peaks).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._device import get_device
from .gaussian import _pad_symmetric


def _gaussian_derivative_kernels(sigma, truncate=4.0):
    """Returns sampled (g, g', g'') 1D kernels for the given sigma."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1).astype(np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    g1 = -x / sigma ** 2 * g
    g2 = (x ** 2 - sigma ** 2) / sigma ** 4 * g
    return (g.astype(np.float32), g1.astype(np.float32), g2.astype(np.float32))


def _conv_sep(x, krow, kcol):
    """Separable 2D cross-correlation (``krow`` along rows, ``kcol`` along
    columns) with symmetric boundary handling; output has ``x``'s shape."""
    x = _pad_symmetric(x, (len(krow) - 1) // 2, 0)
    x = _pad_symmetric(x, (len(kcol) - 1) // 2, 1)
    kr = torch.from_numpy(krow).to(x.device).view(1, 1, -1, 1)
    kc = torch.from_numpy(kcol).to(x.device).view(1, 1, 1, -1)
    return F.conv2d(F.conv2d(x[None, None], kr), kc)[0, 0]


#: Largest sigma evaluated at full resolution; larger ones run on a
#: 2^k-downsampled octave with sigma / 2^k (the JAX package's constant).
SIGMA_OCTAVE_MAX = 10.0


def _downsample2(x):
    """2x2 mean pooling (octave step; the preceding octave's Gaussian blur
    acts as the antialias filter)."""
    H2, W2 = (x.shape[0] // 2) * 2, (x.shape[1] // 2) * 2
    x = x[:H2, :W2]
    return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) * 0.25


def _octave_of(sigma):
    k = 0
    while sigma > SIGMA_OCTAVE_MAX:
        sigma /= 2.0
        k += 1
    return k, sigma


def _nearest_index(m, n):
    """Source index of each of ``n`` output pixels when ``m`` pixels are
    resized to ``n`` by ``jax.image.resize(..., 'nearest')``:
    ``floor((i + 0.5) * m / n)`` evaluated in float32, as JAX does (it is
    not ``F.interpolate``'s ``floor(i * m / n)``)."""
    pos = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m)
    pos = pos / np.float32(n)
    return np.minimum(np.floor(pos).astype(np.int64), m - 1)


def _resize_nearest(x, shape):
    """Nearest resize of a 2D tensor to ``shape`` (see :func:`_nearest_index`)."""
    rows = torch.from_numpy(_nearest_index(x.shape[0], shape[0])).to(x.device)
    cols = torch.from_numpy(_nearest_index(x.shape[1], shape[1])).to(x.device)
    return x[rows][:, cols]


def _doh_response(img, sigmas):
    """Scale-normalized DoH responses and LoGs of a 2D float32 tensor for
    each sigma; returns two (S, H, W) cubes at full resolution. A sigma
    whose octave level has no pixels left (an image smaller than 2^k) gives
    zeros: no blob of that size fits (the JAX package's symmetric padding
    loops forever on the empty level)."""
    H, W = img.shape
    levels = [img]
    dohs, logs = [], []
    for sigma in sigmas:
        k, s_eff = _octave_of(float(sigma))
        while len(levels) <= k:
            levels.append(_downsample2(levels[-1]))
        x = levels[k]
        if x.numel() == 0:
            dohs.append(torch.zeros_like(img))
            logs.append(torch.zeros_like(img))
            continue
        g, g1, g2 = _gaussian_derivative_kernels(s_eff)
        Lxx = _conv_sep(x, g2, g)
        Lyy = _conv_sep(x, g, g2)
        Lxy = _conv_sep(x, g1, g1)
        doh = (s_eff ** 4) * (Lxx * Lyy - Lxy * Lxy)
        log = Lxx + Lyy
        if k:
            doh = _resize_nearest(doh, (H, W))
            log = _resize_nearest(log, (H, W))
        dohs.append(doh)
        logs.append(log)
    return torch.stack(dohs), torch.stack(logs)


def _f32_threshold(threshold):
    """Largest float32 ``t32`` with ``{x_f32 : x > t32}`` equal to
    ``{x_f32 : float64(x) > threshold}``: the float32 comparison on the
    device is exactly the float64 one."""
    t32 = np.float32(threshold)
    if float(t32) > float(threshold):
        t32 = np.nextafter(t32, np.float32(-np.inf), dtype=np.float32)
    return t32


def _neighborhood_max(cube):
    """3x3x3 maximum of an (S, H, W) cube with constant-0 padding on every
    axis, the sigma axis included (``max_pool3d``'s own padding would pad
    with -inf)."""
    padded = F.pad(cube, (1, 1, 1, 1, 1, 1), value=0.0)
    return F.max_pool3d(padded[None, None], 3, stride=1)[0, 0]


def _doh_peak_mask(img, sigmas, threshold, log_mask):
    """Masked DoH response cube and its boolean local-maximum mask
    ``neighborhood max == response > threshold`` (both (S, H, W))."""
    dohs, logs = _doh_response(img, sigmas)
    if log_mask:
        dohs = dohs * (logs < 0)
    peaks = (_neighborhood_max(dohs) == dohs) & (dohs > float(threshold))
    return dohs, peaks


def _lens_overlap_frac(r1, r2, d):
    """Area of the lens intersection of two disks over the smaller disk's
    area (scalar; called only for the rare partially-overlapping pairs)."""
    r1sq, r2sq, dsq = r1 ** 2, r2 ** 2, d ** 2
    alpha1 = math.acos(np.clip((dsq + r1sq - r2sq) / (2 * d * r1), -1, 1))
    alpha2 = math.acos(np.clip((dsq + r2sq - r1sq) / (2 * d * r2), -1, 1))
    area = (r1sq * (alpha1 - math.sin(2 * alpha1) / 2)
            + r2sq * (alpha2 - math.sin(2 * alpha2) / 2))
    return area / (math.pi * min(r1sq, r2sq))


def _prune_blobs(blobs, overlap):
    """Removes the lower-response blob of every overlapping pair
    (disk-overlap semantics of skimage ``_prune_blobs``). Full-containment
    and non-interacting pairs resolve array-wise; only partially
    overlapping pairs run the scalar lens-area formula."""
    if len(blobs) == 0:
        return blobs
    order = np.argsort(-blobs[:, 3])
    blobs = blobs[order]
    radii = blobs[:, 2] * math.sqrt(2)
    keep = np.ones(len(blobs), bool)
    for i in range(len(blobs)):
        if not keep[i]:
            continue
        js = np.nonzero(keep[i + 1:])[0] + (i + 1)
        if js.size == 0:
            continue
        r1, r2 = radii[i], radii[js]
        diff = blobs[js, :2] - blobs[i, :2]
        d = np.sqrt((diff * diff).sum(axis=1))
        interacting = ~(d > r1 + r2)
        contained = interacting & (d <= np.abs(r1 - r2))
        if overlap < 1.0:
            keep[js[contained]] = False  # frac == 1.0 > overlap
        partial = np.nonzero(interacting & ~contained)[0]
        for jdx in partial:
            if _lens_overlap_frac(r1, float(r2[jdx]), float(d[jdx])) > overlap:
                keep[js[jdx]] = False
    return blobs[keep]


def blob_doh(image, sigma_list, threshold=0.01, overlap=0.5, log_mask=True):
    """Detects bright blobs; returns an (N, 4) array of
    ``(row, col, sigma, response)`` sorted by decreasing response.

    :param log_mask: Restrict detections to LoG-negative areas per sigma
        (the reference's bright-blob masking).
    """
    img = torch.as_tensor(np.asarray(image, np.float32), device=get_device())
    sigmas = tuple(float(s) for s in sigma_list)
    cube, peaks = _doh_peak_mask(img, sigmas, _f32_threshold(threshold),
                                 bool(log_mask))
    # row-major order in (row, col, sigma), as np.argwhere of the (H, W, S)
    # cube gives it: the pruning's tie behaviour depends on it
    coords = peaks.permute(1, 2, 0).nonzero()
    if coords.shape[0] == 0:
        return np.empty((0, 4))
    values = cube[coords[:, 2], coords[:, 0], coords[:, 1]]
    coords = coords.cpu().numpy()
    blobs = np.zeros((len(coords), 4))
    blobs[:, :2] = coords[:, :2]
    blobs[:, 2] = np.asarray(sigma_list)[coords[:, 2]]
    blobs[:, 3] = values.double().cpu().numpy()
    return _prune_blobs(blobs, overlap)
