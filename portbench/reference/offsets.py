"""Plain reference of SuperDSM's preprocessing: the offset image.

``y = G_sigma1(g) - tau``, where ``g`` is the image normalized to [0, 1]
and uint16-quantized (:func:`stage_input`), ``tau`` blends the Gaussian background estimate
``G_sigma2(g)`` with that of the image clipped at ``offset_clip`` standard
deviations, weighted by the squared, normalized distance to the clipped
area (SuperDSM's ``preprocess.py``; the quantization of the image to uint16
and of the blend weights to 1/65535 is the configuration's stated input
format). Gaussian filters: the sampled Gaussian truncated at 4 sigma and
normalized to sum 1, with symmetric ("reflect") boundaries, as scipy's.

Plain numpy and PyTorch, computed in the ``dtype`` asked for (float64 for
the reference, a lower one for the control). It imports nothing of the
program under test.
"""

import math

import numpy as np
import scipy.ndimage as ndi
import torch
import torch.nn.functional as F


def gaussian_kernel(sigma, truncate=4.0):
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return k / k.sum()


def _reflect_index(n, radius, device):
    i = torch.arange(-radius, n + radius, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def gaussian_filter(x, sigma, dtype):
    """Separable Gaussian filter of a 2-D tensor, computed in ``dtype``."""
    k = torch.as_tensor(gaussian_kernel(sigma), dtype=dtype, device=x.device)
    r = (len(k) - 1) // 2
    x = x.to(dtype)
    for axis in (0, 1):
        n = x.shape[axis]
        x = x.index_select(axis, _reflect_index(n, r, x.device))
        rows = x if axis == 1 else x.T
        rows = F.conv1d(rows.contiguous()[:, None, :], k[None, None, :])[:, 0, :]
        x = rows if axis == 1 else rows.T
    return x


def settings(config):
    """``(sigma1, sigma2, offset_clip, lower_clip_mean)`` of a configuration
    file's ``config`` (SuperDSM's keys and defaults; ``sigma2`` defaults to
    ``AF_sigma2`` (1) times ``AF_scale``)."""
    pre = config.get('preprocess', {})
    sigma1 = pre.get('sigma1', math.sqrt(2))
    sigma2 = pre.get('sigma2')
    if sigma2 is None:
        if 'AF_scale' not in config:
            raise ValueError('the reference needs preprocess/sigma2 or AF_scale')
        sigma2 = pre.get('AF_sigma2', 1.0) * config['AF_scale']
    return (float(sigma1), float(sigma2), float(pre.get('offset_clip', 3)),
            bool(pre.get('lower_clip_mean', False)))


def stage_input(img):
    """The stage's input as the configuration states it: the raw image
    normalized to [0, 1] (its minimum subtracted in float32, divided in
    float64) and handed on as float32; its float32 standard deviation (the
    clip threshold is a comparison with it, so it is taken as numpy takes
    it, in float32, or a pixel at the threshold could fall on the other
    side); and its uint16 quantization in steps of ``max / 65535``."""
    img = np.asarray(img, np.float32)
    span = img.max() - img.min()
    g = ((img - img.min()).astype(np.float64) / (span if span != 0 else 1)).astype(np.float32)
    gmax = float(g.max())
    step = np.float32((gmax if gmax > 0 else 1.0) / 65535.0)
    gq = np.round(g * (np.float32(1.0) / step)).astype(np.float64) * float(step)
    return g, float(g.std()), gq


def offsets(img, config, dtype=torch.float64, device='cpu'):
    """The offset image of raw image ``img`` under ``config``, as float64
    numpy, filtered in ``dtype``."""
    sigma1, sigma2, offset_clip, lower_clip_mean = settings(config)
    g, std, gq = stage_input(img)
    x = torch.as_tensor(gq, dtype=torch.float64, device=device)
    original = gaussian_filter(x, sigma2, dtype)
    if np.isinf(offset_clip):
        combined = original
    else:
        clip_abs = offset_clip * std
        dist = ndi.distance_transform_edt(~(g > clip_abs))
        blend = np.clip(sigma2 - dist, 0, np.inf)
        bmax = blend.max()
        blend = np.round((blend / (bmax if bmax > 0 else 1)) ** 2 * 65535.0) / 65535.0
        b = torch.as_tensor(blend, dtype=dtype, device=device)
        clipped = gaussian_filter(x.clamp(0.0, clip_abs), sigma2, dtype)
        combined = (1 - b) * clipped + b * original
    if lower_clip_mean:
        combined = torch.maximum(combined, torch.as_tensor(float(g.mean()), dtype=dtype,
                                                           device=device))
    y = gaussian_filter(x, sigma1, dtype) - combined
    return y.to(torch.float64).cpu().numpy()


def quantized(y):
    """``y`` as the stage hands it on: int16 steps of ``max |y| / 32767``."""
    scale = max(float(np.abs(y).max()), 1e-30)
    return np.round(y * (32767.0 / scale)) * (scale / 32767.0)
