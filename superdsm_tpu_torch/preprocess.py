"""Stage 1: intensity offsets (preprocessing).

Port of :mod:`superdsm_tpu.preprocess`. Computes the offset image
intensities ``y = G_sigma1(g) - tau`` where ``tau`` is a clipped Gaussian
background estimate blended near bright areas — semantics of the
reference's ``superdsm/preprocess.py:39-68`` — with the three Gaussian
filters and the blend on the selected torch device and the EDT-based blend
weights on the host.

The image goes up uint16-quantized and the offsets come back
int16-quantized, exactly as in the JAX package, so both packages feed the
same quantized numbers to the later stages.

Hyperparameters (namespace ``preprocess``): ``sigma1`` (default sqrt(2)),
``sigma2`` (default 40, auto ``AF_sigma2 * scale``), ``offset_clip``
(default 3), ``lower_clip_mean`` (default False).
"""

import math

import numpy as np
import torch

from ._device import to_device
from .pipeline import Stage
from .ops.gaussian import _gaussian_filter_2d
from .ops.edt import edt

_F32 = torch.float32


def _preprocess_program(gq, gscale, blendq, offset_clip_abs, gmean,
                        sigma1, sigma2, lower_clip_mean):
    """The whole offset computation on the device; returns the int16
    offsets (as an int32 tensor) and their float32 scale."""
    g = gq * gscale
    offset_original = _gaussian_filter_2d(g, (sigma2, sigma2), 4.0)
    if blendq is None:
        offset_combined = offset_original
    else:
        blend = blendq * (1.0 / 65535.0)
        offset_clipped = _gaussian_filter_2d(
            torch.clamp(g, torch.zeros((), dtype=_F32, device=g.device),
                        offset_clip_abs), (sigma2, sigma2), 4.0)
        offset_combined = (1 - blend) * offset_clipped + blend * offset_original
    if lower_clip_mean:
        offset_combined = torch.maximum(offset_combined, gmean)
    y = _gaussian_filter_2d(g, (sigma1, sigma1), 4.0) - offset_combined
    yscale = y.abs().max().clamp_min(1e-30)
    # torch.round rounds half to even, as jnp.round does
    yq = torch.round(y * (32767.0 / yscale)).to(torch.int32)
    return yq, yscale


class Preprocessing(Stage):

    ENABLED_BY_DEFAULT = True

    def __init__(self):
        super().__init__('preprocess', inputs=['g_raw'], outputs=['y'])

    def process(self, input_data, cfg, out, log_root_dir):
        g_raw = np.asarray(input_data['g_raw'], np.float32)

        sigma1 = cfg.get('sigma1', math.sqrt(2))
        sigma2 = cfg.get('sigma2', 40)
        offset_clip = cfg.get('offset_clip', 3)
        lower_clip_mean = cfg.get('lower_clip_mean', False)

        # uint16 quantization of the (normalized, non-negative) intensities
        gmax = float(g_raw.max())
        gq_scale = np.float32((gmax if gmax > 0 else 1.0) / 65535.0)
        gq = np.round(g_raw * (1.0 / gq_scale)).astype(np.uint16)

        if np.isinf(offset_clip):
            blendq = None
            offset_clip_abs = np.float32(0)
        else:
            offset_clip_abs = offset_clip * float(g_raw.std())
            clip_area = (g_raw > offset_clip_abs)
            blend = edt(~clip_area)
            blend = np.clip(sigma2 - blend, 0, np.inf)
            bmax = blend.max()
            blend = (blend / (bmax if bmax > 0 else 1)) ** 2
            blendq = np.round(blend * 65535.0).astype(np.uint16)

        # uint16 values are exact in float32, so they travel as float32
        yq, yscale = _preprocess_program(
            to_device(gq.astype(np.float32), _F32), to_device(gq_scale, _F32),
            None if blendq is None else to_device(blendq.astype(np.float32), _F32),
            to_device(np.float32(offset_clip_abs), _F32),
            to_device(np.float32(g_raw.mean()), _F32),
            float(sigma1), float(sigma2), bool(lower_clip_mean))
        yq = yq.cpu().numpy()
        y = yq.astype(np.float64) * (float(yscale) / 32767.0)

        return {
            'y': y,
        }

    def configure_ex(self, scale, radius, diameter):
        return {
            'sigma2': (scale, 1.0),
        }
