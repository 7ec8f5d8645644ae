"""Automatic hyperparameter configuration from the estimated object scale.

Port of :mod:`superdsm_tpu.automation` (counterpart of the reference's
``superdsm/automation.py:41-117``): the object scale is estimated with the
masked determinant-of-Hessian blob detector of
:mod:`superdsm_tpu_torch.ops.blob`, and each stage's
:meth:`~superdsm_tpu_torch.pipeline.Stage.configure` spec is expanded into
``key = factor * AF_key`` config entries with type/min/max clamps.
"""

import builtins
import math

import numpy as np

from . import trace
from .image import normalize_image
from .ops.blob import blob_doh


def _detection_sigmas(min_radius, max_radius, num_radii):
    """DoH sigma grid for the radius search window, with a half-minimum
    sentinel sigma prepended: detections landing on the sentinel are
    below-window responses and get filtered out."""
    window = np.linspace(min_radius, max_radius, num_radii) / math.sqrt(2)
    return np.concatenate([[window.min() / 2], window])


def _radius_consensus(radii):
    """(consensus mean radius, inlier mask): inliers lie within one
    mean-absolute-deviation of the median radius (TPAMI 2023 §3.1)."""
    center = np.median(radii)
    spread = np.mean(np.abs(radii - center))
    inliers = (radii >= center - spread) & (radii <= center + spread)
    return np.mean(radii[inliers]), inliers


def _estimate_scale(im, min_radius=20, max_radius=200, num_radii=10,
                    thresholds=(0.01,), inlier_tol=np.inf):
    """Estimates the object scale sigma of an image from the consensus
    radius of masked determinant-of-Hessian blob detections
    (``scale = mean radius / sqrt(2)``; TPAMI 2023 §3.1).

    :return: ``(scale, detections, inlier_mask)``; raises
        :class:`ValueError` when no threshold yields any in-window blob.
    """
    sigmas = _detection_sigmas(min_radius, max_radius, num_radii)
    g = normalize_image(im)
    g = g / g.max()

    for threshold in sorted(thresholds, reverse=True):
        detections = blob_doh(g, sigmas, threshold=threshold)
        in_window = ~np.isclose(detections[:, 2], sigmas.min())
        detections = detections[in_window]
        if len(detections):
            mean_radius, inliers = _radius_consensus(
                detections[:, 2] * math.sqrt(2))
            return mean_radius / math.sqrt(2), detections, inliers

    raise ValueError('scale estimation failed')


def _create_config_entry(cfg, key, factor, default_user_factor, type=None, min=None, max=None):
    """Sets ``key = factor * AF_key`` (the ``AF_`` sibling entry holds the
    user's scale factor, defaulting to ``default_user_factor``), then applies
    the optional ``type`` conversion and ``min``/``max`` clamps. Parameter
    names are the stage-``configure`` spec contract."""
    namespace, _, leaf = key.rpartition('/')
    user_factor = cfg.get(f'{namespace}/AF_{leaf}', default_user_factor)
    cfg.set_default(key, factor * user_factor, True)
    if type is not None:
        cfg.update(key, func=type)
    if min is not None:
        cfg.update(key, func=lambda value, lo=min: builtins.max(value, lo))
    if max is not None:
        cfg.update(key, func=lambda value, hi=max: builtins.min(value, hi))


def create_config(pipeline, base_cfg, img):
    """Expands scale-dependent hyperparameter defaults into a new config.

    If ``AF_scale`` is set in ``base_cfg``, that scale is used directly;
    otherwise the scale is estimated from ``img``. Every stage contributes
    ``(factor, default_user_factor[, kwargs])`` specs via its
    :meth:`~superdsm_tpu_torch.pipeline.Stage.configure` method.

    :return: ``(cfg, scale)``.
    """
    cfg = base_cfg.copy()
    scale = cfg.get('AF_scale', None)
    if scale is None:
        scale = _estimate_scale(img, num_radii=10, thresholds=[0.01])[0]
    for stage in pipeline.stages:
        for key, spec in stage.configure(scale).items():
            assert len(spec) in (2, 3), \
                f'bad configure spec for {type(stage).__name__}/{key}: ' \
                f'expected (factor, default[, kwargs]), got {len(spec)} items'
            kwargs = spec[2] if len(spec) == 3 else {}
            _create_config_entry(cfg, f'{stage.cfgns}/{key}', spec[0],
                                 spec[1], **kwargs)
    return cfg, scale


def process_image(pipeline, base_cfg, g_raw, **kwargs):
    """Segments an image with automatically configured hyperparameters.

    :param pipeline: The :class:`~superdsm_tpu_torch.pipeline.Pipeline` to use.
    :param base_cfg: Custom hyperparameters (:class:`~superdsm_tpu_torch.config.Config`).
    :param g_raw: The raw image.
    :return: Same tuple as :meth:`~superdsm_tpu_torch.pipeline.Pipeline.process_image`.
    """
    with trace.span(trace.IMAGE):
        cfg, _ = create_config(pipeline, base_cfg, g_raw)
        return pipeline.process_image(g_raw, cfg=cfg, **kwargs)
