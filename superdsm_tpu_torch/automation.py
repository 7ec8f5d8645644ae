"""Automatic hyperparameter configuration from the object scale.

Port of :mod:`superdsm_tpu.automation` (counterpart of the reference's
``superdsm/automation.py:41-117``): each stage's
:meth:`~superdsm_tpu_torch.pipeline.Stage.configure` spec is expanded into
``key = factor * AF_key`` config entries with type/min/max clamps.

The scale must be given as ``AF_scale``: automatic scale estimation (the
determinant-of-Hessian blob detector of ``superdsm_tpu/ops/blob.py``) is
not ported yet.
"""

import builtins


def _estimate_scale(im, *args, **kwargs):
    """Automatic object-scale estimation — not ported yet."""
    raise NotImplementedError(
        'superdsm_tpu_torch: automatic scale estimation '
        '(automation._estimate_scale, ops/blob.py) is not ported yet — see '
        'the ROADMAP item "scale estimation"; set AF_scale in the config')


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
    otherwise the scale would be estimated from ``img``, which this port
    does not do yet (:func:`_estimate_scale` raises). Every stage contributes
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
    cfg, _ = create_config(pipeline, base_cfg, g_raw)
    return pipeline.process_image(g_raw, cfg=cfg, **kwargs)
