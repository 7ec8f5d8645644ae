"""Carrying pipeline state from the JAX package into the port.

The system has no learned weights; its state is the pipeline's ``data``
dictionary (``Image``, ``Object``, the atom graph, the set cover, numpy
arrays). :func:`from_jax` turns such a structure, as the JAX package
produced it, into the port's classes — through numpy and by attribute, so
this module never imports ``superdsm_tpu`` (which imports JAX). A JAX run
stopped at ``last_stage='c2f-region-analysis'`` can then resume in the port
with ``first_stage='global-energy-minimization'`` (the batch pickup contract
of :meth:`~superdsm_tpu_torch.pipeline.Pipeline.process_image`), so every
stage can be held against the reference on its own.
"""

import importlib

import numpy as np

_SRC = 'superdsm_tpu'
_DST = 'superdsm_tpu_torch'

_SCALARS = (str, bytes, int, float, complex, bool, type(None), np.generic)


def _port_class(cls):
    """The port's class of the same module path and name, or ``None`` if
    ``cls`` is not a JAX-package class."""
    mod = cls.__module__
    if mod != _SRC and not mod.startswith(_SRC + '.'):
        return None
    module = importlib.import_module(_DST + mod[len(_SRC):])
    return getattr(module, cls.__qualname__)


def from_jax(value, _memo=None):
    """Deep-converts ``value`` (e.g. a pipeline ``data`` dict of the JAX
    package) into the port's classes. numpy arrays are copied; device
    arrays become numpy arrays; shared and cyclic references (an object's
    warm-start parent) stay shared."""
    memo = {} if _memo is None else _memo
    if isinstance(value, _SCALARS):
        return value
    key = id(value)
    if key in memo:
        return memo[key]
    if isinstance(value, np.ndarray):
        out = value.copy()
    elif isinstance(value, dict):
        out = memo[key] = {}
        for k, v in value.items():
            out[from_jax(k, memo)] = from_jax(v, memo)
    elif isinstance(value, list):
        out = memo[key] = []
        out.extend(from_jax(v, memo) for v in value)
    elif isinstance(value, (tuple, set, frozenset)):
        out = type(value)(from_jax(v, memo) for v in value)
    else:
        cls = _port_class(type(value))
        if cls is None:
            if hasattr(value, '__array__'):
                return np.asarray(value)
            raise TypeError(f'cannot carry {type(value).__module__}.'
                            f'{type(value).__qualname__} into the port')
        out = memo[key] = cls.__new__(cls)
        for k, v in vars(value).items():
            out.__dict__[k] = from_jax(v, memo)
    memo[key] = out
    return out
