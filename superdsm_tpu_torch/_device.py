"""The device the port computes on.

The device is explicit: it defaults to ``cuda`` and is never chosen
silently. :func:`get_device` raises when the selected device is CUDA and no
CUDA device is present — a missing card must fail the run, not fall back to
the CPU. Tests and CPU users select ``cpu`` with :func:`set_device` or the
:func:`use_device` context.
"""

import contextlib

import torch

_DEVICE = torch.device('cuda')


def set_device(device):
    """Selects the device for all subsequent solves and filters."""
    global _DEVICE
    _DEVICE = torch.device(device)


def get_device():
    """The selected device; raises if it is CUDA and CUDA is unavailable."""
    if _DEVICE.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'superdsm_tpu_torch: the selected device is CUDA but no CUDA '
            'device is available; select the CPU explicitly with '
            "superdsm_tpu_torch.set_device('cpu')")
    return _DEVICE


@contextlib.contextmanager
def use_device(device):
    """Context manager selecting ``device`` for the enclosed block."""
    previous = _DEVICE
    set_device(device)
    try:
        yield _DEVICE
    finally:
        set_device(previous)


def on_cpu():
    """Whether the selected device is the CPU."""
    return get_device().type == 'cpu'


def to_device(array, dtype):
    """numpy array -> tensor of ``dtype`` on the selected device (the dtype
    is always stated: ``torch.from_numpy`` keeps float64 where JAX with x64
    off would have cast to float32)."""
    return torch.as_tensor(array).to(device=get_device(), dtype=dtype)
