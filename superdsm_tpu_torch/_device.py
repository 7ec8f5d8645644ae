"""The device the port computes on.

The device is explicit: it defaults to ``cuda`` and is never chosen
silently. :func:`get_device` raises when the selected device is CUDA and no
CUDA device is present — a missing card must fail the run, not fall back to
the CPU. Tests and CPU users select ``cpu`` with :func:`set_device` or the
:func:`use_device` context.

The selection has two levels: the process-wide device (:func:`set_device`,
:func:`use_device`) and a per-thread override (:func:`thread_device`),
which a thread that pins its solves to one device sets
(:func:`superdsm_tpu_torch.dsm.batching.device_scope`); :func:`get_device`
returns the thread's override where it has one.
"""

import contextlib
import threading

import torch

_DEVICE = torch.device('cuda')
_THREAD = threading.local()


def set_device(device):
    """Selects the device for all subsequent solves and filters."""
    global _DEVICE
    _DEVICE = torch.device(device)


_NO_CUDA = ('superdsm_tpu_torch: the selected device is CUDA but no CUDA '
            'device is available; select the CPU explicitly with '
            "superdsm_tpu_torch.set_device('cpu')")


def check_present(device):
    """Raises unless ``device`` is present: a CUDA device needs CUDA, and
    one with an index needs that many cards. Counts the cards through NVML
    (``torch.cuda.device_count``), so a process that forks workers stays
    free to fork (:func:`check_device`)."""
    if device.type != 'cuda':
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError(_NO_CUDA)
    if (device.index or 0) >= count:
        raise RuntimeError(f'superdsm_tpu_torch: {device} is not present '
                           f'({count} CUDA device(s))')
    return device


def scoped_device():
    """This thread's override (:func:`thread_device`), or None."""
    return getattr(_THREAD, 'device', None)


def get_device():
    """The selected device (this thread's override, else the process-wide
    one); raises if it is CUDA and CUDA is unavailable."""
    device = scoped_device() or _DEVICE
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return device


@contextlib.contextmanager
def thread_device(device):
    """Selects ``device`` for the enclosed block in this thread only (other
    threads keep theirs); a device that is not present raises on entry."""
    device = check_present(torch.device(device))
    previous = scoped_device()
    _THREAD.device = device
    try:
        if device.type == 'cuda':
            # ctypes launches and new streams use the thread's current card
            with torch.cuda.device(device):
                yield device
        else:
            yield device
    finally:
        _THREAD.device = previous


def check_device():
    """:func:`get_device` for a process that forks workers: it counts the
    devices through NVML (``torch.cuda.device_count``) and leaves CUDA
    uninitialized, where ``torch.cuda.is_available`` initializes the driver
    — after which a forked child cannot use the card."""
    if _DEVICE.type == 'cuda' and torch.cuda.device_count() == 0:
        raise RuntimeError(_NO_CUDA)
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
