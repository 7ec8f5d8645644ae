"""Device meshes.

Port of :mod:`superdsm_tpu.parallel.mesh`. A :class:`Mesh` is a
``(n_batch, n_pixel)`` grid of torch devices with the ``shape``,
``axis_names`` and ``size`` of ``jax.sharding.Mesh``; the pipeline mesh
(:func:`superdsm_tpu_torch.dsm.batching.set_pipeline_mesh`) splits solver
batches over its batch axis, and :mod:`superdsm_tpu_torch.parallel.newton`
shards problems over both axes. A device may appear more than once (two
shards on one card).
"""

import os

import numpy as np
import torch

from .._device import check_device, check_present, scoped_device


class Mesh:
    """A 2D grid of devices with named axes."""

    def __init__(self, devices, axis_names=('batch', 'pixel')):
        rows = [list(row) for row in devices]
        grid = np.empty((len(rows), len(rows[0])), object)
        for i, row in enumerate(rows):
            for j, device in enumerate(row):
                grid[i, j] = torch.device(device)
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f'Mesh({self.shape}, {self.devices.tolist()})'


def local_devices():
    """Every device of the selected device's type: each CUDA card, or the
    CPU. Counts the cards through NVML, so a process that forks workers
    stays free to fork."""
    device = scoped_device() or check_device()
    if device.type == 'cuda':
        return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def make_mesh(n_batch=None, n_pixel=1, devices=None, axis_names=('batch', 'pixel')):
    """Builds a 2D ``(batch, pixel)`` mesh over the given devices.

    :param n_batch: Devices along the batch (data-parallel) axis; defaults to
        ``len(devices) // n_pixel``.
    :param n_pixel: Devices along the pixel (region-sharding) axis.
    :param devices: Devices in mesh order, repeats allowed; defaults to
        :func:`local_devices`.
    """
    devices = local_devices() if devices is None else \
        [torch.device(d) for d in devices]
    for device in devices:
        check_present(device)
    if n_batch is None:
        n_batch = len(devices) // n_pixel
    if n_batch < 1 or n_pixel < 1 or n_batch * n_pixel > len(devices):
        raise ValueError(f'mesh {n_batch}x{n_pixel} needs more than '
                         f'{len(devices)} devices')
    used = devices[:n_batch * n_pixel]
    return Mesh([used[i * n_pixel:(i + 1) * n_pixel] for i in range(n_batch)],
                axis_names)


def default_mesh():
    """All local devices on the batch axis."""
    return make_mesh(n_pixel=1)


def parse_mesh_spec(spec):
    """Builds a mesh from a user spec string.

    Formats: ``"8"`` (8 devices on the batch axis), ``"batch:4"``,
    ``"batch:4,pixel:2"``; the empty spec gives ``None``.
    """
    spec = str(spec).strip()
    if not spec:
        return None
    sizes = {'batch': None, 'pixel': 1}
    if spec.isdigit():
        sizes['batch'] = int(spec)
    else:
        for part in spec.split(','):
            axis, _, n = part.partition(':')
            axis = axis.strip()
            if axis not in sizes or not n.strip().isdigit():
                raise ValueError(f'invalid mesh spec {spec!r} '
                                 f"(expected e.g. '8', 'batch:4', "
                                 f"'batch:4,pixel:2')")
            sizes[axis] = int(n)
    return make_mesh(n_batch=sizes['batch'], n_pixel=sizes['pixel'])


_APPLIED_SPEC = None


def apply_env_mesh(out=None):
    """Installs the pipeline mesh requested via ``SUPERDSM_TPU_MESH`` (no-op
    when unset). Returns the mesh, or ``None``.

    Called by the batch CLI per task, after the task's ``environ`` block is
    applied (so task.json can set it); idempotent for one spec.
    """
    global _APPLIED_SPEC
    spec = os.environ.get('SUPERDSM_TPU_MESH')
    if not spec:
        return None
    from ..dsm.batching import set_pipeline_mesh, get_pipeline_mesh
    from ..output import get_output
    if spec == _APPLIED_SPEC:
        return get_pipeline_mesh()  # already installed (idempotent per task/thread)
    mesh = parse_mesh_spec(spec)
    _APPLIED_SPEC = spec
    set_pipeline_mesh(mesh)
    get_output(out).write(f'Pipeline mesh: {mesh.shape} over {mesh.size} devices')
    return mesh
