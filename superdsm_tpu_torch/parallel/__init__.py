"""Parallel execution: device meshes, sharded solves, streams and mosaics.

Port of :mod:`superdsm_tpu.parallel` on torch devices:

- **batch axis** — independent convex programs (candidate objects) are
  split across devices (:func:`set_pipeline_mesh`,
  :func:`make_sharded_poly_solver`, :func:`make_sharded_dsm_solver`);
- **pixel axis** — very large regions shard their pixels; per-shard
  gradient and Hessian contributions are summed on the row's first device
  and the Newton update is copied back to every shard
  (:mod:`~superdsm_tpu_torch.parallel.newton`);
- the host/device-overlapped image stream
  (:func:`process_images_pipelined`) and tiled mosaics
  (:func:`process_mosaic`), with every worker thread on a CUDA stream of its
  own (:func:`worker_stream`) and pinned to one device by
  :func:`device_scope`.
"""

from .mesh import Mesh, make_mesh, default_mesh, parse_mesh_spec, apply_env_mesh  # noqa: F401
from .newton import make_sharded_poly_solver, make_sharded_dsm_solver  # noqa: F401
from .pipelined import process_images_pipelined, worker_stream  # noqa: F401
from .mosaic import process_mosaic, rasterize_mosaic_labels, MosaicObject  # noqa: F401
from ..dsm.batching import (set_pipeline_mesh, get_pipeline_mesh,  # noqa: F401
                            device_scope, thread_device_assigner)
