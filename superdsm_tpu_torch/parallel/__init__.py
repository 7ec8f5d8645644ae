"""Parallel execution on the card.

Port of :mod:`superdsm_tpu.parallel`, as far as one GPU goes: the
host/device-overlapped image stream (:func:`process_images_pipelined`), with
every worker thread on a CUDA stream of its own (:func:`worker_stream`).
The JAX package's device meshes, sharded Newton solves and mosaics
(``mesh.py``, ``newton.py``, ``mosaic.py``) belong to the multi-GPU slice
of the port and are not ported yet.
"""

from .pipelined import process_images_pipelined, worker_stream  # noqa: F401
