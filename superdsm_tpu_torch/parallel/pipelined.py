"""Host/device-overlapped processing of image streams.

Port of :mod:`superdsm_tpu.parallel.pipelined`. A single image alternates
between host phases (watersheds, combinatorics, packing) and device phases
(batched solves); each leaves the other side idle. Processing a stream with
a small thread pool overlaps image i's host work with image j's device work
— numpy/scipy release the GIL in their hot loops and PyTorch releases it
while it waits for the card. Each thread uses its own pipeline instance
(stage callbacks and per-image caches are not shared).

On the card every worker thread runs its images on a CUDA stream of its own
(:func:`worker_stream`): threads that all issued to the default stream
would serialize there and the overlap would be lost. Over several devices
each worker thread also pins its solves to one of them
(:func:`~superdsm_tpu_torch.dsm.batching.device_scope`). Those streams do not
synchronize with the default stream, so nothing a worker launches may be
read from another stream; the solve seam copies its results on the
worker's stream (:func:`superdsm_tpu_torch.dsm.batching._fetch_with_deadline`).
"""

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .._device import check_present, get_device
from ..output import get_output

_LOCAL = threading.local()


@contextlib.contextmanager
def worker_stream():
    """Runs the enclosed block on this thread's own CUDA stream of the
    selected device (the thread's device scope, if any), created on the
    thread's first call for that device, when it is CUDA; a no-op on the
    CPU. Yields the stream (or None)."""
    device = get_device()
    if device.type != 'cuda':
        yield None
        return
    streams = getattr(_LOCAL, 'streams', None)
    if streams is None:
        streams = _LOCAL.streams = {}
    key = torch.cuda._get_device_index(device, optional=True)
    stream = streams.get(key)
    if stream is None:
        stream = streams[key] = torch.cuda.Stream(device=key)
    with torch.cuda.stream(stream):
        yield stream


def process_images_pipelined(pipeline_factory, base_cfg, images, threads=2,
                             process_image=None, out=None, devices=None):
    """Segments a list of images with host/device overlap.

    :param pipeline_factory: Zero-arg callable creating a fresh pipeline per
        worker thread.
    :param base_cfg: Hyperparameters (copied per image).
    :param images: Iterable of raw images.
    :param threads: Worker threads (2-3 per device is enough; more adds GIL
        contention).
    :param process_image: Override for the per-image entry point; defaults to
        :func:`superdsm_tpu_torch.automation.process_image`.
    :param devices: Optional list of devices; worker threads round-robin
        over them (:class:`~superdsm_tpu_torch.dsm.batching.
        thread_device_assigner`), each pinning its solves to its device.
        ``None`` is the selected device. A device that is not present
        raises.
    :return: List of pipeline ``data`` dicts, aligned with ``images``.
    """
    from ..automation import process_image as _process_image
    from ..dsm.batching import device_scope, thread_device_assigner
    if devices is None:
        get_device()  # raises when the selected device is absent
        devices = [None]  # no scope: the selected device
    else:
        devices = [check_present(torch.device(d)) for d in devices]
    assign = thread_device_assigner(devices)
    run_one = process_image or _process_image
    out = get_output(out)
    images = list(images)
    local = threading.local()

    def worker(args):
        idx, img = args
        if not hasattr(local, 'pipeline'):
            local.pipeline = pipeline_factory()
        cfg = base_cfg.copy()
        # split-tree speculation wins latency by spending extra device
        # compute; with several images overlapping the device is already
        # busy, so it is off unless the caller pinned it
        cfg.set_default('c2f-region-analysis/speculate', False)
        with device_scope(assign()), worker_stream():
            data, _, _ = run_one(local.pipeline, cfg, img,
                                 out=out.derive(muted=True))
        return idx, data

    results = [None] * len(images)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        for idx, data in pool.map(worker, enumerate(images)):
            results[idx] = data
            out.intermediate(f'Processed {idx + 1} / {len(images)} images')
    return results
