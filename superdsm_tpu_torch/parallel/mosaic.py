"""Tiled processing of large stitched mosaics.

Port of :mod:`superdsm_tpu.parallel.mosaic`. The mosaic is split into
overlapping tiles, each tile runs the standard pipeline, and objects are
kept iff their centroid falls into the tile's core region — a halo of
``halo`` pixels guarantees every object is seen whole by the tile that owns
its centroid, so the union over tiles is exact for objects with diameter
< ``halo``.

Tiles are independent: over several devices each host thread pins its
solves to one device (:func:`~superdsm_tpu_torch.dsm.batching.device_scope`);
with more threads than devices, each thread also runs on a CUDA stream of
its own (:func:`~superdsm_tpu_torch.parallel.pipelined.worker_stream`), so
one tile's host phases overlap another's device phases on the same card.
"""

import contextlib
import threading

import numpy as np
import torch

from .._device import check_present, get_device
from ..config import Config
from ..output import get_output
from ..objects import BaseObject


class MosaicObject(BaseObject):
    """A postprocessed object translated into mosaic coordinates."""

    def __init__(self, original, offset):
        self.original = original
        self.fg_fragment = original.fg_fragment
        self.fg_offset = np.asarray(original.fg_offset) + np.asarray(offset)


def _tile_grid(shape, tile, halo):
    """Yields ``(core_slice, padded_slice)`` pairs covering ``shape``."""
    H, W = shape
    th, tw = tile
    for r0 in range(0, H, th):
        for c0 in range(0, W, tw):
            r1, c1 = min(r0 + th, H), min(c0 + tw, W)
            pr0, pc0 = max(0, r0 - halo), max(0, c0 - halo)
            pr1, pc1 = min(H, r1 + halo), min(W, c1 + halo)
            yield (np.s_[r0:r1, c0:c1], np.s_[pr0:pr1, pc0:pc1])


def _check_halo(obj, pad_off, pad_sel, mosaic_shape, halo):
    """Classifies a KEPT object's truncation risk — exactness of the
    centroid-ownership rule requires object diameter < ``halo``, and a
    silent violation truncates the object's mask.

    Returns ``(risk, extent, position)`` where ``risk`` is ``'clipped'``
    (the mask hits its tile crop), ``'near'`` (extent >= 0.8 * halo), or
    ``None``. The caller aggregates to ONE warning per tile: a dense mosaic
    of large objects can put every object over the 0.8 threshold, and a
    warning per object (coordinates in the message defeat the warnings
    dedup filter) floods the output."""
    frag_shape = np.asarray(obj.fg_fragment.shape)
    lo = np.asarray(obj.fg_offset)          # tile-local
    hi = lo + frag_shape
    pad_shape = np.array([pad_sel[0].stop - pad_sel[0].start,
                          pad_sel[1].stop - pad_sel[1].start])
    # a tile edge that coincides with the mosaic edge cannot truncate
    at_mosaic_lo = pad_off == 0
    at_mosaic_hi = pad_off + pad_shape == np.asarray(mosaic_shape)
    touches = ((lo == 0) & ~at_mosaic_lo).any() or \
              ((hi == pad_shape) & ~at_mosaic_hi).any()
    extent = int(frag_shape.max())
    if touches:
        return 'clipped', extent, tuple(pad_off + lo)
    if extent >= 0.8 * halo:
        return 'near', extent, tuple(pad_off + lo)
    return None, extent, tuple(pad_off + lo)


def _warn_halo(risks, halo, out):
    """One aggregated halo warning per tile (see :func:`_check_halo`)."""
    flagged = [r for r in risks if r[0] is not None]
    if not flagged:
        return
    import warnings
    clipped = [r for r in flagged if r[0] == 'clipped']
    worst = max(flagged, key=lambda r: (r[0] == 'clipped', r[1]))
    reason = (f'{len(clipped)} object(s) clipped by their tile crop'
              if clipped else
              f'{len(flagged)} object(s) with extent >= 0.8 * halo '
              f'({halo}px)')
    message = (f'mosaic tile: {reason}; worst at {worst[2]} with extent '
               f'{worst[1]}px — increase halo beyond the largest object '
               f'diameter')
    warnings.warn(message, RuntimeWarning)
    out.write(f'WARNING: {message}')


def process_mosaic(pipeline, cfg, g_raw, tile=(1024, 1024), halo=160, out=None,
                   devices=None, threads_per_device=1):
    """Segments a large mosaic tile by tile.

    With more than one device, tiles are distributed over host threads,
    each pinning its solves to one device via
    :func:`~superdsm_tpu_torch.dsm.batching.device_scope` — independent
    tiles run concurrently across cards.

    ``threads_per_device`` > 1 additionally overlaps one tile's host phases
    (watersheds, combinatorics, packing) with another tile's device phases on
    the SAME card, each thread on its own CUDA stream — the host/device
    pipelining of
    :func:`~superdsm_tpu_torch.parallel.pipelined.process_images_pipelined`
    applied to tiles. As there, split-tree speculation is disabled while
    overlapping unless the caller pinned ``c2f-region-analysis/speculate``.

    :param pipeline: A :class:`~superdsm_tpu_torch.pipeline.Pipeline`, or a
        factory returning one (a factory gives each worker thread its own
        pipeline).
    :param cfg: Hyperparameters (applied per tile; set ``AF_scale`` to skip
        per-tile scale estimation and keep tiles consistent).
    :param g_raw: The mosaic image.
    :param tile: Core tile shape.
    :param halo: Overlap margin; must exceed the largest object diameter.
    :param devices: Devices to spread the tiles over; ``None`` is the
        selected device (:func:`superdsm_tpu_torch.set_device`). A device
        that is not present raises.
    :return: ``(objects, tiles_processed)`` — :class:`MosaicObject` list in
        mosaic coordinates, in tile order.
    """
    from ..automation import process_image
    from ..dsm.batching import device_scope, thread_device_assigner
    from .pipelined import worker_stream

    out = get_output(out)
    g_raw = np.asarray(g_raw)
    tiles = list(_tile_grid(g_raw.shape, tile, halo))
    devices = [get_device()] if devices is None else \
        [check_present(torch.device(d)) for d in devices]
    n_workers = max(1, min(max(1, threads_per_device) * len(devices),
                           len(tiles)))
    overlapping = n_workers > len(devices)
    make_pipeline = pipeline if callable(pipeline) else (lambda: pipeline)

    done = [0]
    done_lock = threading.Lock()
    _thread_device = thread_device_assigner(devices)

    def run_tile(args):
        tile_idx, core_sel, pad_sel = args
        tile_img = g_raw[pad_sel]
        tile_cfg = cfg.copy() if isinstance(cfg, Config) else Config(cfg)
        if overlapping:
            tile_cfg.set_default('c2f-region-analysis/speculate', False)
        stream = worker_stream() if overlapping else contextlib.nullcontext()
        with device_scope(_thread_device()), stream:
            data, _, _ = process_image(make_pipeline(), tile_cfg, tile_img,
                                       out=out.derive(muted=True))
        pad_off = np.array([pad_sel[0].start, pad_sel[1].start])
        tile_objects = []
        halo_risks = []
        for obj in data['postprocessed_objects']:
            center = pad_off + np.asarray(obj.fg_offset) + \
                np.array(obj.fg_fragment.shape) / 2.0
            if (core_sel[0].start <= center[0] < core_sel[0].stop and
                    core_sel[1].start <= center[1] < core_sel[1].stop):
                tile_objects.append(MosaicObject(obj, pad_off))
                halo_risks.append(
                    _check_halo(obj, pad_off, pad_sel, g_raw.shape, halo))
        _warn_halo(halo_risks, halo, out)
        with done_lock:
            done[0] += 1
            count = done[0]
        out.intermediate(f'Mosaic tiles: {count} / {len(tiles)}...')
        return tile_idx, tile_objects

    jobs = [(i, core, pad) for i, (core, pad) in enumerate(tiles)]
    if n_workers == 1:
        results = [run_tile(j) for j in jobs]
    else:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            results = list(pool.map(run_tile, jobs))

    objects = []
    for _, tile_objects in sorted(results, key=lambda r: r[0]):
        objects.extend(tile_objects)
    out.write(f'Mosaic: {len(objects)} objects from {len(tiles)} tiles '
              f'({n_workers} workers)')
    return objects, len(tiles)


def rasterize_mosaic_labels(shape, objects):
    """Label map of mosaic objects (later objects win on rare overlaps).

    Writes only each object's masked pixels — ``fill_foreground`` assigns
    the whole bounding box (zeroing the fragment's complement), which would
    erase earlier neighbors whose masks fall inside a later object's bbox."""
    result = np.zeros(shape, np.int32)
    for label, obj in enumerate(objects, 1):
        off, frag = obj.fg_offset, obj.fg_fragment
        view = result[off[0]: off[0] + frag.shape[0],
                      off[1]: off[1] + frag.shape[1]]
        view[frag] = label
    return result
