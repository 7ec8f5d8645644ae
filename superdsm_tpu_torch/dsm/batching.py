"""Padded, bucketed batching of per-region convex solves.

Port of :mod:`superdsm_tpu.dsm.batching`: candidate regions of arbitrary
size are packed into batches of fixed shapes (pixel counts and deformation
dimensions padded to bucket sizes, the batch padded with dummy problems), and
every bucket group runs the batched Newton solver of
:mod:`superdsm_tpu_torch.dsm.solver` on the selected device. Every group is
launched first; the results are copied to the host afterwards, under the
``cp_timeout`` deadline (:func:`_fetch_with_deadline`). Non-converged DSM
lanes are re-solved at a frozen canonical shape, so their energies do not
depend on the runtime bucket ladder or chunking.

Worker threads solve concurrently, each on its own CUDA stream
(:mod:`superdsm_tpu_torch.parallel.pipelined`): everything here runs on the
caller's current stream, the deadline's copy thread included.

Two mechanisms route solves to other devices, as in the JAX package: a
thread's :func:`device_scope` pins that thread's solves to one device, and
a pipeline mesh (:func:`set_pipeline_mesh`) splits every bucket chunk's
lanes over the mesh's batch axis. A scope takes precedence over the mesh.
"""

import contextlib
import math
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import get_device, on_cpu, scoped_device, thread_device
from .solver import (_pack_poly_group, _solve_poly_packed, _solve_poly_packed_mask,
                     _solve_dsm_packed, _solve_dsm_packed_mask, _count_transfer, _load_linalg,
                     solve_on_devices, unpack_fg, evaluate_foreground, DEFAULT_MAXITER,
                     DEFAULT_TOL, MASK_BITS_PER_PIXEL)
from .smooth import prepare_deformation, smooth_matrix_params
from . import gram
from .. import trace

#: Set SDSM_SOLVE_TELEMETRY=1 to print each round's and stage phase's
#: seconds to stderr from the span recorder's spans (read at import, which
#: turns the recorder on, keeping no span; the batch CLI's ``--debug`` sets
#: the attribute and the recorder together).
_TELEMETRY = os.environ.get('SDSM_SOLVE_TELEMETRY') == '1'
if _TELEMETRY:
    trace.enable(True, keep=False)

#: Cumulative device-path accounting of :func:`solve_problems`: the wall
#: time during which at least one solve round was in flight (the union of
#: the concurrent rounds' intervals, so threads that overlap are not counted
#: twice), the per-lane Newton iterations executed, the calls and the lanes
#: re-solved canonically. Snapshot with :func:`device_accounting`.
_DEVICE_ACCT = {'wall_s': 0.0, 'lane_iters': 0, 'calls': 0, 'canonical_lanes': 0}
_DEVICE_ACCT_LOCK = threading.Lock()
#: solve rounds in flight, and the start of the current busy interval
_IN_FLIGHT = {'rounds': 0, 'since': 0.0}


def device_accounting():
    """A snapshot (dict copy) of the cumulative device-path accounting; an
    interval still open counts up to now."""
    with _DEVICE_ACCT_LOCK:
        snap = dict(_DEVICE_ACCT)
        if _IN_FLIGHT['rounds']:
            snap['wall_s'] += time.perf_counter() - _IN_FLIGHT['since']
    return snap


def _round_started():
    with _DEVICE_ACCT_LOCK:
        if _IN_FLIGHT['rounds'] == 0:
            _IN_FLIGHT['since'] = time.perf_counter()
        _IN_FLIGHT['rounds'] += 1


def _round_ended():
    with _DEVICE_ACCT_LOCK:
        _IN_FLIGHT['rounds'] -= 1
        if _IN_FLIGHT['rounds'] == 0:
            _DEVICE_ACCT['wall_s'] += time.perf_counter() - _IN_FLIGHT['since']


def _account(lane_iters, canonical_lanes=0):
    """Adds the Newton iterations of solved chunks (the real lanes' rows of
    each) and the lanes re-solved canonically."""
    iters = sum(int(np.sum(it)) for it in lane_iters)
    with _DEVICE_ACCT_LOCK:
        _DEVICE_ACCT['lane_iters'] += iters
        _DEVICE_ACCT['canonical_lanes'] += canonical_lanes


#: Pixel-count buckets (every value a multiple of 2048, so the gram kernel's
#: row chunking and the 8-bit foreground packing divide every bucket).
P_BUCKETS = [2048, 6144, 8192, 12288, 16384, 24576, 32768, 131072, 524288,
             2097152]
# SDSM_DROP_BUCKETS (comma list) drops buckets from the ladder, as in the
# JAX package: the A/B knob that forces repacks; the frozen canonical
# ladders below stay as they are.
if os.environ.get('SDSM_DROP_BUCKETS'):
    _dropped = {int(x) for x in os.environ['SDSM_DROP_BUCKETS'].split(',')
                if x.strip()}
    P_BUCKETS = [b for b in P_BUCKETS if b not in _dropped]
#: Deformation-dimension buckets (6 + K = powers of two).
K_BUCKETS = [0, 26, 58, 122, 250, 506, 1018, 2042]

#: Canonical re-solve of non-converged DSM lanes: a truncated (LM-stalled,
#: near-separable) lane's energy is a trajectory snapshot that depends on
#: the batch shape; re-solving exactly those lanes in a FROZEN canonical
#: shape makes their energies a function of the problem alone.
#: ``SDSM_CANONICAL_RESOLVE=0`` turns it off (the JAX package's A/B knob).
#: A lane's result does not depend on the lanes beside it, so a flagged lane
#: whose chunk already had its canonical buckets and its start
#: (:func:`_batch_was_canonical`) keeps its batch result, which the re-solve
#: would give again bitwise.
_CANONICAL_RESOLVE = os.environ.get('SDSM_CANONICAL_RESOLVE', '1') == '1'
#: FROZEN: never derive these from the runtime P_BUCKETS/K_BUCKETS.
_CANONICAL_P_LADDER = (2048, 6144, 8192, 12288, 16384, 24576, 32768,
                       131072, 524288, 2097152)
_CANONICAL_K_LADDER = (26, 58, 122, 250, 506, 1018, 2042)
_CANONICAL_B = 1
#: Tags of the lanes the last solve_problems call flagged for the
#: canonical re-solve, re-solved or kept (test/debug aid).
_LAST_FLAGGED = []

#: Pixel count beyond which a region is solved on a uniform pixel subsample
#: (weights rescaled; see ``solve_problems``).
P_SUBSAMPLE_TARGET = 524288


def _k_limit(n_pixels):
    """Largest admissible deformation dimension by region pixel count: caps
    the (P, 6+K) feature matrix at ~1 GB."""
    for pb, kl in [(8192, 2042), (32768, 2042), (131072, 1018),
                   (524288, 506)]:
        if n_pixels <= pb:
            return kl
    return 122


#: Batch-size caps per pixel bucket. On the CPU padded batch compute is paid
#: for real, so the caps stay small. On CUDA the caps start from the JAX
#: package's TPU caps; they are not re-measured on the card yet.
B_CAP_GPU = {2048: 64, 6144: 64, 8192: 64, 12288: 32, 16384: 32, 24576: 16,
             32768: 16, 131072: 8, 524288: 2, 2097152: 1}
B_CAP_CPU = {2048: 8, 6144: 8, 8192: 8, 12288: 4, 16384: 4, 24576: 4,
             32768: 4, 131072: 2, 524288: 1, 2097152: 1}
#: 6-parameter (deformation-free) solves are launch-bound, not
#: compute-bound: larger caps so a c2f round fits in one call.
B_CAP_POLY_GPU = {2048: 64, 6144: 64, 8192: 64, 12288: 64, 16384: 64,
                  24576: 64, 32768: 64, 131072: 8, 524288: 2, 2097152: 1}


def _b_cap(pb, kind='dsm'):
    if on_cpu():
        return B_CAP_CPU[pb]
    return (B_CAP_POLY_GPU if kind == 'poly' else B_CAP_GPU)[pb]


# ---------------------------------------------------------------------------
# Multi-device routing. Two composable mechanisms (the JAX package's):
#  * a process-wide pipeline mesh: every bucket chunk's lanes are split over
#    the mesh 'batch' axis, each device solving its share
#    (solver.solve_on_devices) — candidate problems are independent;
#  * a per-thread device scope: a host thread (one mosaic tile per device,
#    say) pins its solves to one device, so independent tiles run
#    concurrently across cards.
# ---------------------------------------------------------------------------

_PIPELINE_MESH = None


def set_pipeline_mesh(mesh):
    """Splits the lanes of every subsequent :func:`solve_problems` chunk
    over ``mesh``'s 'batch' axis (``None`` restores single-device
    operation)."""
    global _PIPELINE_MESH
    if mesh is not None and 'batch' not in mesh.axis_names:
        raise ValueError("pipeline mesh needs a 'batch' axis")
    _PIPELINE_MESH = mesh


def get_pipeline_mesh():
    return _PIPELINE_MESH


def device_scope(device):
    """Context manager pinning this thread's solves to one device (None:
    no pin). A device that is not present raises on entry."""
    return contextlib.nullcontext() if device is None else thread_device(device)


class thread_device_assigner:
    """Round-robins ``devices`` onto EXECUTING THREADS (not job indices):
    thread pools pull jobs at different rates, so an index-based mapping can
    pin two in-flight jobs to the same card while another sits idle. Each
    thread gets a sticky device on its first call; combine with
    :func:`device_scope` to pin that thread's solves."""

    def __init__(self, devices):
        self.devices = list(devices)
        self._lock = threading.Lock()
        self._next = 0
        self._tls = threading.local()

    def __call__(self):
        dev = getattr(self._tls, 'device', None)
        if dev is None:
            with self._lock:
                dev = self.devices[self._next % len(self.devices)]
                self._next += 1
            self._tls.device = dev
        return dev


def _batch_devices():
    """The devices a chunk's lanes are split over: the pipeline mesh's
    batch-axis devices when its batch axis is larger than 1 and this thread
    has no device scope, else None (the selected device)."""
    mesh = _PIPELINE_MESH
    if mesh is None or scoped_device() is not None or mesh.shape['batch'] <= 1:
        return None
    return list(mesh.devices[:, 0])


def _bucket(value, buckets):
    for b in buckets:
        if value <= b:
            return b
    raise ValueError(f'value {value} exceeds largest bucket {buckets[-1]}')


def _batch_shape(n_problems, pb, kind='dsm'):
    """Padded batch size for ``n_problems`` problems of pixel bucket ``pb``:
    the smallest power of two >= n_problems, capped at the bucket's cap."""
    return _pow2_ceil(min(n_problems, _b_cap(pb, kind)))


def _pow2_ceil(m):
    """Smallest power of two >= m (keep :func:`_batch_shape` and
    :func:`_dsm_chunk_sizes` in lockstep)."""
    b = 1
    while b < m:
        b *= 2
    return b


#: Minimum per-row gram work (pixels x (6+K)^2 MACs per iteration) for
#: splitting a group's tail chunk to be worth an extra launch.
_SPLIT_MIN_WORK = 6e8


def _dsm_chunk_sizes(n, cap, pb, kb, on_cpu_=None, min_b=1):
    """Chunk sizes for an ``n``-problem ``(pb, kb)`` DSM group: full-cap
    chunks, then the remainder — split into the largest power of two below
    it plus the padded rest when the group is compute-bound and that saves
    material padding (lanes freeze individually, so batch composition never
    changes a problem's iterates). Never split on the CPU, which pins the
    CPU results to one chunking, nor under a pipeline mesh (``min_b > 1``:
    every chunk pads to the mesh batch anyway)."""
    sizes = []
    while n > cap:
        sizes.append(cap)
        n -= cap
    if n <= 0:
        return sizes
    padded = _pow2_ceil(n)
    if on_cpu_ is None:
        on_cpu_ = on_cpu()
    if (min_b == 1 and not on_cpu_ and pb * (6 + kb) ** 2 >= _SPLIT_MIN_WORK
            and padded > n):
        lo = padded // 2
        rest = n - lo
        saved = padded - (lo + _pow2_ceil(rest))
        if saved >= 4 and saved * 4 >= padded:
            sizes += [lo, rest]
            return sizes
    sizes.append(n)
    return sizes


@dataclass
class Problem:
    """One region-level convex program.

    :ivar pts: (P, 2) int16 crop-local pixel coordinates of the region mask.
    :ivar offset: (2,) crop offset within the full image.
    :ivar img_shape: full-image shape (coordinates are normalized by it).
    :ivar yv: (P,) offset image intensities at the pixels.
    :ivar sub: (K, 2) int32 subsample-point coordinates (empty = no
        deformations, the reference's NULL-matrix case).
    :ivar tag: caller-defined identifier.
    :ivar init_params: Optional (6 + K,) warm-start parameters aligned with
        ``sub``; problems with a warm start skip the elliptical
        initialization pass when their whole batch is warm.
    :ivar alpha_scale: multiplier on the deformation weight alpha (the
        pixel-subsampled solve of oversized regions).
    :ivar crop_shape: the crop (bounding box) shape of the region mask,
        the frame of the bit-packed mask transfer
        (``solver._mask_to_pix``); derived from the coordinates' extent
        when not given.
    """
    pts: np.ndarray
    offset: np.ndarray
    img_shape: tuple
    yv: np.ndarray
    sub: np.ndarray
    tag: object = None
    init_params: Optional[np.ndarray] = None
    alpha_scale: float = 1.0
    crop_shape: Optional[tuple] = None

    @property
    def n_pixels(self):
        return len(self.pts)

    def _crop_shape(self):
        if self.crop_shape is None:
            # make_problem crops to the mask's box, so the extent is the
            # crop; a looser hand-built crop only makes fits_mask stricter
            self.crop_shape = (int(self.pts[:, 0].max()) + 1,
                               int(self.pts[:, 1].max()) + 1)
        return self.crop_shape

    @property
    def crop_area(self):
        h, w = self._crop_shape()
        return h * w

    @property
    def packed_mask(self):
        """The region mask over the crop, row-major, bit-packed (cached):
        ``np.unpackbits`` of it at the crop width gives ``pts`` back
        (``solver._mask_to_pix`` is its inverse on the device)."""
        pm = getattr(self, '_packed_mask', None)
        if pm is None:
            h, w = self._crop_shape()
            m = np.zeros(h * w, bool)
            m[self.pts[:, 0].astype(np.int64) * w + self.pts[:, 1]] = True
            pm = np.packbits(m)
            self._packed_mask = pm
        return pm

    def fits_mask(self, pb):
        """Whether the bit-packed mask transfer carries this problem at pixel
        bucket ``pb``: the crop's bits within ``pb * MASK_BITS_PER_PIXEL``,
        and ``pts`` strictly increasing in row-major order inside the crop.
        The decode rebuilds the coordinates in that order while ``yv`` and
        ``init_params`` keep the given one, so unsorted or repeated points
        would pair pixels with other pixels' intensities; such problems go
        by coordinates (the same results, a larger transfer)."""
        if self.crop_area > pb * MASK_BITS_PER_PIXEL:
            return False
        ok = getattr(self, '_pts_rowmajor', None)
        if ok is None:
            h, w = self._crop_shape()
            r, c = self.pts[:, 0].astype(np.int64), self.pts[:, 1].astype(np.int64)
            lin = r * w + c
            ok = bool((len(lin) == 0)
                      or (np.all(lin[1:] > lin[:-1])
                          and r[0] >= 0 and c.min() >= 0
                          and r[-1] < h and c.max() < w))
            self._pts_rowmajor = ok
        return ok

    @property
    def n_deform(self):
        return len(self.sub)

    @property
    def yscale(self):
        """Per-problem quantization scale max|yv| (cached)."""
        s = getattr(self, '_yscale', None)
        if s is None:
            s = float(np.abs(self.yv).max()) if len(self.yv) else 1.0
            s = s if s > 0 else 1.0
            self._yscale = s
        return s

    @property
    def yq(self):
        """int16-quantized intensities (yv ~ yq * yscale / 32767; cached).
        Non-finite intensities quantize to 0; such a problem still ends in
        the fallback path through its non-finite energy."""
        q = getattr(self, '_yq', None)
        if q is None:
            with np.errstate(invalid='ignore'):
                scaled = np.nan_to_num(self.yv * (32767.0 / self.yscale),
                                       nan=0.0, posinf=32767.0, neginf=-32767.0)
            q = np.round(scaled).astype(np.int16)
            self._yq = q
        return q

    def norm_coords(self):
        denom = np.maximum(np.asarray(self.img_shape, np.float32) - 1.0, 1.0)
        return (self.pts.astype(np.float32) + np.asarray(self.offset)[None, :]) / denom[None, :]


@dataclass
class ProblemResult:
    """Solution of one :class:`Problem` (unpadded)."""
    params: np.ndarray            # (6 + K,)
    energy: float
    status: str                   # 'optimal' or 'fallback'
    surface: Optional[np.ndarray]  # (P,) surface values (packed path: None)
    fg: Optional[np.ndarray] = None  # (P,) bool foreground at the mask pixels
    tag: object = None


def make_problem(region, img_shape=None, smooth_amount=np.inf,
                 gaussian_shape_multiplier=2, smooth_subsample=20, tag=None):
    """Builds a :class:`Problem` from an :class:`~superdsm_tpu_torch.image.Image`
    region (full-frame or cropped; the mask selects the solve pixels), with
    the region semantics of the reference's ``Energy.__init__``
    (``superdsm/dsm.py:266-289``)."""
    from ..image import bbox as _bbox
    mask = region.mask
    if img_shape is None:
        img_shape = region.model.shape
    if not mask.any():
        raise ValueError('empty region mask')
    _, sel = _bbox(mask)
    mask_crop = mask[sel]
    pts = np.argwhere(mask_crop).astype(np.int16)
    offset = np.array([sel[0].start + (region.offset[0] if region.offset is not None else 0),
                       sel[1].start + (region.offset[1] if region.offset is not None else 0)],
                      np.int32)
    yv = region.model[sel][mask_crop].astype(np.float32)
    sub = prepare_deformation(mask_crop, smooth_amount, gaussian_shape_multiplier,
                              smooth_subsample)
    # adaptive stride guard: a huge region at the configured stride would
    # overflow the K buckets; widen the stride until the grid fits
    stride = smooth_subsample
    while len(sub) > _k_limit(len(pts)):
        stride = int(math.ceil(stride * 1.5))
        sub = prepare_deformation(mask_crop, smooth_amount,
                                  gaussian_shape_multiplier, stride)
    return Problem(pts=pts, offset=offset, img_shape=tuple(img_shape), yv=yv,
                   sub=sub, tag=tag, crop_shape=tuple(mask_crop.shape))


def _group_problems(problems, smooth_amount):
    """Buckets problems into ``poly_groups {pb: [index]}`` and
    ``dsm_groups {(pb, kb): [index]}``, coalescing small groups."""
    poly_groups = {}
    dsm_groups = {}
    for i, p in enumerate(problems):
        pb = _bucket(p.n_pixels, P_BUCKETS)
        if p.n_deform == 0 or not np.isfinite(smooth_amount):
            poly_groups.setdefault(pb, []).append(i)
        else:
            kb = _bucket(max(p.n_deform, 1), K_BUCKETS[1:])
            dsm_groups.setdefault((pb, kb), []).append(i)

    # coalesce small K groups into the next-larger K group of the same pixel
    # bucket (fewer launches for a few extra padded columns)
    for (pb, kb) in sorted(dsm_groups.keys()):
        group = dsm_groups.get((pb, kb))
        if group is None or len(group) > _b_cap(pb) // 4:
            continue
        larger = [kb2 for (pb2, kb2) in dsm_groups if pb2 == pb and kb2 > kb]
        if larger:
            dsm_groups[(pb, min(larger))].extend(dsm_groups.pop((pb, kb)))

    # merge tiny leftover DSM groups into a larger (P, K) group
    for (pb, kb) in sorted(dsm_groups.keys()):
        group = dsm_groups.get((pb, kb))
        if group is None or len(group) > 2:
            continue
        targets = [(pb2, kb2) for (pb2, kb2) in dsm_groups
                   if (pb2, kb2) != (pb, kb) and pb2 >= pb and kb2 >= kb]
        if targets:
            dsm_groups[min(targets)].extend(dsm_groups.pop((pb, kb)))

    # 6-parameter solves are launch-bound on accelerators: pad a
    # multi-bucket round up to ONE shared pixel bucket (<= 32768)
    if not on_cpu() and len(poly_groups) > 1:
        eligible = sorted(pb for pb in poly_groups if pb <= 32768)
        if len(eligible) > 1:
            target = eligible[-1]
            for pb in eligible[:-1]:
                poly_groups[target] = poly_groups.pop(pb) + \
                    poly_groups.get(target, [])
    return poly_groups, dsm_groups




def _to_host(tree):
    """The tensors of a nested list/tuple/dict as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    values = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


class SolveTimeout(Exception):
    """A solve round exceeded its wall-clock deadline (a wedged device)."""


def _fetch_with_deadline(sel, timeout):
    """The tensors of ``sel`` copied to the host, bounded by ``timeout``
    seconds.

    The copy runs on a daemon thread, so an expired deadline abandons it
    (:class:`SolveTimeout`); if the device later recovers, the orphaned
    result is dropped. ``timeout`` None or ``<= 0`` disables the deadline
    (the reference arms its SIGALRM only for a positive ``cp_timeout``).

    On CUDA the thread copies on the CALLER's current stream: a new thread
    starts on the default stream, which does not wait for the work of the
    caller's stream when that is a worker's non-blocking stream, so the
    copy would read the results before they are written.
    """
    if timeout is None or timeout <= 0:
        return _to_host(sel)
    first = _first_tensor(sel)
    stream = (torch.cuda.current_stream(first.device)
              if first is not None and first.device.type == 'cuda' else None)
    box = {}

    def _run():
        try:
            if stream is None:
                box['value'] = _to_host(sel)
            else:
                with torch.cuda.stream(stream):
                    box['value'] = _to_host(sel)
        except BaseException as error:  # device errors reach the caller
            box['error'] = error

    thread = threading.Thread(target=_run, daemon=True)
    thread.start()
    thread.join(timeout)
    if thread.is_alive():
        raise SolveTimeout(f'solve fetch exceeded {timeout:.0f}s deadline')
    if 'error' in box:
        raise box['error']
    return box['value']


def _host_energy_fg(p, params, alpha, epsilon, smooth_amount, cutoff):
    """Numpy evaluation of ψ and the foreground mask at ``params``.

    Used only on the wall-clock fallback path (the device cannot be copied
    from); mirrors the device energy minus the int16 intensity
    quantization, which is irrelevant for a fallback estimate."""
    coords = p.norm_coords()
    x1, x2 = coords[:, 0].astype(np.float64), coords[:, 1].astype(np.float64)
    Q = np.stack([x1 * x1, x2 * x2, 2 * x1 * x2, 2 * x1, 2 * x2,
                  np.ones_like(x1)], axis=-1)
    params = np.zeros(6 + p.n_deform) if params is None else np.asarray(params, np.float64)
    s = Q @ params[:6]
    reg = 0.0
    k = p.n_deform
    if k and np.isfinite(smooth_amount) and len(params) >= 6 + k:
        xi = params[6:6 + k]
        # chunked over pixels: the dense (P, K) kernel block of an oversized
        # region would not fit host memory in one piece
        for lo in range(0, len(p.pts), 65536):
            hi = lo + 65536
            dr = p.pts[lo:hi, None, 0].astype(np.float64) - p.sub[None, :, 0]
            dc = p.pts[lo:hi, None, 1].astype(np.float64) - p.sub[None, :, 1]
            G = np.exp(-(dr * dr + dc * dc) / (2.0 * smooth_amount ** 2))
            G[(np.abs(dr) > cutoff) | (np.abs(dc) > cutoff)] = 0.0
            G /= np.maximum(G.sum(axis=1, keepdims=True), 1e-30)
            s[lo:hi] += G @ xi
        reg = alpha * p.alpha_scale * float(
            np.sum(np.sqrt(xi * xi + epsilon) - np.sqrt(epsilon)))
    data = float(np.sum(np.logaddexp(0.0, -p.yv.astype(np.float64) * s)))
    return data + max(reg, 0.0), s > 0


def _host_lsq_init(p, margin=2.0, ridge=1e-6):
    """Numpy mirror of ``solver._lsq_init`` for one problem: ridge
    regression of the polynomial surface onto ``margin * sign(y)``."""
    coords = p.norm_coords().astype(np.float64)
    x1, x2 = coords[:, 0], coords[:, 1]
    Q = np.stack([x1 * x1, x2 * x2, 2 * x1 * x2, 2 * x1, 2 * x2,
                  np.ones_like(x1)], axis=-1)
    z = margin * np.sign(p.yv.astype(np.float64))
    A = Q.T @ Q
    A = A + ridge * np.trace(A) * np.eye(6)
    theta = np.linalg.solve(A, Q.T @ z)
    return np.where(np.isfinite(theta), theta, 0.0).astype(np.float32)


def _fallback_results_after_timeout(problems, oversized, alpha, epsilon,
                                    smooth_amount, cutoff, fetch):
    """'fallback' :class:`ProblemResult` rows from the initializations after
    a :class:`SolveTimeout` — the host-side analog of the reference's
    SIGALRM fall-back-to-initialization path (``superdsm/dsm.py:478-490``,
    ``objects.py:394-411``)."""
    results = []
    for i, p in enumerate(problems):
        factor, orig = oversized.get(i, (1.0, p))
        eval_p = orig if fetch != 'energy' else p
        params = p.init_params
        if params is None:
            # cold problems have no warm start: the device solve would have
            # started from the closed-form LSQ ellipse (zeros would mean an
            # empty foreground)
            params = np.zeros(6 + p.n_deform, np.float32)
            params[:6] = _host_lsq_init(p)
        energy, fg = _host_energy_fg(eval_p, params, alpha, epsilon,
                                     smooth_amount, cutoff)
        if i in oversized and fetch == 'energy':
            energy *= factor
        results.append(ProblemResult(
            params=None if fetch == 'energy' else np.asarray(params, np.float32),
            energy=float(energy), status='fallback', surface=None,
            fg=None if fetch == 'energy' else fg, tag=p.tag))
    return results


#: (kind, P, K, B, statics...) solve shapes that have completed a round in
#: this process. A round holding any other shape may pay one-time costs
#: (kernel library build and load, cuBLAS/cuSOLVER and allocator warm-up)
#: that a deadline cannot tell from a wedge, so ``timeout`` arms only on
#: rounds whose every shape has run once.
_WARM_SHAPES = set()
_WARM_LOCK = threading.Lock()


def _all_warm(shapes):
    with _WARM_LOCK:
        return all(s in _WARM_SHAPES for s in shapes)


def _mark_warm(shapes):
    with _WARM_LOCK:
        _WARM_SHAPES.update(shapes)


def _warmup_shapes(include_large=False):
    """The shipped shape list (``warmup_shapes.json``: the solve shapes of
    bench-like fields) and, with ``include_large``, the large buckets a
    1024x1344 microscopy frame takes (``warmup_shapes_large.json``): the
    JAX package's lists. Entries are ``(kind, P, K, B)`` with the statics
    ``(tol,)`` of a poly solve or ``(tol, sigma, cutoff)`` of a DSM one."""
    import json
    here = os.path.dirname(__file__)
    names = ['warmup_shapes.json'] + (['warmup_shapes_large.json'] if include_large else [])
    shapes = set()
    for name in names:
        with open(os.path.join(here, name)) as fp:
            shapes |= {tuple(e) for e in json.load(fp)}
    return shapes


def _warmup_job(kind, pb, kb, Bp, maxiter, tol, sigma, cutoff):
    """``(solve, args)`` of one warmup shape on dummy inputs: ``kind``
    ``poly``/``dsm`` take int16 coordinate pairs, ``poly-m``/``dsm-m`` the
    bit-packed crop masks (the format the card takes for every problem
    whose crop fits)."""
    rng = np.random.RandomState(0)
    OFF = np.zeros((Bp, 2), np.int32)
    CNT = np.full(Bp, pb, np.int32)
    YQ = rng.randint(-32767, 32767, (Bp, pb)).astype(np.int16)
    YS = np.ones(Bp, np.float32)
    denom = np.array([63.0, 63.0], np.float32)
    if kind.endswith('-m'):
        nbits = pb * MASK_BITS_PER_PIXEL
        bits = np.zeros((Bp, nbits), np.uint8)
        bits[:, rng.choice(nbits, pb, replace=False)] = 1
        head = (np.packbits(bits, axis=1), np.full(Bp, 64, np.int32))
    else:
        head = (rng.randint(0, 50, (Bp, pb, 2)).astype(np.int16),)
    if kind.startswith('poly'):
        fn = _solve_poly_packed_mask if kind.endswith('-m') else _solve_poly_packed
        return fn, (*head, OFF, CNT, YQ, YS, denom, np.zeros((Bp, 6), np.float32),
                    int(maxiter), float(tol))
    fn = _DSM_SOLVES[kind]
    return fn, (*head, OFF, CNT, YQ, YS, denom,
                rng.randint(0, 50, (Bp, kb, 2)).astype(np.int16),
                np.ones((Bp, kb), np.float32), np.zeros((Bp, 6 + kb), np.float32),
                np.zeros(Bp, bool), np.full(Bp, 0.1, np.float32), 1.0,
                int(maxiter), float(tol), float(sigma), int(cutoff))


def warmup(shapes=None, maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL, sigma=4.0,
           cutoff=16, threads=8, compile_only=False, include_large=False):
    """Pays the solver's first-use costs before the first image: ``shapes``
    is an iterable of ``(kind, P, K, B)`` tuples, optionally followed by
    their statics (``tol``; DSM kinds ``tol, sigma, cutoff``), by default
    the shipped list (:func:`_warmup_shapes`). A 4-tuple takes this call's
    ``tol``, ``sigma`` and ``cutoff``, as in the JAX package.

    Two phases, timed apart. The compile phase builds every CUDA library
    the solver calls (the gram, the bf16 gram and the lane kernels; one
    ``nvcc`` each, together, where a library is missing or older than its
    source), loads them and makes the process's first CUDA linear-algebra
    call (``solver._load_linalg``); on the CPU it has nothing to do. The
    load phase (skipped with ``compile_only``) runs each shape's packed
    solve once at ``maxiter=1`` on dummy inputs, ``threads`` at a time,
    each worker thread on its own stream (``parallel.worker_stream``):
    CUDA library handles, the caching allocator's pools, a graph capture
    and the first launch of each kernel. A CUDA program has no trace to
    specialise, so ``maxiter`` does not change what is warmed; it is kept
    for the JAX package's signature. A shape that ran arms the solve
    deadline for its rounds (``_WARM_SHAPES``).

    :return: the JAX package's keys ``{'wall_s', 'compile_s', 'load_s',
        'n_programs', 'compile_thread_s', 'aot_deserialize_thread_s'}``:
        ``compile_thread_s`` is the ``nvcc`` build's seconds (0.0 when
        every library was up to date), ``aot_deserialize_thread_s`` is
        always 0.0 (the port keeps no ahead-of-time sidecars).
    """
    from concurrent.futures import ThreadPoolExecutor
    from ..parallel.pipelined import worker_stream
    if shapes is None:
        shapes = _warmup_shapes(include_large=include_large)

    def _normalize(shape):
        shape = tuple(shape)
        if len(shape) > 4:
            return shape
        return shape + ((float(tol),) if shape[0].startswith('poly')
                        else (float(tol), float(sigma), int(cutoff)))

    shapes = sorted({_normalize(s) for s in shapes})
    device = get_device()
    t_start = time.perf_counter()
    build_s = 0.0
    if device.type == 'cuda':
        if any(gram.stale(src) for src in gram._KERNELS):
            build_s = gram.build()
        for src in gram._KERNELS:
            gram._load(src)
        _load_linalg(device)
    t_compiled = time.perf_counter()

    def run_one(shape):
        kind, pb, kb, Bp = shape[:4]
        statics = shape[4:] if kind.startswith('dsm') else shape[4:] + (sigma, cutoff)
        fn, args = _warmup_job(kind, pb, kb, Bp, 1, *statics)
        with thread_device(device), worker_stream():
            _to_host(fn(*args)[1][:1])  # waits for the solve
        _mark_warm([shape])

    if not compile_only and shapes:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(pool.map(run_one, shapes))
    t_done = time.perf_counter()
    return {'wall_s': t_done - t_start,
            'compile_s': t_compiled - t_start,
            'load_s': 0.0 if compile_only else t_done - t_compiled,
            'aot_deserialize_thread_s': 0.0,
            'compile_thread_s': build_s,
            'n_programs': len(shapes)}


#: The packed DSM solve of each transfer kind, and the position of its
#: USE_WARM argument.
_DSM_SOLVES = {'dsm': _solve_dsm_packed, 'dsm-m': _solve_dsm_packed_mask}
_USE_WARM_AT = {'dsm': 9, 'dsm-m': 10}

#: output layouts: poly (params, f, conv, bad, fg, it_lane);
#:                 dsm (params, f, f_ell, conv, bad, fg, it_lane)
_IDX = {'poly': dict(params=0, f=1, conv=2, bad=3, fg=4, it=5),
        'dsm': dict(params=0, f=1, conv=3, bad=4, fg=5, it=6)}


def _selection(kind, outs, fetch):
    """The outputs of one chunk (of either transfer format) the host
    needs."""
    ix = _IDX[kind.split('-')[0]]
    keys = ('f', 'bad', 'conv', 'it') if fetch == 'energy' else \
        ('f', 'bad', 'conv', 'it', 'fg', 'params')
    return {k: outs[ix[k]] for k in keys}


def solve_problems(problems, alpha=0.5, epsilon=1.0, smooth_amount=10,
                   gaussian_shape_multiplier=2, init='elliptical',
                   maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL, out=None,
                   progress_line='Computing objects', fetch='full',
                   timeout=None):
    """Solves a list of :class:`Problem` in padded, bucketed batches.

    Problems without deformation dimensions run the packed 6-parameter
    solve; all others run ONE packed solve per (P, K) bucket chunk that
    performs the elliptical initialization and the full DSM solve, starting
    from the better of the elliptical solution and the optional warm start
    (cf. ``cvxprog``, reference ``superdsm/objects.py:361-412``).

    :param fetch: ``'full'`` copies parameters and foreground masks to the
        host; ``'energy'`` only energies and fallback flags.
    :param timeout: wall-clock deadline (seconds) for copying a round's
        results to the host; on expiry every problem of the round falls
        back to its initialization with status ``'fallback'`` and processing
        continues (the batched analog of the reference's per-solve SIGALRM
        ``cp_timeout``). None or ``<= 0`` disables it; it arms only when
        every solve shape of the round has completed once in this process
        (``_WARM_SHAPES``).
    :return: list of :class:`ProblemResult`, aligned with ``problems``.
    """
    if len(problems) == 0:
        return []
    _round_started()
    try:
        with trace.span('sdsm.solve', problems=len(problems)) as whole:
            return _solve_problems(problems, alpha, epsilon, smooth_amount,
                                   gaussian_shape_multiplier, maxiter, tol, out,
                                   progress_line, fetch, timeout, whole)
    finally:
        _round_ended()


def _solve_problems(problems, alpha, epsilon, smooth_amount,
                    gaussian_shape_multiplier, maxiter, tol, out,
                    progress_line, fetch, timeout, whole):
    results = [None] * len(problems)
    _, cutoff = smooth_matrix_params(smooth_amount, gaussian_shape_multiplier)
    img_shape = problems[0].img_shape
    # coordinates are normalized by ONE image shape per call
    if not all(p.img_shape == img_shape for p in problems):
        raise ValueError('solve_problems requires a uniform img_shape per call')
    denom = np.maximum(np.asarray(img_shape, np.float32) - 1.0, 1.0)

    # Regions beyond the largest pixel bucket are solved on a uniform pixel
    # subsample: scaling the data term by 1/factor equals scaling alpha by
    # 1/factor, so the minimizer tracks the full-region optimum and
    # ``factor * energy`` estimates the full-region energy. The foreground
    # is re-evaluated at every mask pixel from the fitted surface.
    problems = list(problems)
    oversized = {}
    for i, p in enumerate(problems):
        if p.n_pixels > P_BUCKETS[-1]:
            step = int(math.ceil(p.n_pixels / P_SUBSAMPLE_TARGET))
            pts_sub = np.ascontiguousarray(p.pts[::step])
            factor = p.n_pixels / float(len(pts_sub))
            problems[i] = Problem(
                pts=pts_sub, offset=p.offset, img_shape=p.img_shape,
                yv=np.ascontiguousarray(p.yv[::step]), sub=p.sub, tag=p.tag,
                init_params=p.init_params, alpha_scale=1.0 / factor)
            oversized[i] = (factor, p)

    poly_groups, dsm_groups = _group_problems(problems, smooth_amount)
    statics = (float(tol), float(smooth_amount), int(cutoff))
    # a pipeline mesh splits each chunk's lanes over its batch axis, and
    # every chunk pads to at least one lane per device
    devices = _batch_devices()
    min_b = 1 if devices is None else len(devices)

    # The transfer format, as the JAX package routes it: on the card the
    # problems whose crop fits the bit-packed mask (nearly all) go as masks
    # (0.5 bytes a pixel against 4 for int16 coordinate pairs), the rest by
    # coordinates; on the CPU by coordinates. The decoded coordinates are
    # the same, so the results are bitwise unchanged. SDSM_MASK_TRANSFERS=0
    # forces coordinates everywhere, =1 masks on the CPU too.
    mask_env = os.environ.get('SDSM_MASK_TRANSFERS')
    mask_capable = mask_env == '1' if mask_env is not None else not on_cpu()

    def _fitting(chunk, pb, use_mask):
        return len(chunk) if use_mask else sum(problems[i].fits_mask(pb) for i in chunk)

    def _variants(idxs, pb):
        if not mask_capable:
            return ((idxs, False),) if idxs else ()
        fit = [i for i in idxs if problems[i].fits_mask(pb)]
        nofit = [i for i in idxs if not problems[i].fits_mask(pb)]
        return tuple((lst, um) for lst, um in ((fit, True), (nofit, False)) if lst)

    # launch every bucket group, then copy all results to the host
    pending = []  # (kind, chunk, shape, device outputs)
    for pb, idxs in sorted(poly_groups.items()):
        bmax = _b_cap(pb, 'poly')
        for vidxs, use_mask in _variants(idxs, pb):
            kind = 'poly-m' if use_mask else 'poly'
            for chunk_start in range(0, len(vidxs), bmax):
                chunk = vidxs[chunk_start: chunk_start + bmax]
                Bp = max(_batch_shape(len(chunk), pb, 'poly'), min_b)
                inits = [problems[i].init_params for i in chunk]
                outs = _pack_poly_group([problems[i] for i in chunk], img_shape,
                                        params0=inits, maxiter=maxiter, tol=tol,
                                        pb=pb, Bp=Bp, devices=devices, use_mask=use_mask)
                _count_transfer(kind, problems=len(chunk), fitting=_fitting(chunk, pb, use_mask))
                pending.append((kind, chunk, (kind, pb, 0, Bp, float(tol)), outs))

    def _dsm_chunk_arrays(chunk, pb, kb, Bp, use_mask, warm_tail_all):
        """Packs one dsm chunk (ONE construction for the production solve
        and the canonical re-solve) in the transfer format ``use_mask``
        selects.

        ``warm_tail_all`` sets only the padding rows' USE_WARM: True gives
        them the all-of-real value (production: an all-warm chunk keeps
        the elliptical skip), False leaves them cold (the canonical
        re-solve). It does not make the better-of(elliptical, warm) init
        run: at ``_CANONICAL_B = 1`` a canonical chunk has no padding row,
        so a warm-started lane has ``use_warm.all()`` true and
        ``solver._solve_dsm_core`` skips the elliptical phase. A canonical
        chunk at B > 1 holding warm lanes would need USE_WARM forced to
        False to stay independent of how the lanes are grouped.
        """
        OFF = np.zeros((Bp, 2), np.int32)
        CNT = np.zeros((Bp,), np.int32)
        YQ = np.zeros((Bp, pb), np.int16)
        YS = np.zeros((Bp,), np.float32)
        SUB = np.full((Bp, kb, 2), -10 * (cutoff + 1), np.int16)
        KM = np.zeros((Bp, kb), np.float32)
        WARM = np.zeros((Bp, 6 + kb), np.float32)
        USE_WARM = np.zeros((Bp,), bool)
        if use_mask:
            MB = np.zeros((Bp, (pb * MASK_BITS_PER_PIXEL) // 8), np.uint8)
            WDT = np.ones((Bp,), np.int32)
        else:
            PIXa = np.zeros((Bp, pb, 2), np.int16)
        for j, i in enumerate(chunk):
            p = problems[i]
            npix, k = p.n_pixels, p.n_deform
            if use_mask:
                pm = p.packed_mask
                MB[j, :len(pm)] = pm
                WDT[j] = p.crop_shape[1]
            else:
                PIXa[j, :npix] = p.pts
            OFF[j] = p.offset
            CNT[j] = npix
            YQ[j, :npix] = p.yq
            YS[j] = p.yscale
            SUB[j, :k] = p.sub
            KM[j, :k] = 1.0
            if p.init_params is not None:
                WARM[j, :6 + k] = p.init_params
                USE_WARM[j] = True
        if warm_tail_all:
            USE_WARM[len(chunk):] = USE_WARM[:len(chunk)].all()
        ALPHA = np.full(Bp, alpha, np.float32)
        for j, i in enumerate(chunk):
            ALPHA[j] *= problems[i].alpha_scale
        head = (MB, WDT) if use_mask else (PIXa,)
        return head + (OFF, CNT, YQ, YS, denom, SUB, KM, WARM, USE_WARM, ALPHA,
                       float(epsilon), int(maxiter)) + statics

    for (pb, kb), idxs in sorted(dsm_groups.items()):
        # cold problems first: warm-started lanes converge in far fewer
        # iterations, so sorting packs them into their own tail chunk(s)
        idxs.sort(key=lambda i: (problems[i].init_params is not None,
                                 problems[i].n_pixels))
        for vidxs, use_mask in _variants(idxs, pb):
            kind = 'dsm-m' if use_mask else 'dsm'
            chunk_start = 0
            for size in _dsm_chunk_sizes(len(vidxs), _b_cap(pb), pb, kb,
                                         min_b=min_b):
                chunk = vidxs[chunk_start: chunk_start + size]
                chunk_start += size
                Bp = max(_batch_shape(len(chunk), pb), min_b)
                with trace.span('sdsm.solve.pack', kind=kind, lanes=len(chunk)):
                    arrays = _dsm_chunk_arrays(chunk, pb, kb, Bp, use_mask, warm_tail_all=True)
                # a split keeps the whole chunk's elliptical skip (USE_WARM.all())
                split = {} if devices is None else \
                    {'all_warm': bool(arrays[_USE_WARM_AT[kind]].all())}
                with trace.span('sdsm.solve.dispatch', kind=kind, lanes=len(chunk),
                                P=pb, n=6 + kb, B=Bp):
                    outs = solve_on_devices(_DSM_SOLVES[kind], arrays, devices, **split)
                _count_transfer(kind, problems=len(chunk), fitting=_fitting(chunk, pb, use_mask))
                pending.append((kind, chunk, (kind, pb, kb, Bp) + statics, outs))
                if out is not None:
                    out.intermediate(
                        f'{progress_line}... dispatched '
                        f'{sum(len(c) for _, c, _, _ in pending)} / {len(problems)}')

    shapes = [shape for _, _, shape, _ in pending]
    try:
        with trace.span('sdsm.solve.fetch') as fetch_span:
            fetched = _fetch_with_deadline(
                [_selection(kind, outs, fetch) for kind, _, _, outs in pending],
                timeout if _all_warm(shapes) else None)
    except SolveTimeout:
        if out is not None:
            out.write(f'{progress_line}: deadline ({timeout:.0f}s) expired — '
                      f'{len(problems)} solve(s) fall back to initialization')
        return _fallback_results_after_timeout(
            problems, oversized, alpha, epsilon, smooth_amount, cutoff, fetch)
    _mark_warm(shapes)
    _account([row['it'][:len(chunk)] for (_, chunk, _, _), row in zip(pending, fetched)])
    with _DEVICE_ACCT_LOCK:
        _DEVICE_ACCT['calls'] += 1
    if _TELEMETRY:
        # per-lane iterations: (kind, n_real, max and mean over real lanes)
        groups = [(kind, len(chunk), int(np.max(row['it'][:len(chunk)])),
                   round(float(np.mean(row['it'][:len(chunk)])), 1))
                  for (kind, chunk, _, _), row in zip(pending, fetched)]
        print(f'[solve_problems] n={len(problems)} calls={len(pending)} '
              f'dispatch={fetch_span.start - whole.start:.3f}s '
              f'fetch={fetch_span.end - fetch_span.start:.3f}s '
              f'groups(kind,n,itmax,itmean)={groups} '
              f'poly={sorted((pb, len(v)) for pb, v in poly_groups.items())} '
              f'dsm={sorted((k, len(v)) for k, v in dsm_groups.items())}',
              file=sys.stderr, flush=True)

    with trace.span('sdsm.solve.store'):
        for (kind, chunk, _, _), row in zip(pending, fetched):
            _store_results(results, problems, kind, chunk, row, fetch)

    # canonical re-solve of non-converged DSM lanes (see _CANONICAL_P_LADDER)
    flagged, resolve = [], []
    for (kind, chunk, shape, _), row in zip(pending, fetched):
        if not kind.startswith('dsm') or not _CANONICAL_RESOLVE:
            continue  # truncated poly lanes are batch-shape invariant
        lanes = [i for j, i in enumerate(chunk)
                 if not row['conv'][j] and i not in oversized]
        all_warm = all(problems[i].init_params is not None for i in chunk)
        flagged += lanes
        resolve += [i for i in lanes if not _batch_was_canonical(
            problems[i], shape[1], shape[2], all_warm)]
    global _LAST_FLAGGED
    _LAST_FLAGGED = [problems[i].tag for i in flagged]
    if resolve:
        resolve.sort()
        with trace.span('sdsm.solve.canonical', lanes=len(resolve)) as canonical:
            trace.count('dsm.canonical', len(resolve))
            groups = {}
            for i in resolve:
                pc, kc = _canonical_buckets(problems[i])
                use_mask = mask_capable and problems[i].fits_mask(pc)
                groups.setdefault((pc, kc, use_mask), []).append(i)
            canon = []  # (chunk, shape, device outputs)
            for (pc, kc, use_mask), idxs in sorted(groups.items()):
                kind = 'dsm-m' if use_mask else 'dsm'
                for cs in range(0, len(idxs), _CANONICAL_B):
                    chunk = idxs[cs:cs + _CANONICAL_B]
                    outs = _DSM_SOLVES[kind](*_dsm_chunk_arrays(
                        chunk, pc, kc, _CANONICAL_B, use_mask, warm_tail_all=False))
                    _count_transfer(kind, problems=len(chunk),
                                    fitting=_fitting(chunk, pc, use_mask))
                    canon.append((chunk, (kind, pc, kc, _CANONICAL_B) + statics,
                                  outs))
            canon_shapes = [shape for _, shape, _ in canon]
            try:
                with trace.span('sdsm.solve.fetch'):
                    fetched2 = _fetch_with_deadline(
                        [_selection('dsm', outs, fetch) for _, _, outs in canon],
                        timeout if _all_warm(canon_shapes) else None)
            except SolveTimeout:
                fetched2 = None
                if out is not None:
                    out.write(f'{progress_line}: canonical re-solve deadline '
                              f'expired — {len(resolve)} lane(s) keep their '
                              f'batch-shape energies this round')
            if fetched2 is not None:
                _mark_warm(canon_shapes)
                with trace.span('sdsm.solve.store'):
                    for (chunk, _, _), row in zip(canon, fetched2):
                        _store_results(results, problems, 'dsm', chunk, row, fetch)
                _account([row['it'][:len(chunk)] for (chunk, _, _), row in zip(canon, fetched2)],
                         canonical_lanes=len(resolve))
        if _TELEMETRY and fetched2 is not None:
            print(f'[canonical] n={len(resolve)} of {len(flagged)} flagged '
                  f'calls={len(canon)} '
                  f'groups={sorted((pc, kc, len(v)) for (pc, kc, _), v in groups.items())} '
                  f'wall={canonical.end - canonical.start:.3f}s',
                  file=sys.stderr, flush=True)

    for i, (factor, orig) in oversized.items():
        res = results[i]
        res.energy = float(res.energy) * factor
        if fetch != 'energy':
            res.fg = evaluate_foreground(orig, res.params, float(smooth_amount),
                                         int(cutoff))
    return results


def _canonical_buckets(p):
    """The (P, K) buckets of the canonical re-solve of problem ``p``."""
    return (_bucket(p.n_pixels, list(_CANONICAL_P_LADDER)),
            _bucket(max(p.n_deform, 1), list(_CANONICAL_K_LADDER)))


def _batch_was_canonical(p, pb, kb, all_warm):
    """Whether problem ``p``, solved in a chunk of buckets ``(pb, kb)``
    whose real lanes were all warm-started (``all_warm``) or not, already
    computed what its canonical re-solve computes: the same buckets, and the
    same start — a cold lane, or a warm one in an all-warm chunk (a warm
    lane beside cold ones starts from the better of its warm start and the
    elliptical solve, which a re-solve of the warm lane alone skips)."""
    return ((pb, kb) == _canonical_buckets(p)
            and (p.init_params is None or all_warm))


def _count_lanes(kind, row, n):
    """Counts how the Newton loop of each of a solved chunk's ``n`` real
    lanes ended, on the recorder's innermost span (:mod:`..trace`), from the
    rows already on the host: ``<kind>.fallback`` (flagged ``bad``),
    ``<kind>.converged`` (frozen by the loop's test, whose clause for a lane
    that gains nothing at the damping cap sets the same ``conv``: a stalled
    lane counts here) or ``<kind>.capped`` (not frozen when the iteration
    cap ended the loop), kind ``poly`` or ``dsm``; the three sum to ``n``."""
    bad = np.asarray(row['bad'][:n], bool)
    conv = np.asarray(row['conv'][:n], bool)
    kind = kind.split('-')[0]
    n_bad = int(bad.sum())
    n_conv = int((conv & ~bad).sum())
    trace.count(f'{kind}.fallback', n_bad)
    trace.count(f'{kind}.converged', n_conv)
    trace.count(f'{kind}.capped', n - n_bad - n_conv)


def _store_results(results, problems, kind, chunk, row, fetch):
    """Writes the host rows of one solved chunk into ``results`` (and, with
    the span recorder on, counts how its lanes ended: :func:`_count_lanes`)."""
    if trace.enabled():
        _count_lanes(kind, row, len(chunk))
    f, bad = row['f'], row['bad']
    for j, i in enumerate(chunk):
        p = problems[i]
        status = 'fallback' if bad[j] else 'optimal'
        if fetch == 'energy':
            results[i] = ProblemResult(params=None, energy=float(f[j]),
                                       status=status, surface=None, fg=None,
                                       tag=p.tag)
            continue
        params = row['params'][j]
        if kind.startswith('dsm'):
            params = np.concatenate([params[:6], params[6:6 + p.n_deform]])
        results[i] = ProblemResult(
            params=params, energy=float(f[j]), status=status, surface=None,
            fg=unpack_fg(row['fg'][j], p.n_pixels), tag=p.tag)
