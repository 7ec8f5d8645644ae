"""Padded, bucketed batching of per-region convex solves.

Port of :mod:`superdsm_tpu.dsm.batching`: candidate regions of arbitrary
size are packed into batches of fixed shapes (pixel counts and deformation
dimensions padded to bucket sizes, the batch padded with dummy problems), and
every bucket group runs the batched Newton solver of
:mod:`superdsm_tpu_torch.dsm.solver` on the selected device. Every group is
launched first; the results are copied to the host afterwards. Non-converged
DSM lanes are re-solved at a frozen canonical shape, so their energies do not
depend on the runtime bucket ladder or chunking.
"""

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .._device import on_cpu
from .solver import (_pack_poly_group, _solve_dsm_packed, unpack_fg,
                     evaluate_foreground, DEFAULT_MAXITER, DEFAULT_TOL)
from .smooth import prepare_deformation, smooth_matrix_params

#: Pixel-count buckets (every value a multiple of 2048, so the gram kernel's
#: row chunking and the 8-bit foreground packing divide every bucket).
P_BUCKETS = [2048, 6144, 8192, 12288, 16384, 24576, 32768, 131072, 524288,
             2097152]
#: Deformation-dimension buckets (6 + K = powers of two).
K_BUCKETS = [0, 26, 58, 122, 250, 506, 1018, 2042]

#: Canonical re-solve of non-converged DSM lanes: a truncated (LM-stalled,
#: near-separable) lane's energy is a trajectory snapshot that depends on
#: the batch shape; re-solving exactly those lanes in a FROZEN canonical
#: shape makes their energies a function of the problem alone.
#: FROZEN: never derive these from the runtime P_BUCKETS/K_BUCKETS.
_CANONICAL_P_LADDER = (2048, 6144, 8192, 12288, 16384, 24576, 32768,
                       131072, 524288, 2097152)
_CANONICAL_K_LADDER = (26, 58, 122, 250, 506, 1018, 2042)
_CANONICAL_B = 1
#: Tags of the lanes the last solve_problems call re-solved canonically
#: (test/debug aid).
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


def _dsm_chunk_sizes(n, cap, pb, kb, on_cpu_=None):
    """Chunk sizes for an ``n``-problem ``(pb, kb)`` DSM group: full-cap
    chunks, then the remainder — split into the largest power of two below
    it plus the padded rest when the group is compute-bound and that saves
    material padding (lanes freeze individually, so batch composition never
    changes a problem's iterates). Never split on the CPU, which pins the
    CPU results to one chunking."""
    sizes = []
    while n > cap:
        sizes.append(cap)
        n -= cap
    if n <= 0:
        return sizes
    padded = _pow2_ceil(n)
    if on_cpu_ is None:
        on_cpu_ = on_cpu()
    if (not on_cpu_ and pb * (6 + kb) ** 2 >= _SPLIT_MIN_WORK and padded > n):
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
    """
    pts: np.ndarray
    offset: np.ndarray
    img_shape: tuple
    yv: np.ndarray
    sub: np.ndarray
    tag: object = None
    init_params: Optional[np.ndarray] = None
    alpha_scale: float = 1.0

    @property
    def n_pixels(self):
        return len(self.pts)

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
                   sub=sub, tag=tag)


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


def _host(t):
    return t.detach().cpu().numpy()


def solve_problems(problems, alpha=0.5, epsilon=1.0, smooth_amount=10,
                   gaussian_shape_multiplier=2, init='elliptical',
                   maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL, out=None,
                   progress_line='Computing objects', fetch='full'):
    """Solves a list of :class:`Problem` in padded, bucketed batches.

    Problems without deformation dimensions run the packed 6-parameter
    solve; all others run ONE packed solve per (P, K) bucket chunk that
    performs the elliptical initialization and the full DSM solve, starting
    from the better of the elliptical solution and the optional warm start
    (cf. ``cvxprog``, reference ``superdsm/objects.py:361-412``).

    :param fetch: ``'full'`` copies parameters and foreground masks to the
        host; ``'energy'`` only energies and fallback flags.
    :return: list of :class:`ProblemResult`, aligned with ``problems``.
    """
    results = [None] * len(problems)
    if len(problems) == 0:
        return results

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

    # launch every bucket group, then copy all results to the host
    pending = []  # (kind, chunk, device outputs)
    for pb, idxs in sorted(poly_groups.items()):
        bmax = _b_cap(pb, 'poly')
        for chunk_start in range(0, len(idxs), bmax):
            chunk = idxs[chunk_start: chunk_start + bmax]
            Bp = _batch_shape(len(chunk), pb, 'poly')
            inits = [problems[i].init_params for i in chunk]
            outs = _pack_poly_group([problems[i] for i in chunk], img_shape,
                                    params0=inits, maxiter=maxiter, tol=tol,
                                    pb=pb, Bp=Bp)
            pending.append(('poly', chunk, outs))

    def _dsm_chunk_arrays(chunk, pb, kb, Bp, warm_tail_all):
        """Packs one dsm chunk (ONE construction for the production solve
        and the canonical re-solve).

        ``warm_tail_all``: padding rows' USE_WARM value. Production passes
        True semantics (all-of-real — preserves the all-warm elliptical
        skip); the canonical re-solve passes False so the
        better-of(elliptical, warm) init path always runs.
        """
        PIXa = np.zeros((Bp, pb, 2), np.int16)
        OFF = np.zeros((Bp, 2), np.int32)
        CNT = np.zeros((Bp,), np.int32)
        YQ = np.zeros((Bp, pb), np.int16)
        YS = np.zeros((Bp,), np.float32)
        SUB = np.full((Bp, kb, 2), -10 * (cutoff + 1), np.int16)
        KM = np.zeros((Bp, kb), np.float32)
        WARM = np.zeros((Bp, 6 + kb), np.float32)
        USE_WARM = np.zeros((Bp,), bool)
        for j, i in enumerate(chunk):
            p = problems[i]
            npix, k = p.n_pixels, p.n_deform
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
        return (PIXa, OFF, CNT, YQ, YS, denom, SUB, KM, WARM, USE_WARM, ALPHA,
                float(epsilon), int(maxiter), float(tol), float(smooth_amount),
                int(cutoff))

    for (pb, kb), idxs in sorted(dsm_groups.items()):
        # cold problems first: warm-started lanes converge in far fewer
        # iterations, so sorting packs them into their own tail chunk(s)
        idxs.sort(key=lambda i: (problems[i].init_params is not None,
                                 problems[i].n_pixels))
        chunk_start = 0
        for size in _dsm_chunk_sizes(len(idxs), _b_cap(pb), pb, kb):
            chunk = idxs[chunk_start: chunk_start + size]
            chunk_start += size
            Bp = _batch_shape(len(chunk), pb)
            outs = _solve_dsm_packed(*_dsm_chunk_arrays(chunk, pb, kb, Bp,
                                                        warm_tail_all=True))
            pending.append(('dsm', chunk, outs))
            if out is not None:
                out.intermediate(
                    f'{progress_line}... dispatched '
                    f'{sum(len(c) for _, c, _ in pending)} / {len(problems)}')

    # output layouts: poly (params, f, conv, bad, fg, it_lane);
    #                 dsm (params, f, f_ell, conv, bad, fg, it_lane)
    _idx = {'poly': dict(f=1, conv=2, bad=3, fg=4, it=5),
            'dsm': dict(f=1, conv=3, bad=4, fg=5, it=6)}
    fetched = []
    for kind, _, outs in pending:
        ix = _idx[kind]
        keys = ['f', 'bad', 'conv'] if fetch == 'energy' else \
            ['f', 'bad', 'conv', 'fg']
        row = {k: _host(outs[ix[k]]) for k in keys}
        if fetch != 'energy':
            row['params'] = _host(outs[0])
        fetched.append(row)

    for (kind, chunk, _), row in zip(pending, fetched):
        _store_results(results, problems, kind, chunk, row, fetch)

    # canonical re-solve of non-converged DSM lanes (see _CANONICAL_P_LADDER)
    flagged = []
    for (kind, chunk, _), row in zip(pending, fetched):
        if kind != 'dsm':
            continue  # truncated poly lanes are batch-shape invariant
        flagged += [i for j, i in enumerate(chunk)
                    if not row['conv'][j] and i not in oversized]
    global _LAST_FLAGGED
    _LAST_FLAGGED = [problems[i].tag for i in flagged]
    if flagged:
        flagged.sort()
        groups = {}
        for i in flagged:
            p = problems[i]
            pc = _bucket(p.n_pixels, list(_CANONICAL_P_LADDER))
            kc = _bucket(max(p.n_deform, 1), list(_CANONICAL_K_LADDER))
            groups.setdefault((pc, kc), []).append(i)
        canon_pending = []
        for (pc, kc), idxs in sorted(groups.items()):
            for cs in range(0, len(idxs), _CANONICAL_B):
                chunk = idxs[cs:cs + _CANONICAL_B]
                outs = _solve_dsm_packed(*_dsm_chunk_arrays(
                    chunk, pc, kc, _CANONICAL_B, warm_tail_all=False))
                canon_pending.append((chunk, outs))
        ix = _idx['dsm']
        for chunk, outs in canon_pending:
            row = {'f': _host(outs[ix['f']]), 'bad': _host(outs[ix['bad']])}
            if fetch != 'energy':
                row['params'] = _host(outs[0])
                row['fg'] = _host(outs[ix['fg']])
            _store_results(results, problems, 'dsm', chunk, row, fetch)

    for i, (factor, orig) in oversized.items():
        res = results[i]
        res.energy = float(res.energy) * factor
        if fetch != 'energy':
            res.fg = evaluate_foreground(orig, res.params, float(smooth_amount),
                                         int(cutoff))
    return results


def _store_results(results, problems, kind, chunk, row, fetch):
    """Writes the host rows of one solved chunk into ``results``."""
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
        if kind == 'dsm':
            params = np.concatenate([params[:6], params[6:6 + p.n_deform]])
        results[i] = ProblemResult(
            params=params, energy=float(f[j]), status=status, surface=None,
            fg=unpack_fg(row['fg'][j], p.n_pixels), tag=p.tag)
