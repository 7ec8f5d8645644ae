"""Objects (sets of atomic regions) and batched model fitting.

Port of :mod:`superdsm_tpu.objects` (counterpart of the reference's
``superdsm/objects.py``). The per-object Ray fan-out
(``superdsm/objects.py:215-284``) is replaced by :func:`compute_objects`
packing all candidate regions into padded, bucketed batches solved on the
selected torch device (see :mod:`superdsm_tpu_torch.dsm.batching`).
"""

import os
import sys
import time

import numpy as np
import scipy.ndimage as ndi

from .output import get_output
from ._aux import copy_dict
from .image import bbox as _bbox
from .dsm.model import DeformableShapeModel, polynomial_basis
from .dsm.batching import make_problem, solve_problems


class BaseObject:
    """A segmentation mask as a foreground fragment plus an offset."""

    def __init__(self):
        self.fg_offset = None
        self.fg_fragment = None

    def fill_foreground(self, out, value=True):
        """Writes the segmentation mask of this object into ``out``.

        :return: The slice of ``out`` that was altered.
        """
        assert self.fg_offset is not None
        assert self.fg_fragment is not None
        sel = np.s_[self.fg_offset[0]: self.fg_offset[0] + self.fg_fragment.shape[0],
                    self.fg_offset[1]: self.fg_offset[1] + self.fg_fragment.shape[1]]
        out[sel] = value * self.fg_fragment
        return sel


class Object(BaseObject):
    """A set of atomic image regions (a realization of the set X).

    :ivar footprint: Set of atom labels this object represents.
    :ivar energy: Value of the set energy ν(X).
    :ivar on_boundary: Whether the object touches the image boundary.
    :ivar is_optimal: Whether the energy optimization succeeded.
    :ivar processing_time: Solve time in seconds (batch-amortized here).
    """

    def __init__(self):
        super().__init__()
        self.footprint = set()
        self.energy = np.nan
        self.on_boundary = np.nan
        self.is_optimal = np.nan
        self.processing_time = np.nan

    def get_mask(self, atoms):
        """Binary mask of the union of the represented atomic regions.

        Small footprints (the overwhelmingly common case: singletons and
        c2f split children) use direct equality instead of ``np.isin`` —
        isin's sort-based matching measured ~5x slower on dense-tile
        profiles (0.63 s of a 1.7 s c2f advance phase)."""
        labels = list(self.footprint)
        if len(labels) == 1:
            return atoms == labels[0]
        if len(labels) <= 4:
            mask = atoms == labels[0]
            for label in labels[1:]:
                mask |= atoms == label
            return mask
        return np.isin(atoms, labels).reshape(atoms.shape)

    def get_cvxprog_region(self, y, atoms, background_margin):
        """The region used for convex programming: the union-of-atoms mask
        intersected with a ``background_margin``-wide stripe of background
        (cf. ``superdsm/objects.py:95-128``)."""
        region = y.get_region(self.get_mask(atoms))
        region.mask = np.logical_and(region.mask,
                                     _background_distance(y) <= background_margin)
        return region

    def set(self, state):
        """Adopts the state of another object."""
        self.fg_fragment = state.fg_fragment.copy() if state.fg_fragment is not None else None
        self.fg_offset = state.fg_offset.copy() if state.fg_offset is not None else None
        self.footprint = set(state.footprint)
        self.energy = state.energy
        self.on_boundary = state.on_boundary
        self.is_optimal = state.is_optimal
        self.processing_time = state.processing_time
        return self

    def copy(self):
        return Object().set(self)


def _background_distance(y):
    """EDT of the background (y <= 0), cached on the image object.

    The reference recomputes this EDT for every object
    (``superdsm/objects.py:127``); it only depends on ``y``,
    so it is computed once per image here.
    """
    cache = getattr(y, '_sdsm_bg_edt', None)
    if cache is None:
        from .ops.edt import edt as _edt
        cache = _edt(y.model <= 0)
        y._sdsm_bg_edt = cache
    return cache


def extract_foreground_fragment(fg_mask):
    """Returns the minimal bounding rectangle of the foreground + offset."""
    if fg_mask.any():
        rows = fg_mask.any(axis=1)
        cols = fg_mask.any(axis=0)
        rmin, rmax = np.where(rows)[0][[0, -1]]
        cmin, cmax = np.where(cols)[0][[0, -1]]
        fg_offset = np.array([rmin, cmin])
        fg_fragment = fg_mask[rmin: rmax + 1, cmin: cmax + 1]
        return fg_offset, fg_fragment
    return np.zeros(2, int), np.zeros((1, 1), bool)


class CvxprogError(Exception):
    """Raised when model fitting fails irrecoverably."""


DEFAULT_COMPUTING_STATUS_LINE = ('Computing objects', 'Computed objects')


def _warm_start_params(obj, problem):
    """Warm-start vector for ``problem`` from ``obj.init_from``'s solution.

    The generation loop grows footprints by one atom
    (:mod:`superdsm_tpu_torch.globalenergymin`); the parent's optimum is an
    excellent start for the child's convex program. ``theta`` transfers
    directly (coordinates are normalized by the full-image shape); ``xi``
    entries are matched by absolute subsample-point coordinates, new points
    start at zero. Returns ``None`` if no usable parent solution exists.
    """
    parent = getattr(obj, 'init_from', None)
    if parent is None:
        return None
    params = getattr(parent, '_dsm_params', None)
    if params is None:
        return None
    init = np.zeros(6 + problem.n_deform, np.float32)
    init[:6] = params[:6]
    parent_sub = getattr(parent, '_dsm_sub_abs', None)
    if parent_sub is not None and len(parent_sub) and len(params) > 6:
        xi_by_coord = {(int(r), int(c)): params[6 + k]
                       for k, (r, c) in enumerate(parent_sub)}
        child_abs = problem.sub + np.asarray(problem.offset)[None, :]
        for k, (r, c) in enumerate(child_abs):
            init[6 + k] = xi_by_coord.get((int(r), int(c)), 0.0)
    return init


def _border_ring_coords(shape):
    """Normalized coordinates of the 1-pixel ring just outside the image.

    The reference determines ``on_boundary`` by evaluating the fitted surface
    on a zero-padded full-image grid and checking its border
    (``superdsm/objects.py:198-209``); border pixels carry no
    deformation term (they are outside every mask), so the polynomial part
    suffices. Padded border pixel p maps to normalized coordinate
    ``(p - 1) / (shape - 1)``.
    """
    H, W = shape
    rs, cs = [], []
    cols = np.arange(W + 2)
    rows = np.arange(1, H + 1)
    rs += [np.zeros(W + 2), np.full(W + 2, H + 1), rows, rows]
    cs += [cols, cols, np.zeros(H), np.full(H, W + 1)]
    r = np.concatenate(rs) - 1.0
    c = np.concatenate(cs) - 1.0
    denom = np.maximum(np.array(shape, float) - 1.0, 1.0)
    return np.stack([r / denom[0], c / denom[1]], axis=-1)


def compute_objects(objects, y, atoms, dsm_cfg, log_root_dir=None,
                    status_line=DEFAULT_COMPUTING_STATUS_LINE, out=None):
    """Computes energy/foreground/boundary attributes for a list of objects.

    All objects are fitted in padded batches on the device; the attributes
    :attr:`~Object.energy`, :attr:`~Object.on_boundary`,
    :attr:`~Object.is_optimal`, :attr:`~Object.processing_time`,
    :attr:`~BaseObject.fg_fragment`, :attr:`~BaseObject.fg_offset` are filled
    in place (cf. ``superdsm/objects.py:243-284``).
    """
    out = get_output(out)
    dsm_cfg = copy_dict(dsm_cfg)
    dsm_cfg.pop('smooth_mat_max_allocations', None)
    objects = list(objects)
    t0 = time.time()

    margin = dsm_cfg.get('background_margin', 20)
    smooth_amount = dsm_cfg.get('smooth_amount', 10)
    ring = _border_ring_coords(y.model.shape)
    ring_basis = polynomial_basis(ring)

    # crop-first region construction: the union-of-atoms bbox comes from
    # per-atom bounding boxes, so each candidate costs O(crop) instead of a
    # full-frame isin + EDT pass (semantics of Object.get_cvxprog_region)
    from .image import Image as _Image
    adm = y.mask & (_background_distance(y) <= margin)
    atom_slices = ndi.find_objects(atoms)

    def _candidate_region(obj):
        labels = list(obj.footprint)
        boxes = [atom_slices[l - 1] for l in labels
                 if 0 < l <= len(atom_slices) and atom_slices[l - 1] is not None]
        if not boxes:
            return None
        r0 = min(b[0].start for b in boxes)
        r1 = max(b[0].stop for b in boxes)
        c0 = min(b[1].start for b in boxes)
        c1 = max(b[1].stop for b in boxes)
        sel = np.s_[r0:r1, c0:c1]
        mask_crop = np.isin(atoms[sel], labels) & adm[sel]
        return _Image(model=y.model[sel], mask=mask_crop, offset=(r0, c0))

    def _build_problem(idx, obj):
        region = _candidate_region(obj)
        if region is None or not region.mask.any() \
                or (region.model[region.mask] > 0).sum() == 1:
            # single-pixel foreground is just noise
            # (superdsm/objects.py:184-191)
            return None
        problem = make_problem(
            region, img_shape=y.model.shape,
            smooth_amount=smooth_amount,
            gaussian_shape_multiplier=dsm_cfg.get('gaussian_shape_multiplier', 2),
            smooth_subsample=dsm_cfg.get('smooth_subsample', 20), tag=idx)
        problem.init_params = _warm_start_params(obj, problem)
        return problem

    # problem construction is independent per object over shared read-only
    # arrays, and its hot parts (argwhere/isin, the native subsample grid)
    # release the GIL — threading cuts the pack phase ~2-3x (telemetry:
    # pack= in [compute_objects])
    if len(objects) > 3:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=8) as pool:
            built = list(pool.map(lambda io: _build_problem(*io),
                                  enumerate(objects)))
    else:
        built = [_build_problem(idx, obj) for idx, obj in enumerate(objects)]

    # Identical-footprint dedup: the first gem batch solves every singleton
    # atom AND every cluster universe, and a single-atom cluster's universe
    # is the SAME region as its atom — on a dense mosaic tile that halved
    # the batch (392 -> 196 solves). Only cold problems dedup (warm starts
    # differ by parent); results are copied to every aliased object, which
    # also makes Criterion 2 exactly consistent for trivial clusters
    # (previously the two solves of the same region could land on different
    # creep plateaus — see _stability.py).
    problems = []
    alias = {}        # problems index -> [object index, ...]
    canon_by_fp = {}  # footprint -> problems index (cold inits only)
    trivial = []
    for idx, (obj, problem) in enumerate(zip(objects, built)):
        if problem is None:
            trivial.append(idx)
            obj.fg_offset = np.zeros(2, int)
            obj.fg_fragment = np.zeros((1, 1), bool)
            obj.energy = 0.
            obj.on_boundary = False
            obj.is_optimal = False
            obj.processing_time = 0
            continue
        if problem.init_params is None:
            fp = frozenset(obj.footprint)
            j = canon_by_fp.get(fp)
            if j is not None:
                alias[j].append(idx)
                continue
            canon_by_fp[fp] = len(problems)
        alias[len(problems)] = [idx]
        problems.append(problem)

    _t_packed = time.time()
    results = solve_problems(
        problems,
        alpha=dsm_cfg.get('alpha', 0.5), epsilon=dsm_cfg.get('epsilon', 1.0),
        smooth_amount=smooth_amount,
        gaussian_shape_multiplier=dsm_cfg.get('gaussian_shape_multiplier', 2),
        init=dsm_cfg.get('init', 'elliptical'),
        maxiter=dsm_cfg.get('newton_maxiter', 50),
        tol=dsm_cfg.get('newton_tol', 1e-5), out=out,
        progress_line=status_line[0])

    dt = time.time() - t0
    _t_solved = time.time()
    fallbacks = 0
    per_obj_time = dt / max(1, len(problems))
    for p_idx, (prob, res) in enumerate(zip(problems, results)):
        fg_local = res.fg if res.fg is not None else (res.surface > 0)
        crop_shape = tuple(prob.pts.max(axis=0) + 1) if prob.n_pixels else (1, 1)
        fg_crop = np.zeros(crop_shape, bool)
        fg_crop[prob.pts[:, 0], prob.pts[:, 1]] = fg_local
        if fg_crop.any():
            fg_offset, fg_fragment = extract_foreground_fragment(fg_crop)
            fg_offset = fg_offset + np.asarray(prob.offset)
        else:
            fg_offset = np.zeros(2, int)
            fg_fragment = np.zeros((1, 1), bool)
        theta = res.params[:6]
        on_boundary = bool((ring_basis @ theta > 0).any())
        sub_abs = prob.sub + np.asarray(prob.offset)[None, :] \
            if prob.n_deform else np.zeros((0, 2), np.int32)
        for n_shared, obj_idx in enumerate(alias[p_idx]):
            obj = objects[obj_idx]
            obj.fg_offset = fg_offset.copy() if n_shared else fg_offset
            obj.fg_fragment = fg_fragment.copy() if n_shared else fg_fragment
            obj.on_boundary = on_boundary
            obj.energy = res.energy
            obj.is_optimal = (res.status == 'optimal')
            obj.processing_time = per_obj_time
            # retain the solution for warm-starting objects grown from this
            # one (footprint + one atom); theta transfers directly, xi by
            # absolute subsample-point coordinates
            obj._dsm_params = res.params
            obj._dsm_sub_abs = sub_abs
        if res.status == 'fallback':
            fallbacks += 1

    if os.environ.get('SDSM_SOLVE_TELEMETRY') == '1':
        print(f'[compute_objects] n={len(objects)} problems={len(problems)} '
              f'pack={_t_packed - t0:.3f}s solve={_t_solved - _t_packed:.3f}s '
              f'unpack={time.time() - _t_solved:.3f}s',
              file=sys.stderr, flush=True)

    if log_root_dir is not None:
        # per-solve telemetry (the reference redirects each Ray worker's
        # stdout to log/<img>/genN/<cidx>.txt, objects.py:220-233; the
        # batched path writes one summary per compute_objects call)
        from ._aux import mkdir
        mkdir(log_root_dir)
        with open(os.path.join(log_root_dir, 'solves.txt'), 'a') as fout:
            for prob, res in zip(problems, results):
                obj = objects[prob.tag]
                fout.write(f'footprint={sorted(obj.footprint)} '
                           f'pixels={prob.n_pixels} deform={prob.n_deform} '
                           f'energy={res.energy:.6g} status={res.status} '
                           f'on_boundary={obj.on_boundary}\n')

    out.write(f'{status_line[1]}: {len(objects)} ({fallbacks}x fallback)')
    return objects

