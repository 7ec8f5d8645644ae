"""Stage 5: post-processing (object filtering and mask refinement).

Counterpart of the reference's ``Postprocessing``
(``superdsm/postprocess.py:114-344``): objects from the
min-weight set cover are discarded by normalized energy, contrast,
autofluorescence glare, eccentricity, boundary rules, and radius bounds, and
the surviving masks are refined by intensity-similarity of boundary pixels.

Design differences from the reference:

- The reference spawns a Ray task per object, each computing a *full-frame*
  EDT for the contrast weights (``postprocess.py:254-266``). Here each
  object is processed in a padded bounding box of radius
  ``exterior_offset + 5 * exterior_scale`` — the exterior weight is zero
  beyond that distance, so the result is identical and the work is O(object)
  instead of O(image).
- The two Gaussian-smoothed full images are computed once on the host in
  float64 (scipy separable filter, the reference's own semantics,
  ``postprocess.py:316-337``), which keeps the result independent of the
  device.
- Eccentricity is computed from central image moments directly
  (scikit-image is not a dependency).
"""

import math
import os

import numpy as np
import scipy.ndimage as ndi

from .pipeline import Stage
from ._aux import join_path
from ._stability import dq
from .objects import BaseObject, extract_foreground_fragment
from .ops.edt import edt
from .ops.morphology import disk, binary_dilation, binary_erosion


class Postprocessing(Stage):
    """Post-processing stage.

    Hyperparameter semantics follow the reference
    (``superdsm/postprocess.py:121-147``): simple filters
    (``max_norm_energy`` 0.2, ``discard_image_boundary`` False,
    ``min_object_radius`` 0, ``max_object_radius`` inf,
    ``min_boundary_obj_radius`` 0, ``max_eccentricity`` 0.99,
    ``max_boundary_eccentricity`` inf), contrast filters (``exterior_scale``
    5, ``exterior_offset`` 5, ``min_contrast`` 1.35, ``contrast_epsilon``
    1e-4), mask refinement (``mask_stdamp`` 2, ``mask_max_distance`` 1,
    ``mask_smoothness`` 3, ``fill_holes`` True), and glare detection
    (``glare_detection_smoothness`` 3, ``glare_detection_num_layers`` 5,
    ``glare_detection_min_layer`` 0.5, ``min_glare_radius`` inf,
    ``min_boundary_glare_radius`` = ``min_glare_radius``).
    """

    ENABLED_BY_DEFAULT = True

    def __init__(self):
        super().__init__('postprocess',
                         inputs=['cover', 'y_img', 'atoms', 'g_raw', 'dsm_cfg'],
                         outputs=['postprocessed_objects'])

    def process(self, input_data, cfg, out, log_root_dir):
        max_norm_energy = cfg.get('max_norm_energy', 0.2)
        discard_image_boundary = cfg.get('discard_image_boundary', False)
        min_boundary_obj_radius = cfg.get('min_boundary_obj_radius', 0)
        min_obj_radius = cfg.get('min_object_radius', 0)
        max_obj_radius = cfg.get('max_object_radius', np.inf)
        max_eccentricity = cfg.get('max_eccentricity', 0.99)
        max_boundary_eccentricity = cfg.get('max_boundary_eccentricity', np.inf)
        if max_boundary_eccentricity is None:
            max_boundary_eccentricity = max_eccentricity

        exterior_scale = cfg.get('exterior_scale', 5)
        exterior_offset = cfg.get('exterior_offset', 5)
        min_contrast = cfg.get('min_contrast', 1.35)
        contrast_epsilon = cfg.get('contrast_epsilon', 1e-4)

        mask_stdamp = cfg.get('mask_stdamp', 2)
        mask_max_distance = cfg.get('mask_max_distance', 1)
        mask_smoothness = cfg.get('mask_smoothness', 3)
        fill_holes = cfg.get('fill_holes', True)

        glare_detection_smoothness = cfg.get('glare_detection_smoothness', 3)
        glare_detection_num_layers = cfg.get('glare_detection_num_layers', 5)
        glare_detection_min_layer = cfg.get('glare_detection_min_layer', 0.5)
        min_glare_radius = cfg.get('min_glare_radius', np.inf)
        min_boundary_glare_radius = cfg.get('min_boundary_glare_radius', min_glare_radius)

        g_raw = np.asarray(input_data['g_raw'], np.float64)
        # host float64 smoothing (see module docstring); duplicate sigmas
        # (the defaults) are filtered once
        _smooth = {s: ndi.gaussian_filter(g_raw, s, truncate=4.0)
                   for s in {mask_smoothness, glare_detection_smoothness}}
        g_smooth_mask = _smooth[mask_smoothness]
        g_smooth_glare = _smooth[glare_detection_smoothness]
        objects = [obj for obj in input_data['cover'].solution
                   if obj.fg_fragment is not None and obj.fg_fragment.any()]

        # pixels admissible for background-intensity estimation (no object
        # foreground within exterior_offset)
        background_mask = np.zeros(g_raw.shape, bool)
        for c in objects:
            c.fill_foreground(background_mask)
        background_mask = binary_erosion(~background_mask, disk(exterior_offset))

        # per-atom pixel counts of the admissible cvxprog region (atoms are
        # disjoint, so any footprint's region size is a sum of these)
        from .objects import _background_distance
        y_img = input_data['y_img']
        atoms_map = input_data['atoms']
        adm = y_img.mask & (_background_distance(y_img)
                            <= input_data['dsm_cfg']['background_margin'])
        atom_counts = np.bincount(atoms_map[adm].ravel(),
                                  minlength=int(atoms_map.max()) + 1)

        params = {
            'y': input_data['y_img'],
            'g': g_raw,
            'atoms': input_data['atoms'],
            'atom_counts': atom_counts,
            'background_margin': input_data['dsm_cfg']['background_margin'],
            'g_mask_processing': np.asarray(g_smooth_mask, np.float64),
            'g_glare_detection': np.asarray(g_smooth_glare, np.float64),
            'background_mask': background_mask,
            'exterior_scale': exterior_scale,
            'exterior_offset': exterior_offset,
            'contrast_epsilon': contrast_epsilon,
            'mask_stdamp': mask_stdamp,
            'mask_max_distance': mask_max_distance,
            'fill_holes': fill_holes,
            'glare_detection_min_layer': glare_detection_min_layer,
            'glare_detection_num_layers': glare_detection_num_layers,
            'min_glare_radius': min_glare_radius,
            'min_boundary_glare_radius': min_boundary_glare_radius,
            'g_std': float(g_raw.std()),
        }

        # note: threading this loop was measured (2026-08-17) and does NOT
        # help — the per-object measurements are dominated by small-array
        # Python/numpy ops that hold the GIL
        postprocessed_objects = []
        log_entries = []
        for obj_idx, original in enumerate(objects):
            results = _process_object(original, params)
            obj = PostprocessedObject(original)

            if results['fg_fragment'] is not None and results['fg_offset'] is not None:
                obj.fg_fragment = results['fg_fragment'].copy()
                obj.fg_offset = results['fg_offset'].copy()
                if not obj.fg_fragment.any():
                    log_entries.append((obj, 'empty foreground'))
                    continue

            if results['is_glare']:
                log_entries.append((obj, f'glare removed (radius: {results["obj_radius"]})'))
                continue
            # energy/contrast discards are decision-quantized (recompile
            # stability, superdsm_tpu_torch._stability); the geometric filters
            # (radius/eccentricity) derive from pixel masks and only move
            # when the segmentation itself does
            if dq(results['norm_energy']) > dq(max_norm_energy):
                log_entries.append((obj, f'energy rate too high ({results["norm_energy"]})'))
                continue
            if dq(results['contrast_response']) < dq(min_contrast):
                log_entries.append((obj, f'contrast too low ({results["contrast_response"]})'))
                continue
            if obj.original.on_boundary:
                if results['eccentricity'] > max_boundary_eccentricity:
                    log_entries.append(
                        (obj, f'boundary object eccentricity too high ({results["eccentricity"]})'))
                    continue
                if discard_image_boundary:
                    log_entries.append((obj, 'boundary object discarded'))
                    continue
                if not (min_boundary_obj_radius <= results['obj_radius'] <= max_obj_radius):
                    log_entries.append(
                        (obj, f'boundary object and/or too small/large (radius: {results["obj_radius"]})'))
                    continue
            else:
                if results['eccentricity'] > max_eccentricity:
                    log_entries.append((obj, f'eccentricity too high ({results["eccentricity"]})'))
                    continue
                if not min_obj_radius <= results['obj_radius'] <= max_obj_radius:
                    log_entries.append(
                        (obj, f'object too small/large (radius: {results["obj_radius"]})'))
                    continue

            postprocessed_objects.append(obj)
            out.intermediate(f'Post-processing objects... {obj_idx + 1} / {len(objects)}')

        if log_root_dir is not None:
            log_filename = join_path(log_root_dir, 'postprocessing.txt')
            with open(log_filename, 'w') as log_file:
                for c, comment in log_entries:
                    location = (c.fg_offset + np.divide(c.fg_fragment.shape, 2)).round().astype(int)
                    log_file.write(f'object at x={location[1]}, y={location[0]}: {comment}{os.linesep}')

        out.write(f'Remaining objects: {len(postprocessed_objects)} of {len(objects)}')

        return {
            'postprocessed_objects': postprocessed_objects,
        }

    def configure_ex(self, scale, radius, diameter):
        return {
            'min_object_radius': (radius, 0.0),
            'max_object_radius': (radius, np.inf),
            'min_glare_radius': (radius, np.inf),
        }


class PostprocessedObject(BaseObject):
    """A segmented object after post-processing (wraps the original)."""

    def __init__(self, original):
        self.original = original
        self.fg_offset = original.fg_offset
        self.fg_fragment = original.fg_fragment


def _object_roi(obj, shape, pad):
    """Padded bounding-box slice of an object's foreground in the full frame."""
    r0 = max(0, int(obj.fg_offset[0]) - pad)
    c0 = max(0, int(obj.fg_offset[1]) - pad)
    r1 = min(shape[0], int(obj.fg_offset[0]) + obj.fg_fragment.shape[0] + pad)
    c1 = min(shape[1], int(obj.fg_offset[1]) + obj.fg_fragment.shape[1] + pad)
    return np.s_[r0:r1, c0:c1]


def _fragment_in_roi(obj, sel):
    """The object's foreground mask within the ROI ``sel`` (which always
    contains the fragment's bounding box), built without allocating a
    full-frame mask."""
    mask_sect = np.zeros((sel[0].stop - sel[0].start, sel[1].stop - sel[1].start), bool)
    r = int(obj.fg_offset[0]) - sel[0].start
    c = int(obj.fg_offset[1]) - sel[1].start
    mask_sect[r: r + obj.fg_fragment.shape[0], c: c + obj.fg_fragment.shape[1]] = obj.fg_fragment
    return mask_sect


def _compute_contrast(obj, g, exterior_scale, exterior_offset, epsilon,
                      background_mask, g_std):
    """Interior mean over exponentially weighted exterior mean
    (cf. ``superdsm/postprocess.py:254-266``), computed in a
    bounding box that fully contains the nonzero exterior weights."""
    pad = int(math.ceil(exterior_offset + 5 * exterior_scale)) + 1
    sel = _object_roi(obj, g.shape, pad)
    g_sect = g[sel] / g_std
    mask_sect = _fragment_in_roi(obj, sel)
    interior_mean = g_sect[mask_sect].mean()
    exterior_distance_map = (edt(~mask_sect) - exterior_offset)
    exterior_distance_map = exterior_distance_map.clip(0, np.inf) / exterior_scale
    exterior_mask = np.logical_xor(mask_sect, exterior_distance_map <= 5)
    exterior_mask = np.logical_and(exterior_mask, background_mask[sel])
    exterior_weights = np.zeros(g_sect.shape)
    exterior_weights[exterior_mask] = np.exp(-exterior_distance_map[exterior_mask])
    wsum = exterior_weights.sum()
    if wsum == 0:
        return np.inf
    exterior_weights /= wsum
    exterior_mean = (g_sect * exterior_weights).sum()
    return (interior_mean + epsilon) / (exterior_mean + epsilon)


def _is_glare(obj, g, min_layer=0.5, num_layers=5):
    """Checks connectivity of the top intensity-superlevel sets
    (cf. ``superdsm/postprocess.py:269-286``)."""
    g_sect = g[obj.fg_offset[0]: obj.fg_offset[0] + obj.fg_fragment.shape[0],
               obj.fg_offset[1]: obj.fg_offset[1] + obj.fg_fragment.shape[1]]
    mask = binary_erosion(obj.fg_fragment, disk(2))
    g_sect_data = g_sect[mask]
    if g_sect_data.size == 0:
        return False
    lo, hi = g_sect_data.min(), g_sect_data.max()
    is_glare = True
    for prop in np.linspace(min_layer, 1, num_layers, endpoint=False):
        layer = np.logical_and(mask, g_sect > (hi - lo) * prop + lo)
        if ndi.label(layer)[0].max() > 1:
            is_glare = False
            break
    return is_glare


def _compute_norm_energy(obj, atom_counts):
    """Energy over cvxprog-region pixel count. The region is the disjoint
    union of the footprint's atoms intersected with the image mask and the
    background-margin stripe (``Object.get_cvxprog_region``), so its pixel
    count is the sum of precomputed per-atom counts — avoiding a full-frame
    ``isin`` + EDT pass per object."""
    count = int(atom_counts[list(obj.original.footprint)].sum())
    with np.errstate(divide='ignore', invalid='ignore'):
        return obj.original.energy / count if count else np.inf


def _process_mask(obj, g, max_distance, stdamp, fill_holes=False):
    """Adds/removes boundary pixels whose smoothed intensity is within
    ``stdamp`` standard deviations of the mask mean
    (cf. ``superdsm/postprocess.py:316-337``), computed in a
    bounding box padded by ``max_distance``."""
    if stdamp <= 0 or max_distance <= 0:
        if fill_holes:
            return obj.fg_offset, ndi.binary_fill_holes(obj.fg_fragment)
        return None, None
    pad = int(math.ceil(max_distance)) + 1
    sel = _object_roi(obj, g.shape, pad)
    mask_sect = _fragment_in_roi(obj, sel)
    g_sect = g[sel]
    fp = disk(max_distance)
    extra_mask_superset = np.logical_xor(binary_dilation(mask_sect, fp),
                                         binary_erosion(mask_sect, fp))
    g_fg_data = g_sect[mask_sect]
    fg_mean = g_fg_data.mean()
    fg_amp = g_fg_data.std() * stdamp
    extra_fg = np.logical_and(fg_mean - fg_amp <= g_sect, g_sect <= fg_mean + fg_amp)
    extra_bg = np.logical_not(extra_fg)
    extra_fg = np.logical_and(extra_mask_superset, extra_fg)
    extra_bg = np.logical_and(extra_mask_superset, extra_bg)
    mask_sect = mask_sect.copy()
    mask_sect[extra_fg] = True
    mask_sect[extra_bg] = False
    fg_offset, fg_fragment = extract_foreground_fragment(mask_sect)
    fg_offset = fg_offset + np.array([sel[0].start, sel[1].start])
    if fill_holes:
        fg_fragment = ndi.binary_fill_holes(fg_fragment)
    return fg_offset, fg_fragment


def _compute_eccentricity(obj):
    """Eccentricity of the best-fit ellipse via central image moments
    (equivalent to ``skimage.measure.regionprops(...).eccentricity``)."""
    frag = obj.fg_fragment
    if not frag.any():
        return 0
    pts = np.argwhere(frag).astype(np.float64)
    ctr = pts.mean(axis=0)
    d = pts - ctr
    mu20 = (d[:, 0] ** 2).mean() + 1 / 12
    mu02 = (d[:, 1] ** 2).mean() + 1 / 12
    mu11 = (d[:, 0] * d[:, 1]).mean()
    common = math.sqrt((mu20 - mu02) ** 2 + 4 * mu11 ** 2)
    l1 = (mu20 + mu02 + common) / 2
    l2 = (mu20 + mu02 - common) / 2
    if l1 <= 0:
        return 0
    return math.sqrt(max(0.0, 1 - l2 / l1))


def _process_object(obj, params):
    """Per-object measurements (cf. ``superdsm/postprocess.py:294-313``)."""
    obj_radius = math.sqrt(obj.fg_fragment.sum() / math.pi)
    is_glare = False
    min_radius_key = 'min_boundary_glare_radius' if obj.on_boundary else 'min_glare_radius'
    if params[min_radius_key] < obj_radius:
        is_glare = _is_glare(obj, params['g_glare_detection'],
                             params['glare_detection_min_layer'],
                             params['glare_detection_num_layers'])
    wrapper = PostprocessedObject(obj)
    norm_energy = _compute_norm_energy(wrapper, params['atom_counts'])
    contrast_response = _compute_contrast(obj, params['g'], params['exterior_scale'],
                                          params['exterior_offset'],
                                          params['contrast_epsilon'],
                                          params['background_mask'], params['g_std'])
    fg_offset, fg_fragment = _process_mask(obj, params['g_mask_processing'],
                                           params['mask_max_distance'],
                                           params['mask_stdamp'], params['fill_holes'])
    eccentricity = _compute_eccentricity(obj)

    return {
        'norm_energy': norm_energy,
        'contrast_response': contrast_response,
        'fg_offset': fg_offset,
        'fg_fragment': fg_fragment,
        'obj_radius': obj_radius,
        'is_glare': is_glare,
        'eccentricity': eccentricity,
    }
