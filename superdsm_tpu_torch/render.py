"""Label maps of a segmentation result.

The rasterization half of :mod:`superdsm_tpu.render` (the image renderers
are not ported yet): the objects' foreground masks become one unique-label
map (cf. the reference's ``superdsm/render.py:388-451``).
"""

import numpy as np

from ._aux import render_objects_foregrounds
from .ops.morphology import disk as _disk_footprint
from .ops.morphology import binary_dilation, binary_erosion
from .ops.watershed import watershed


def rasterize_objects(data, objects, dilate=0):
    """Yields the full-frame segmentation mask of each object."""
    if isinstance(objects, str):
        objects = [c for c in data[objects]]

    for foreground in render_objects_foregrounds(data['g_raw'].shape, objects):
        if dilate > 0:
            foreground = binary_dilation(foreground, _disk_footprint(dilate))
        elif dilate < 0:
            foreground = binary_erosion(foreground, _disk_footprint(-dilate))
        if foreground.any():
            yield foreground.copy()


def rasterize_labels(data, objects='postprocessed_objects',
                     merge_overlap_threshold=np.inf, dilate=0, background_label=0):
    """Unique-label map of the segmentation masks: merge above-threshold
    overlaps, resolve remaining overlaps by EDT watershed, then fix exactly
    coincident objects (cf. ``superdsm/render.py:388-451``)."""
    assert background_label <= 0
    objects = [obj for obj in rasterize_objects(data, objects, dilate)]

    # determine which objects overlap sufficiently
    merge_list = []
    if merge_overlap_threshold <= 1:
        for i1 in range(len(objects)):
            for i2 in range(i1):
                obj1, obj2 = objects[i1], objects[i2]
                overlap = np.logical_and(obj1, obj2).sum() / (0. + min([obj1.sum(), obj2.sum()]))
                if overlap > merge_overlap_threshold:
                    merge_list.append((i1, i2))

    # associate a (potentially shared) label to each object
    labels = list(range(1, 1 + len(objects)))
    obj_indices_by_label = {label: [idx] for label, idx in zip(labels, range(len(objects)))}
    for merge_idx, merge_data in enumerate(merge_list):
        merge_label0 = len(objects) + 1 + merge_idx
        merge_labels = [labels[idx] for idx in merge_data]
        if merge_labels[0] == merge_labels[1]:
            continue  # can occur due to transitivity
        merge_indices = obj_indices_by_label[merge_labels[0]] + obj_indices_by_label[merge_labels[1]]
        for obj_idx in merge_indices:
            labels[obj_idx] = merge_label0
        obj_indices_by_label[merge_label0] = merge_indices
        for label in merge_labels:
            del obj_indices_by_label[label]

    # merge the rasterized objects and resolve residual overlaps
    objects = [(np.sum([objects[k] for k in group], axis=0) > 0)
               for group in obj_indices_by_label.values()]
    result = np.zeros(data['g_raw'].shape, 'uint16')
    if len(objects) > 0:
        # accumulate counts in place (np.sum over a list stacks n full frames)
        counts = np.zeros(result.shape, np.uint16)
        for obj in objects:
            counts += obj
        overlaps = counts > 1
        for label, obj in enumerate(objects, 1):
            result[obj] = label
        background = (result == 0).copy()
        result[overlaps] = 0
        from .ops.edt import edt as _edt
        dist = _edt(result == 0)
        result = watershed(dist, result.astype(np.int32),
                           mask=np.logical_not(background)).astype('uint16')

    # exactly coincident objects eliminate each other above; restore them
    covered = result > 0
    next_label = int(result.max()) if len(objects) > 0 else 0
    for obj in objects:
        obj_mask = obj & ~covered
        if obj_mask.any():
            next_label += 1
            result[obj_mask] = next_label
            covered |= obj_mask

    result[result == 0] = background_label
    return result
