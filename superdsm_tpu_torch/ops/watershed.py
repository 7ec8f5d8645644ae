"""Marker-based watershed segmentation.

Functional counterpart of ``skimage.segmentation.watershed`` as used by the
reference (cluster extraction and splitting,
``superdsm/c2freganal.py:32-38,144``, and label
rasterization, ``superdsm/render.py:388-451``). Implemented
as a native C++ priority flood (see ``superdsm_tpu/native/watershed.cpp``)
with a pure-Python heap fallback.
"""

import heapq

import numpy as np

from ..native import watershed_native


def watershed(image, markers, mask=None, connectivity=4):
    """Floods ``image`` from ``markers``, lowest intensities first.

    :param image: 2D array; lower values are flooded first.
    :param markers: 2D int array of seed labels (>0), 0 elsewhere.
    :param mask: Optional boolean array restricting the flood.
    :param connectivity: 4 or 8.
    :return: 2D int32 label array (0 where unreached).
    """
    image = np.asarray(image)
    markers = np.asarray(markers)
    assert image.shape == markers.shape and image.ndim == 2
    out = watershed_native(image, markers, mask, connectivity)
    if out is not None:
        return out
    return _watershed_py(image, markers, mask, connectivity)


def _watershed_py(image, markers, mask, connectivity):
    H, W = image.shape
    image = np.ascontiguousarray(image, dtype=np.float32)
    out = np.asarray(markers, dtype=np.int32).copy()
    if mask is None:
        mask = np.ones((H, W), bool)
    else:
        mask = np.asarray(mask, bool)
    if connectivity == 8:
        neigh = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)]
    else:
        neigh = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    heap = []
    age = 0
    queued = (out > 0)
    rs, cs = np.nonzero((out > 0) & mask)
    for r, c in zip(rs.tolist(), cs.tolist()):
        heapq.heappush(heap, (float(image[r, c]), age, r, c))
        age += 1
    while heap:
        _, _, r, c = heapq.heappop(heap)
        label = out[r, c]
        for dr, dc in neigh:
            rr, cc = r + dr, c + dc
            if rr < 0 or rr >= H or cc < 0 or cc >= W:
                continue
            if queued[rr, cc] or not mask[rr, cc]:
                continue
            out[rr, cc] = label
            queued[rr, cc] = True
            heapq.heappush(heap, (float(image[rr, cc]), age, rr, cc))
            age += 1
    return out
