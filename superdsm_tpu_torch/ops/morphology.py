"""Binary morphology with disk footprints.

Replaces the reference's uses of ``skimage.morphology``
(``binary_dilation/erosion`` with ``disk(r)`` footprints, e.g.
``superdsm/atoms.py:53-62`` and
``superdsm/postprocess.py:153,272,324``). Host path uses
scipy.
"""

import numpy as np
import scipy.ndimage as ndi


def disk(radius):
    """Disk-shaped footprint (same construction as ``skimage.morphology.disk``)."""
    radius = int(radius)
    L = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(L, L)
    return (X ** 2 + Y ** 2 <= radius ** 2).astype(np.uint8)


def binary_dilation(mask, footprint):
    return ndi.binary_dilation(np.asarray(mask, bool), structure=np.asarray(footprint, bool))


def binary_erosion(mask, footprint):
    return ndi.binary_erosion(np.asarray(mask, bool), structure=np.asarray(footprint, bool))


def binary_fill_holes(mask):
    return ndi.binary_fill_holes(np.asarray(mask, bool))


def max_filter3(img, connectivity=8):
    """3x3 maximum filter: the cross footprint (``disk(1)``) for
    ``connectivity=4``, the full square for 8; reflect borders.

    Native GIL-releasing pass (scipy-identical, parity-tested in
    ``tests/test_ops.py``) with a scipy fallback — this is the seed-search
    local-maximum locus of the c2f split loop."""
    img = np.asarray(img)
    if img.ndim == 2:
        from ..native import maxfilt3_native
        out = maxfilt3_native(img, connectivity)
        if out is not None:
            return out if out.dtype == img.dtype else out.astype(img.dtype)
    footprint = disk(1) if connectivity == 4 else np.ones((3, 3), bool)
    return ndi.maximum_filter(img, footprint=footprint)
