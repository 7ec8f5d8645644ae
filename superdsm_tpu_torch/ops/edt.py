"""Euclidean distance transforms.

The reference leans on ``scipy.ndimage.distance_transform_edt`` throughout
(background margins ``superdsm/objects.py:127``, cluster
watershed ``superdsm/c2freganal.py:144``, contrast weights).
The host path keeps scipy (exact, fast) behind a native pass.
"""

import numpy as np
import scipy.ndimage as ndi


def edt(mask):
    """Distance of each True pixel to the nearest False pixel.

    Native Felzenszwalb-Huttenlocher pass (scipy-identical: same exact
    integer squared distances, same double sqrt — parity-tested in
    ``tests/test_ops.py``), falling back to scipy. The native call releases
    the GIL, so the threaded c2f cluster workers actually overlap their
    EDT work.

    Few-source fast path: the c2f split loop calls ``edt(~seed)`` once per
    candidate seed, and seeds are tiny local-maximum components (usually a
    single pixel). With <= 8 source pixels the distance map is the min over
    per-source point distances — computed on exact integer squared
    distances with one final double sqrt, which is BIT-identical to the
    Felzenszwalb/scipy result (sqrt is monotone and correctly rounded) at
    ~10x less work than a full two-pass transform."""
    mask = np.asarray(mask, bool)
    if mask.ndim == 2 and mask.any() and not mask.all():
        n_src = mask.size - np.count_nonzero(mask)
        if n_src <= 8:
            src = np.argwhere(~mask)
            rr = np.arange(mask.shape[0], dtype=np.int64)[:, None]
            cc = np.arange(mask.shape[1], dtype=np.int64)[None, :]
            d2 = (rr - src[0, 0]) ** 2 + (cc - src[0, 1]) ** 2
            for r, c in src[1:]:
                np.minimum(d2, (rr - r) ** 2 + (cc - c) ** 2, out=d2)
            return np.sqrt(d2, dtype=np.float64)
        from ..native import edt_native
        out = edt_native(mask)
        if out is not None:
            return out
    return ndi.distance_transform_edt(mask)


