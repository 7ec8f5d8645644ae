"""NIH3T3-like fields: nuclei as in :mod:`fields`, plus a background
illumination gradient and small saturated autofluorescence glare spots.

A frozen rewrite of the repository's glare field generator (a gradient of
up to ``gradient`` across the columns; spots with a steep, clipped profile
of height ``glare_amplitude``), each spot on a local patch.
"""

import numpy as np

from portbench.gen import fields


def make(seed, index, p):
    """One field: ``(image float32 (H, W), planted nuclei (n, 3))``.
    ``p`` holds what :func:`fields.make` reads, and ``gradient``,
    ``glare_spots``, ``glare_radius`` (range) and ``glare_amplitude``."""
    rng = fields._rng(seed, index)
    H, W = p['height'], p['width']
    g = np.zeros((H, W), np.float64)
    centers = fields.place_centers(rng, H, W, p['nuclei'], p['radius'], p['min_separation'])
    planted = fields.draw_nuclei(g, rng, centers, p)
    g += rng.standard_normal((H, W)) * p['noise']
    g += p['gradient'] * (np.arange(W)[None, :] / float(W))
    spots = fields._rng(seed, index, salt=1)
    for _ in range(p['glare_spots']):
        r0 = spots.integers(10, H - 10)
        c0 = spots.integers(10, W - 10)
        srad = spots.uniform(*p['glare_radius'])
        half = int(np.ceil(5 * srad)) + 1
        r_lo, r_hi = max(r0 - half, 0), min(r0 + half + 1, H)
        c_lo, c_hi = max(c0 - half, 0), min(c0 + half + 1, W)
        rr = np.arange(r_lo, r_hi)[:, None] - r0
        cc = np.arange(c_lo, c_hi)[None, :] - c0
        spot = np.exp(-(rr ** 2 + cc ** 2) / (2 * srad ** 2))
        g[r_lo:r_hi, c_lo:c_hi] += p['glare_amplitude'] * np.minimum(spot * 1.5, 1.0)
    return g.astype(np.float32), planted
