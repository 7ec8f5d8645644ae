"""Fluorescence fields of nuclei, some touching, made from a seed.

A frozen rewrite of the repository's bench field generator for the
benchmark: the same pattern (Gaussian-profiled, slightly elliptical nuclei
of jittered radius and brightness, a minimum separation below one diameter
so that touching pairs occur, white noise), at the size and density a
configuration names, with each nucleus drawn on a local patch instead of the
whole frame. Numpy only; the same (seed, index) gives the same image.
"""

import numpy as np


def _rng(seed, index, salt=0):
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, int(index), int(salt)])


def place_centers(rng, H, W, n, radius, min_sep):
    """Up to ``n`` centres at least ``min_sep * radius`` apart, by rejection
    sampling (at most ``40 * n`` draws), ``radius`` from each border."""
    lo = int(np.ceil(radius))
    centers = np.zeros((0, 2))
    limit = (min_sep * radius) ** 2
    for _ in range(40 * n):
        if len(centers) >= n:
            break
        c = np.array([rng.integers(lo, H - lo), rng.integers(lo, W - lo)], float)
        if len(centers) == 0 or ((centers - c) ** 2).sum(axis=1).min() > limit:
            centers = np.vstack([centers, c])
    return centers


def draw_nuclei(g, rng, centers, p):
    """Draws one nucleus per centre into ``g`` in place, each on a local
    patch; returns the planted nuclei, ``(n, 3)``: row, column and radius
    of each. ``profile`` ``gauss`` (the default): a
    Gaussian of standard deviation ``profile_width * radius``, added;
    ``disk``: a disk of the radius with a logistic edge of width
    ``profile_width * radius``, where nuclei overlap the brighter wins."""
    H, W = g.shape
    disk = p.get('profile', 'gauss') == 'disk'
    planted = np.zeros((len(centers), 3))
    for i, (r0, c0) in enumerate(centers):
        rad = p['radius'] * rng.uniform(1 - p['radius_jitter'], 1 + p['radius_jitter'])
        planted[i] = r0, c0, rad
        ecc = rng.uniform(*p['eccentricity'])
        amp = rng.uniform(*p['amplitude'])
        sd = rad * p['profile_width']
        reach = rad + 8 * sd if disk else 4.5 * sd
        half = int(np.ceil(reach * max(ecc, 1 / ecc))) + 1
        r_lo, r_hi = max(int(r0) - half, 0), min(int(r0) + half + 1, H)
        c_lo, c_hi = max(int(c0) - half, 0), min(int(c0) + half + 1, W)
        rr = np.arange(r_lo, r_hi)[:, None] - r0
        cc = np.arange(c_lo, c_hi)[None, :] - c0
        d2 = (rr / ecc) ** 2 + (cc * ecc) ** 2
        patch = g[r_lo:r_hi, c_lo:c_hi]
        if disk:
            np.maximum(patch, amp / (1 + np.exp((np.sqrt(d2) - rad) / sd)), out=patch)
        else:
            patch += amp * np.exp(-d2 / (2 * sd * sd))
    return planted


def make(seed, index, p):
    """One field: ``(image float32 (H, W), planted nuclei (n, 3))``, the
    nuclei as :func:`draw_nuclei` returns them: the truth the label maps
    are judged by.

    ``p`` holds ``height``, ``width``, ``nuclei``, ``radius``,
    ``radius_jitter``, ``min_separation`` (in radii), ``eccentricity`` and
    ``amplitude`` (ranges), ``profile_width`` (standard deviation over
    radius) and ``noise`` (standard deviation)."""
    rng = _rng(seed, index)
    H, W = p['height'], p['width']
    g = np.zeros((H, W), np.float64)
    centers = place_centers(rng, H, W, p['nuclei'], p['radius'], p['min_separation'])
    planted = draw_nuclei(g, rng, centers, p)
    g += rng.standard_normal((H, W)) * p['noise']
    return g.astype(np.float32), planted
