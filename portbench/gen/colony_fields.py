"""Colony fields at GOWT1's frame size and nucleus scale: colonies of
touching, textured stem-cell nuclei.

GFP-transfected GOWT1 mouse embryonic stem cells grow in compact colonies:
flat nuclei of one size press against each other inside a colony, the
colonies lie apart, the GFP level varies from nucleus to nucleus, and dark
nucleoli texture each nucleus. Built on :mod:`fields` (its random streams
and its nucleus drawing, left as they are): the nuclei of each colony are
placed one by one, each touching an earlier nucleus of its colony and kept
clear of every other colony; they are drawn by :func:`fields.draw_nuclei`;
then 1 to 3 nucleoli darken each nucleus, as deep as the configuration
says (``gowt1``'s depth is set so that its images pass the global energy
minimization's work guard, and is not measured from GOWT1 frames). Numpy
only; the same (seed, index) gives the same image.
"""

import numpy as np

from portbench.gen import fields


def place_colonies(rng, H, W, p):
    """Centres ``(n, 2)`` of ``p['nuclei']`` nuclei in ``p['colonies']``
    colonies (the first colonies take the remainder). A colony's first
    nucleus lies anywhere; each further one lies ``min_separation`` to
    ``min_separation + 0.3`` radii from a random earlier nucleus of its
    colony and at least ``min_separation`` radii from every one, so that
    nuclei touch. Every centre lies ``border`` radii from the frame, and
    ``colony_gap`` radii from each nucleus of the other colonies. Rejection
    sampling, at most 400 draws a nucleus; a nucleus that finds no place is
    left out (the caller gets the centres placed)."""
    radius, sep, gap = p['radius'], p['min_separation'], p['colony_gap']
    lo = p['border'] * radius
    n, k = p['nuclei'], p['colonies']
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    placed = []  # (colony, row, column)

    def admissible(colony, c):
        if not (lo <= c[0] <= H - 1 - lo and lo <= c[1] <= W - 1 - lo):
            return False
        for j, r0, c0 in placed:
            d = np.hypot(r0 - c[0], c0 - c[1])
            if d < (sep if j == colony else gap) * radius:
                return False
        return True

    for colony, size in enumerate(sizes):
        members = []
        for _ in range(size):
            for _ in range(400):
                if not members:
                    c = np.array([rng.uniform(lo, H - 1 - lo), rng.uniform(lo, W - 1 - lo)])
                else:
                    base = members[rng.integers(len(members))]
                    angle = rng.uniform(0, 2 * np.pi)
                    dist = rng.uniform(sep, sep + 0.3) * radius
                    c = base + dist * np.array([np.sin(angle), np.cos(angle)])
                if admissible(colony, c):
                    members.append(c)
                    placed.append((colony, c[0], c[1]))
                    break
    return np.array([[r0, c0] for _, r0, c0 in placed], float).reshape(-1, 2)


def darken_nucleoli(g, rng, planted, p):
    """Multiplies ``g`` in place, inside each planted nucleus, by ``1 -
    depth`` over 1 to 3 nucleoli: disks of ``nucleolus_radius`` (range,
    in nucleus radii) with a logistic edge of a fifth of their radius,
    centred up to half a radius from the nucleus's centre, of ``depth``
    drawn from ``nucleolus_depth``."""
    H, W = g.shape
    for r0, c0, rad in planted:
        for _ in range(rng.integers(p['nucleoli'][0], p['nucleoli'][1] + 1)):
            angle = rng.uniform(0, 2 * np.pi)
            off = rng.uniform(0, 0.5) * rad
            nr, nc = r0 + off * np.sin(angle), c0 + off * np.cos(angle)
            rn = rng.uniform(*p['nucleolus_radius']) * rad
            depth = rng.uniform(*p['nucleolus_depth'])
            half = int(np.ceil(2 * rn)) + 1
            r_lo, r_hi = max(int(nr) - half, 0), min(int(nr) + half + 1, H)
            c_lo, c_hi = max(int(nc) - half, 0), min(int(nc) + half + 1, W)
            d = np.hypot(np.arange(r_lo, r_hi)[:, None] - nr, np.arange(c_lo, c_hi)[None, :] - nc)
            g[r_lo:r_hi, c_lo:c_hi] *= 1 - depth / (1 + np.exp((d - rn) / (0.2 * rn)))


def make(seed, index, p):
    """One field: ``(image float32 (H, W), planted nuclei (n, 3))``, the
    nuclei as :func:`fields.draw_nuclei` returns them. ``p`` holds what
    :func:`fields.draw_nuclei` reads (``radius``, ``radius_jitter``,
    ``eccentricity``, ``amplitude``, ``profile``, ``profile_width``),
    ``height``, ``width``, ``nuclei``, ``colonies``, ``min_separation``,
    ``colony_gap`` and ``border`` (in radii), ``nucleoli`` (least and most
    a nucleus), ``nucleolus_radius`` and ``nucleolus_depth`` (ranges) and
    ``noise`` (standard deviation)."""
    rng = fields._rng(seed, index)
    H, W = p['height'], p['width']
    g = np.zeros((H, W), np.float64)
    centers = place_colonies(rng, H, W, p)
    planted = fields.draw_nuclei(g, rng, centers, p)
    darken_nucleoli(g, fields._rng(seed, index, salt=2), planted, p)
    g += rng.standard_normal((H, W)) * p['noise']
    return g.astype(np.float32), planted
