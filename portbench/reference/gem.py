"""Plain reference of SuperDSM's global energy minimization over one cluster.

A cluster is a set of atoms (image regions) and their adjacency. SuperDSM
(TPAMI 2023, eq. 12) segments it by the cover of its atoms with footprints,
each a set of atoms connected in the adjacency graph, that minimizes

    sum over footprints X of the cover (nu(X) + beta),

where ``nu(X)`` is the minimum of the convex region problem of X's region
(:mod:`dsm`). Exact pruning (Algorithm 1) claims this minimum. Here, for
one cluster: :func:`connected_footprints` enumerates every connected
footprint (no seed-distance cap), :func:`footprint_region` builds each
one's region as SuperDSM's objects do, :func:`energies` minimizes each
(:func:`minimize` on a :class:`dsm.Region`), and :func:`cover_optimum`
finds the exact minimum over covers by a dynamic program over subsets of
atoms (up to 12 atoms: 4,095 subsets); :func:`cluster_optimum` does all
of it for one cluster, :func:`cover_cost` prices another cover with the
same energies.

Where this departs from the program's definitions:

- every region is solved from zero in float64 by :func:`minimize`, a
  Levenberg-Marquardt Newton method, until the model's decrease falls
  under ``1e-12 * max(E, 1)`` (at most 500 steps); the undamped Newton
  method of :func:`dsm.minimize` stalls on these regions, whose data term
  a quadric nearly separates (small steps for dozens of iterations, far
  above the minimum). The program solves in float32 from its start (the
  elliptical one, or the parent's solution for a grown footprint) and
  stops at its tolerance, its stall test or its iteration cap of 50;
- the subsample points are the greedy chessboard coverage at the
  configured stride (:func:`subsample_points`); the program widens the
  stride where the points would exceed its largest deformation bucket for
  the region's pixels, and solves a region above its largest pixel bucket
  on a pixel subsample; the reference does neither;
- the background distance is scipy's exact Euclidean distance transform;
- a cover may hold overlapping footprints, as SuperDSM's set cover allows;
- a region with a single pixel of positive offset intensity is noise with
  energy 0, as in SuperDSM's objects; the reference takes it so too;
- a region that the model separates has no minimum (its energy falls
  toward 0 as the surface steepens): the reference marks it, and a
  cluster holding one has no defined optimum (:func:`defined`).

Numpy, scipy and plain PyTorch in float64; it imports nothing of the
program under test.
"""

import numpy as np
import scipy.ndimage as ndi
import torch

from portbench.reference import dsm

#: How far above the exhaustive optimum a program's cover may cost, as a
#: share of the optimum, each footprint's energy the reference's. The
#: program's energies are float32 solves ended by the Newton loop's
#: tolerance, stall test or iteration cap, which leave a footprint up to
#: about 2% above its float64 minimum on the gowt1 colony fields; the greedy set
#: cover with its merge step (Algorithm 2, not exact) may then settle on a
#: cover that is cheaper by the program's energies and dearer by the
#: reference's within that margin.
TOLERANCE = 0.02


def connected_footprints(labels, adjacency):
    """Every non-empty set of ``labels`` that is connected in
    ``adjacency`` (label -> set of adjacent labels), as frozensets: grown
    one adjacent atom at a time from each single atom."""
    labels = set(labels)
    seen = {frozenset([a]) for a in labels}
    frontier = list(seen)
    while frontier:
        grown = []
        for fp in frontier:
            for a in set().union(*(adjacency[b] for b in fp)) & labels - fp:
                new = fp | {a}
                if new not in seen:
                    seen.add(new)
                    grown.append(new)
        frontier = grown
    return sorted(seen, key=lambda fp: (len(fp), sorted(fp)))


def subsample_points(mask, stride):
    """The deformation's subsample points of a region's crop mask: the
    regular ``stride`` grid inside the mask, then, while a pixel of the
    mask lies ``stride`` or more (chessboard) from every point, the first
    such pixel (row-major) at the least such distance is added.
    ``(K, 2)`` crop-local coordinates, row-major."""
    mask = np.asarray(mask, bool)
    grid = np.zeros_like(mask)
    grid[::stride, ::stride] = True
    grid &= mask
    if grid.any():
        dist = ndi.distance_transform_cdt(~grid, metric='chessboard').astype(np.int64)
    else:
        dist = np.full(mask.shape, np.iinfo(np.int64).max)
    dist = np.where(mask, dist, 0)
    rr, cc = np.indices(mask.shape)
    while (dist >= stride).any():
        best = dist[dist >= stride].min()
        r, c = np.argwhere(dist == best)[0]
        grid[r, c] = True
        dist = np.where(mask, np.minimum(dist, np.maximum(abs(rr - r), abs(cc - c))), 0)
    return np.argwhere(grid & mask)


def admissible(y, y_mask, margin):
    """The pixels a region may hold: inside ``y_mask`` and within
    ``margin`` of the foreground (``y > 0``)."""
    return np.asarray(y_mask, bool) & (ndi.distance_transform_edt(np.asarray(y) <= 0) <= margin)


def footprint_region(y, atoms_map, adm, footprint, smooth_amount, shape_multiplier, stride):
    """``(pts, offset, yv, sub)`` of a footprint's region (its atoms inside
    ``adm``) cropped to its bounding box, or None for a region with no
    pixel or a single pixel of positive intensity."""
    mask = np.isin(atoms_map, list(footprint)) & adm
    if not mask.any() or int((np.asarray(y)[mask] > 0).sum()) == 1:
        return None
    rows, cols = np.nonzero(mask)
    r0, r1, c0, c1 = rows.min(), rows.max() + 1, cols.min(), cols.max() + 1
    crop = mask[r0:r1, c0:c1]
    pts = np.argwhere(crop)
    yv = np.asarray(y, np.float32)[r0:r1, c0:c1][crop]
    sub = np.zeros((0, 2), np.int64)
    if np.isfinite(smooth_amount):
        size = int(round(1 + smooth_amount * 4 * shape_multiplier))
        if (np.asarray(crop.shape) > size // 2).all():
            sub = subsample_points(crop, stride)
    return pts, (r0, c0), yv, sub


def minimize(region, maxiter=500, rtol=1e-12):
    """``(min energy, converged, steps)`` of a :class:`dsm.Region` from
    zero: each step solves ``(H + mu diag(H)) d = -g`` and is taken where
    it lowers the energy (then ``mu`` falls by 3 where the decrease is
    three quarters of the model's or more, and doubles where it is under a
    quarter), else ``mu`` grows by 4; converged
    when the quadratic model's decrease ``-g.d - d.H.d / 2`` falls under
    ``rtol * max(E, 1)``, not converged at ``maxiter`` or where no ``mu``
    up to 1e15 lowers the energy."""
    theta = torch.zeros(region.Bf.shape[1], dtype=torch.float64, device=region.Bf.device)
    E, mu = float(region.energy(theta)), 1e-4
    for it in range(1, maxiter + 1):
        g, H = region.grad_hess(theta)
        dg = H.diagonal().clamp_min(1e-12 * float(H.diagonal().max()) + 1e-300)
        while True:
            L, info = torch.linalg.cholesky_ex(H + torch.diag(mu * dg))
            if int(info):
                mu *= 4
                continue
            d = -torch.cholesky_solve(g[:, None], L)[:, 0]
            model = -float(g @ d) - 0.5 * float(d @ (H @ d))
            if model <= rtol * max(abs(E), 1.0):
                return E, True, it
            E_new = float(region.energy(theta + d))
            if E_new < E:
                rho = (E - E_new) / model
                if rho > 0.75:
                    mu = max(mu / 3, 1e-15)
                elif rho < 0.25:
                    mu *= 2
                theta, E = theta + d, E_new
                break
            mu *= 4
            if mu > 1e15:
                return E, False, it
    return E, False, maxiter


def energies(y, y_mask, atoms_map, footprints, settings, device='cpu'):
    """``{footprint: (nu, exists)}``: each footprint's region minimized in
    float64, and whether its minimum exists (:func:`dsm.has_minimum`: the
    method converged, and not to the vanishing energy of a region that a
    quadric with the deformation separates, whose infimum lies at
    infinity). ``settings``: ``alpha``, ``epsilon``, ``smooth_amount``,
    ``gaussian_shape_multiplier``, ``smooth_subsample`` and
    ``background_margin`` of the DSM."""
    s = settings
    adm = admissible(y, y_mask, s['background_margin'])
    # the footprints' atoms lie in one box: crop to it once
    rows, cols = np.nonzero(np.isin(atoms_map, list(set().union(*footprints))))
    box = np.s_[rows.min():rows.max() + 1, cols.min():cols.max() + 1]
    y_box, atoms_box, adm_box = np.asarray(y)[box], np.asarray(atoms_map)[box], adm[box]
    out = {}
    for fp in footprints:
        region = footprint_region(y_box, atoms_box, adm_box, fp, s['smooth_amount'],
                                  s['gaussian_shape_multiplier'], s['smooth_subsample'])
        if region is None:
            out[fp] = (0.0, True)
            continue
        pts, (r0, c0), yv, sub = region
        offset = (r0 + rows.min(), c0 + cols.min())
        reg = dsm.Region(pts, offset, np.shape(y), yv, sub, s['alpha'], s['epsilon'],
                         s['smooth_amount'], s['gaussian_shape_multiplier'], device)
        e, converged, _ = minimize(reg)
        out[fp] = (e, dsm.has_minimum(reg, e, converged))
        del reg
    return out


def cover_optimum(labels, weights):
    """``(cost, cover)``: the least ``sum(weights[X])`` over families of
    footprints (keys of ``weights``) whose union is ``labels``, and one
    family that attains it; by a dynamic program over the subsets of the
    labels (at most 12), each subset's least cover taking a footprint that
    holds its lowest label."""
    labels = sorted(labels)
    if len(labels) > 12:
        raise ValueError(f'{len(labels)} atoms: the exhaustive cover takes at most 12')
    bit = {a: 1 << i for i, a in enumerate(labels)}
    fps = list(weights)
    masks = np.array([sum(bit[a] for a in fp) for fp in fps], np.int64)
    w = np.array([weights[fp] for fp in fps], np.float64)
    full = (1 << len(labels)) - 1
    dp = np.full(full + 1, np.inf)
    pick = np.full(full + 1, -1, np.int64)
    dp[0] = 0.0
    for m in range(1, full + 1):
        sel = np.flatnonzero(masks & (m & -m))
        cost = w[sel] + dp[m & ~masks[sel]]
        k = int(np.argmin(cost))
        dp[m], pick[m] = cost[k], sel[k]
    cover, m = [], full
    while m:
        cover.append(fps[pick[m]])
        m &= ~masks[pick[m]]
    return float(dp[full]), cover


def cluster_optimum(y, y_mask, atoms_map, labels, adjacency, beta, settings, device='cpu'):
    """One cluster's exhaustive optimum: ``(nu, optimum, cover)``, where
    ``nu`` maps every connected footprint to ``(energy, exists)``. The
    optimum is SuperDSM's only where every footprint's minimum exists
    (:func:`defined`)."""
    fps = connected_footprints(labels, adjacency)
    nu = energies(y, y_mask, atoms_map, fps, settings, device)
    optimum, cover = cover_optimum(labels, {fp: nu[fp][0] + beta for fp in fps})
    return nu, optimum, cover


def defined(nu):
    """Whether a cluster's optimum over covers is defined: every
    footprint's energy is a minimum. Where a footprint's region is
    separable, its energy has an infimum of 0 that no parameters attain,
    and what a solver reports for it is where it stopped."""
    return all(exists for _, exists in nu.values())


def cover_cost(nu, cover, beta):
    """The cost of a cover (footprints of one cluster) with the reference's
    energies ``nu``."""
    return sum(nu[frozenset(fp)][0] + beta for fp in cover)


def gap(cost, optimum):
    """A cover's cost above the optimum, relative to the optimum (at
    least 1)."""
    return (cost - optimum) / max(abs(optimum), 1.0)
