"""The yardstick's peaks and the gram's work, frozen in the benchmark.

Peaks: NVIDIA's data sheet for one H100 SXM (dense, 700 W): 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM bandwidth. A share of
the roofline is the least time the work could take at these peaks over the
time it took; the card's power limit is reported beside it.

The gram's work is counted from the solves' shapes, not from the launches,
so that it stays the same whatever kernel computes it. Per lane and Newton
iteration, the gradient and Hessian of one lane sum over its own pixels
(not its bucket's): at pixel ``p`` the feature row has ``m_p = 6 + k_p``
entries that are not zero by construction, where ``k_p`` counts the
subsample points within the deformation kernel's support (``|dr|, |dc| <=
R``) of the pixel. The Hessian is symmetric, so a pixel needs ``m_p (m_p +
1) / 2`` products of two operations each, and the gradient ``m_p``
multiply-adds. Bytes: each non-zero feature entry (4 bytes) and the pixel's
surface, intensity and weight (12 bytes) read once; g and the Hessian's
triangle written once per lane iteration.
"""

import numpy as np

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def support_radius(smooth_amount, shape_multiplier):
    """Per-axis support radius R of the deformation kernel (the Gaussian
    point spread of SuperDSM's deformation basis)."""
    if not np.isfinite(smooth_amount):
        return 0
    size = int(round(1 + smooth_amount * 4 * shape_multiplier))
    return min(size // 2, int(4 * smooth_amount + 0.5))


def nonzeros_per_pixel(pts, sub, radius):
    """``m_p - 6``: the subsample points within the support box of each
    pixel, by a summed-area table over the crop."""
    pts = np.asarray(pts, np.int64)
    sub = np.asarray(sub, np.int64)
    if len(sub) == 0:
        return np.zeros(len(pts), np.int64)
    h = int(max(pts[:, 0].max(), sub[:, 0].max())) + 1
    w = int(max(pts[:, 1].max(), sub[:, 1].max())) + 1
    grid = np.zeros((h + 1, w + 1), np.int64)
    np.add.at(grid, (sub[:, 0] + 1, sub[:, 1] + 1), 1)
    sat = grid.cumsum(0).cumsum(1)
    r0 = np.clip(pts[:, 0] - radius, 0, h)
    r1 = np.clip(pts[:, 0] + radius + 1, 0, h)
    c0 = np.clip(pts[:, 1] - radius, 0, w)
    c1 = np.clip(pts[:, 1] + radius + 1, 0, w)
    return sat[r1, c1] - sat[r0, c1] - sat[r1, c0] + sat[r0, c0]


def lane_work(pts, sub, radius):
    """``(operations, bytes)`` of one lane's gram in one Newton iteration."""
    m = 6 + nonzeros_per_pixel(pts, sub, radius)
    n = 6 + len(sub)
    ops = float(np.sum(m * (m + 1) + 2 * m))
    nbytes = 4.0 * float(np.sum(m)) + 12.0 * len(pts) + 4.0 * (n + n * (n + 1) // 2)
    return ops, nbytes


def bound_seconds(ops, nbytes):
    """Least seconds at the peaks, and what bounds them."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def gram_work(lanes):
    """Total ``(operations, bytes)`` of the deformable-model lanes' gram:
    each lane's work (:func:`lane_work`) times its iterations. ``lanes``:
    ``(problem, support radius, iterations)``."""
    ops = nbytes = 0.0
    for p, radius, iters in lanes:
        if iters <= 0:
            continue
        o, b = lane_work(p.pts, p.sub, radius)
        ops += o * iters
        nbytes += b * iters
    return ops, nbytes
