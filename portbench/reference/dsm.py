"""Plain reference of SuperDSM's convex region problem, in float64.

A region problem is the energy (TPAMI 2023, eq. 9) of a deformable shape
model over the region's pixels ``p`` with offset intensities ``y_p``:

    psi(theta, xi) = sum_p softplus(-y_p s_p) + alpha (sum_k sqrt(xi_k^2 + eps) - K sqrt(eps)),
    s = Q theta + G xi,

where ``Q`` holds the second-order polynomial basis ``(x1^2, x2^2, 2 x1 x2,
2 x1, 2 x2, 1)`` of the pixel coordinates normalized by the image shape
minus one, and ``G`` the row-normalized Gaussian deformation basis
(sigma = ``smooth_amount``, support ``|dr|, |dc| <= R``) centred at the
region's subsample points. Intensities enter int16-quantized
(``round(y * 32767 / max|y|)``), the configuration's stated input format.

:func:`minimize` finds the minimum by a damped Newton method with a
backtracking line search, in float64 on the given device, and says whether
it converged (a region whose pixels a quadric separates has no minimizer;
its energy only falls as the surface steepens). Plain PyTorch; it imports
nothing of the program under test.
"""

import math

import numpy as np
import torch


def support_radius(smooth_amount, shape_multiplier):
    if not np.isfinite(smooth_amount):
        return 0
    size = int(round(1 + smooth_amount * 4 * shape_multiplier))
    return min(size // 2, int(4 * smooth_amount + 0.5))


def quantized_intensities(yv):
    yv = np.asarray(yv, np.float32)
    scale = float(np.abs(yv).max()) if len(yv) else 1.0
    scale = scale if scale > 0 else 1.0
    with np.errstate(invalid='ignore'):
        q = np.nan_to_num(yv * np.float32(32767.0 / scale), nan=0.0,
                          posinf=32767.0, neginf=-32767.0)
    return np.round(q).astype(np.float64) * (scale / 32767.0)


class Region:
    """The problem's features and data on ``device``, in float64.

    ``pts`` (P, 2) crop-local pixel coordinates, ``offset`` the crop's
    place in the image, ``sub`` (K, 2) crop-local subsample points."""

    def __init__(self, pts, offset, img_shape, yv, sub, alpha, epsilon,
                 smooth_amount, shape_multiplier, device):
        f64 = torch.float64
        pts = torch.as_tensor(np.asarray(pts, np.float64), dtype=f64, device=device)
        denom = torch.as_tensor(np.maximum(np.asarray(img_shape, np.float64) - 1.0, 1.0),
                                dtype=f64, device=device)
        off = torch.as_tensor(np.asarray(offset, np.float64), dtype=f64, device=device)
        x = (pts + off) / denom
        x1, x2 = x[:, 0], x[:, 1]
        cols = [x1 * x1, x2 * x2, 2 * x1 * x2, 2 * x1, 2 * x2, torch.ones_like(x1)]
        self.K = len(sub) if np.isfinite(smooth_amount) else 0
        if self.K:
            s = torch.as_tensor(np.asarray(sub, np.float64), dtype=f64, device=device)
            dr = pts[:, None, 0] - s[None, :, 0]
            dc = pts[:, None, 1] - s[None, :, 1]
            R = support_radius(smooth_amount, shape_multiplier)
            g = torch.exp(-(dr * dr + dc * dc) / (2.0 * smooth_amount ** 2))
            g = torch.where((dr.abs() <= R) & (dc.abs() <= R), g, torch.zeros_like(g))
            g = g / g.sum(dim=1, keepdim=True).clamp_min(1e-300)
            self.Bf = torch.cat([torch.stack(cols, dim=1), g], dim=1)
        else:
            self.Bf = torch.stack(cols, dim=1)
        self.y = torch.as_tensor(quantized_intensities(yv), dtype=f64, device=device)
        self.alpha = float(alpha) if self.K else 0.0
        self.eps = float(epsilon)

    def energy(self, theta):
        s = self.Bf @ theta
        data = torch.nn.functional.softplus(-self.y * s).sum()
        if self.K:
            xi = theta[6:]
            reg = self.alpha * (torch.sqrt(xi * xi + self.eps).sum()
                                - self.K * math.sqrt(self.eps))
            return data + reg.clamp_min(0.0)
        return data

    def grad_hess(self, theta):
        s = self.Bf @ theta
        q = torch.sigmoid(self.y * s)            # softplus(-ys)' = -y (1 - q)
        t = -self.y * (1 - q)
        kappa = self.y * self.y * q * (1 - q)
        g = self.Bf.T @ t
        H = self.Bf.T @ (kappa[:, None] * self.Bf)
        if self.K:
            xi = theta[6:]
            root = torch.sqrt(xi * xi + self.eps)
            g[6:] += self.alpha * xi / root
            H.diagonal()[6:] += self.alpha * self.eps / root ** 3
        return g, H


def has_minimum(region, energy, converged):
    """Whether the region's energy attains its minimum: the Newton method
    converged, and not to the vanishing energy of a region a quadric
    separates (whose infimum lies at infinity)."""
    return bool(converged) and energy > 1e-6 * region.Bf.shape[0]


def minimize(region, maxiter=60, rtol=1e-13):
    """``(min energy, converged, iterations)``: Newton steps from zero until
    half the Newton decrement falls under ``rtol * max(E, 1)``."""
    n = region.Bf.shape[1]
    theta = torch.zeros(n, dtype=torch.float64, device=region.Bf.device)
    E = region.energy(theta)
    eye = torch.eye(n, dtype=torch.float64, device=theta.device)
    for it in range(1, maxiter + 1):
        g, H = region.grad_hess(theta)
        ridge = 1e-14 * float(H.diagonal().abs().max()) + 1e-300
        L, info = torch.linalg.cholesky_ex(H + ridge * eye)
        if int(info):
            d = -torch.linalg.lstsq(H, g[:, None]).solution[:, 0]
        else:
            d = -torch.cholesky_solve(g[:, None], L)[:, 0]
        dec = float(-(g @ d))
        scale = max(abs(float(E)), 1.0)
        if 0 <= dec / 2 <= rtol * scale:
            return float(E), True, it
        step = 1.0
        slope = float(g @ d)
        for _ in range(60):
            E_new = region.energy(theta + step * d)
            if float(E_new) <= float(E) + 1e-4 * step * slope:
                break
            step *= 0.5
        else:
            # no decrease is left to rounding: converged if the decrement is
            # at the float64 floor
            return float(E), dec / 2 <= 1e-10 * scale, it
        theta = theta + step * d
        E = E_new
    return float(E), False, maxiter
