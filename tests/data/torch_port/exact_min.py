"""The exact minimum of one convex problem's energy, in float64.

Both packages minimize ψ(θ, ξ) = Σ_p softplus(-y_p s_p) + α Σ_k (sqrt(ξ_k² + ε)
- sqrt(ε)), s = Q θ + G ξ, with float32 Newton steps whose systems can be
conditioned far beyond float32's 1/eps (:func:`start_condition`), where a
float32 Cholesky gives directions of no relative accuracy: a solve may stop
far above the minimum, and where it stops moves with the rounding of the
linear-algebra library. This script takes a ``Problem`` of either package (``pts``,
``offset``, ``img_shape``, ``yv``, ``sub``) and minimizes the same energy in
float64 by Newton's method with a backtracking line search, over a
centered, scaled polynomial basis (the same space of quadratic surfaces,
better conditioned), to a gradient norm below 1e-9 of the energy (or
1e-6, where float64 finds no lower point): the yardstick that says
which package's solution is the minimum's.

The intensities are int16-quantized as the solvers quantize them
(``yq * yscale / 32767``); the smooth matrix G is the JAX package's
host mirror (``batching._host_energy_fg``): a truncated Gaussian of each
pixel's offset to each subsample point, rows normalized to sum 1.

Usage (as a module)::

    from tests.data.torch_port.exact_min import exact_minimum, energy
    e_min = exact_minimum(problem, alpha, epsilon, smooth_amount, cutoff)
"""

import numpy as np


def _quantized(yv):
    scale = float(np.abs(yv).max()) if len(yv) else 1.0
    scale = scale if scale > 0 else 1.0
    return np.round(np.asarray(yv, np.float64) / scale * 32767.0) * (scale / 32767.0)


def _basis(problem, smooth_amount, cutoff, centered):
    """The feature matrix [poly | G] (P, 6 + K) in float64."""
    pts = np.asarray(problem.pts, np.float64)
    denom = np.maximum(np.asarray(problem.img_shape, np.float64) - 1.0, 1.0)
    x = (pts + np.asarray(problem.offset, np.float64)) / denom
    if centered:
        x = (x - x.mean(axis=0)) / np.maximum(x.std(axis=0), 1e-12)
    x1, x2 = x[:, 0], x[:, 1]
    Q = np.stack([x1 * x1, x2 * x2, 2 * x1 * x2, 2 * x1, 2 * x2, np.ones_like(x1)], axis=1)
    sub = np.asarray(problem.sub, np.float64).reshape(-1, 2)
    if len(sub) == 0 or not np.isfinite(smooth_amount):
        return Q
    dr = pts[:, None, 0] - sub[None, :, 0]
    dc = pts[:, None, 1] - sub[None, :, 1]
    G = np.exp(-(dr * dr + dc * dc) / (2.0 * smooth_amount ** 2))
    G[(np.abs(dr) > cutoff) | (np.abs(dc) > cutoff)] = 0.0
    G /= np.maximum(G.sum(axis=1, keepdims=True), 1e-30)
    return np.concatenate([Q, G], axis=1)


def _energy(t, Bf, y, alpha, epsilon):
    f = float(np.logaddexp(0.0, -y * (Bf @ t)).sum())
    xi = t[6:]
    return f + alpha * float(np.sum(np.sqrt(xi * xi + epsilon) - np.sqrt(epsilon)))


def _terms(t, Bf, y, alpha, epsilon):
    """Energy, gradient and Hessian at ``t`` (float64)."""
    s = Bf @ t
    a = -y * s
    f = float(np.logaddexp(0.0, a).sum())
    sig = np.exp(a - np.logaddexp(0.0, a))            # sigmoid(-y s)
    g = Bf.T @ (-y * sig)
    kappa = y * y * sig * (1.0 - sig)
    H = (Bf * kappa[:, None]).T @ Bf
    xi = t[6:]
    if len(xi):
        r = np.sqrt(xi * xi + epsilon)
        f += alpha * float(np.sum(r - np.sqrt(epsilon)))
        g[6:] += alpha * xi / r
        H[6:, 6:] += np.diag(alpha * epsilon / r ** 3)
    return f, g, H


def start_condition(problem):
    """Condition number of a six-parameter problem's first Newton system
    (from zero parameters: Qᵀ·diag(y²/4)·Q over the packages' normalized
    coordinates), in float64."""
    Q = _basis(problem, np.inf, 0, centered=False)
    y = _quantized(problem.yv)
    return float(np.linalg.cond((Q * (y * y / 4.0)[:, None]).T @ Q))


def energy(problem, params, alpha, epsilon, smooth_amount, cutoff):
    """ψ at a package's ``params`` (its own basis), in float64."""
    alpha = alpha * getattr(problem, 'alpha_scale', 1.0)
    Bf = _basis(problem, smooth_amount, cutoff, centered=False)
    t = np.zeros(Bf.shape[1])
    params = np.asarray(params, np.float64)
    t[:min(len(params), len(t))] = params[:len(t)]
    return _energy(t, Bf, _quantized(problem.yv), alpha, epsilon)


def exact_minimum(problem, alpha=0.0, epsilon=1.0, smooth_amount=np.inf, cutoff=0,
                  gtol=1e-9, maxiter=500):
    """min ψ over the problem's parameters, in float64; raises if Newton
    reaches neither ``gtol`` nor, where float64 makes no more progress
    (no decrease left, or ``maxiter`` spent), a gradient of 1e-6 of the
    energy."""
    alpha = alpha * getattr(problem, 'alpha_scale', 1.0)
    Bf = _basis(problem, smooth_amount, cutoff, centered=True)
    y = _quantized(problem.yv)
    t = np.zeros(Bf.shape[1])
    for _ in range(maxiter):
        f, g, H = _terms(t, Bf, y, alpha, epsilon)
        if np.linalg.norm(g) <= gtol * max(1.0, f):
            return f
        d = -np.linalg.solve(H + 1e-12 * np.trace(H) / len(t) * np.eye(len(t)), g)
        step = 1.0
        while step > 1e-12 and _energy(t + step * d, Bf, y, alpha, epsilon) > f + 1e-4 * step * (g @ d):
            step *= 0.5
        if step <= 1e-12 and np.linalg.norm(g) <= 1e-6 * max(1.0, f):
            return f  # no float64 decrease left, at a gradient that small
        t = t + step * d
    if np.linalg.norm(g) <= 1e-6 * max(1.0, f):
        return f  # float64 stalls short of gtol, at a gradient that small
    raise RuntimeError(f'no convergence: energy {f}, |g| {np.linalg.norm(g)}')
