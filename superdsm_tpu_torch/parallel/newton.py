"""Sharded batched Newton solves over a device mesh.

Port of :mod:`superdsm_tpu.parallel.newton`. Problems are split over the
mesh's ``batch`` axis (independent, no communication), and each problem's
pixels over its ``pixel`` axis. In every Newton iteration each pixel shard
computes its local surface, energy, gradient and Gauss-Newton Hessian on its
own device; the shards' sums (the JAX package's ``psum``) are reduced in a
fixed order, in float64, on the row's first device, and the small Newton
system is solved there. The rows run at the same time, each in a thread
of its own. The parameters and the step are copied back to
every shard, so all shards of a problem step with the same parameters. The
line search and the scale sweep reduce their candidate energies the same
way.

The local ``g`` and ``H`` come from the port's gram path
(:func:`superdsm_tpu_torch.dsm.gram.fused_grad_hess_batched`, the float32
CUDA kernel on the card where the shard's ``(P, n)`` serve it, otherwise
:func:`~superdsm_tpu_torch.dsm.gram.grad_hess_plain` with float64 pixel
sums), as in :func:`superdsm_tpu_torch.dsm.solver._solve_batch_impl`:
float32 pixel sums stall the Levenberg-Marquardt loop. The step keeps the
JAX file's LM damping, line search, scale sweep and convergence rule, with
a Cholesky direction at every n, as there. Every sum of a lane goes through
:mod:`superdsm_tpu_torch.dsm.lane` and the direction through
``solver._cholesky_direction`` (the ``lane_cholesky`` kernel on the card,
LAPACK on the CPU), as in the unsharded solver, so a lane's result does not
depend on its batch.

The smooth-matrix rows are per pixel (built from the replicated subsample
points), so ``G`` shards with the pixels and only the ``6 + K`` reductions
cross devices.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._device import thread_device
from ..dsm import gram, lane
from ..dsm.smooth import build_smooth_matrix
from ..dsm.solver import (_cholesky_direction, _poly_basis, _reg_terms, _bmv,
                          LS_STEPS, ARMIJO_C, DEFAULT_MAXITER, DEFAULT_TOL, MU_MIN,
                          MU_MAX)
from .pipelined import worker_stream

_F32 = torch.float32
_SCALES = (0.7, 1.0, 1.4, 2.0, 3.0, 4.5, 6.5, 9.0)


def _split(n, parts):
    """Contiguous ``slice`` of each of ``parts`` shares of ``range(n)``."""
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n), parts)])
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


class _Shard:
    """One pixel shard of a row's problems, on its device."""

    def __init__(self, device, Bf, yv, w):
        self.device, self.Bf, self.yv, self.w = device, Bf, yv, w
        B, P, n = Bf.shape
        self.use_kernel = n % 128 == 0 and P % 256 == 0
        self.band = (gram.band_ranges(Bf, w) if self.use_kernel and Bf.is_cuda
                     and n in gram.BANDED_N else None)

    def surface(self, params):
        return _bmv(self.Bf, params.to(self.device))

    def contribs(self, params, active):
        """Local surface, data energy, g and H of the shard's pixels."""
        s = self.surface(params)
        data = lane.softplus_energies(s, self.yv, self.w)
        if self.use_kernel:
            g, H = gram.fused_grad_hess_batched(
                self.Bf, s, self.yv, self.w, active=active.to(self.device),
                band=self.band)
        else:
            g, H = gram.grad_hess_plain(self.Bf, s, self.yv, self.w,
                                        passes=gram.GRAM_PASSES)
        return s, data, g, H

    def line_search(self, s, u, steps):
        """Data energies of the line search's surfaces ``s + u * steps_k``."""
        return lane.softplus_energies(s, self.yv, self.w, steps.to(self.device), u)

    def scale_sweep(self, s, scales):
        """Data energies of the scale sweep's surfaces ``s * scales_k``."""
        return lane.softplus_energies(s, self.yv, self.w, scales.to(self.device))


def _reduce(parts, home):
    """The shards' partial sums added in shard order, in float64, on
    ``home``; rounded to float32 once."""
    total = parts[0].to(home, torch.float64)
    for part in parts[1:]:
        total = total + part.to(home, torch.float64)
    return total.to(_F32)


def _reg_value(xi, alpha, epsilon, kmask):
    """The deformation regularizer at candidate ``xi (B, K, S)``."""
    term2 = torch.sqrt(xi * xi + epsilon)
    return (alpha[:, None] * lane.lane_sum(kmask[:, :, None] * (term2 - math.sqrt(epsilon)), 1)
            ).clamp_min(0.0)


def _newton_row(params0, shards, alpha, epsilon, kmask, maxiter, tol):
    """Newton iteration for the problems of one batch row whose pixels are
    split over ``shards``; every reduction and the replicated arithmetic run
    on the first shard's device. Returns ``(params, energy, conv)``."""
    home = shards[0].device
    B, n = params0.shape
    dt = params0.dtype
    eye = torch.eye(n, dtype=dt, device=home)
    steps = 0.5 ** torch.arange(LS_STEPS, dtype=dt, device=home)
    ones = torch.ones((), dtype=dt, device=home)
    scales = torch.tensor(_SCALES, dtype=dt, device=home)

    def energy(params):
        data = _reduce([lane.softplus_energies(sh.surface(params), sh.yv, sh.w)
                        for sh in shards], home)
        return data + _reg_terms(params, alpha, epsilon, kmask)[0]

    params = params0
    conv = torch.zeros(B, dtype=torch.bool, device=home)
    mu = torch.full((B,), 1e-6, dtype=dt, device=home)
    it = 0
    while it < maxiter and not bool(conv.all()):
        active = (~conv).to(torch.int32)
        local = [sh.contribs(params, active) for sh in shards]
        f0 = _reduce([c[1] for c in local], home)
        g = _reduce([c[2] for c in local], home)
        H = _reduce([c[3] for c in local], home)
        reg, reg_g, reg_h = _reg_terms(params, alpha, epsilon, kmask)
        f0 = f0 + reg
        g = g + reg_g
        H = H + torch.diag_embed(reg_h)

        # adaptive LM damping, mirroring dsm.solver._newton_step
        scale_h = lane.lane_sum(torch.diagonal(H, dim1=-2, dim2=-1)) / n + 1e-12
        delta = _cholesky_direction(H + (mu * scale_h)[:, None, None] * eye, g)
        bad = ~torch.isfinite(delta).all(dim=1)
        delta = torch.where(bad[:, None],
                            -g / (torch.sqrt(lane.lane_dot(g, g)) + 1.0)[:, None], delta)
        decrement = -lane.lane_dot(g, delta)

        # line search: one matvec per shard, candidate energies reduced
        us = [sh.surface(delta) for sh in shards]
        data_cand = _reduce([sh.line_search(c[0], u, steps)
                             for sh, c, u in zip(shards, local, us)], home)
        if n > 6:
            xi_c = params[:, 6:, None] + delta[:, 6:, None] * steps
            f_cand = data_cand + _reg_value(xi_c, alpha, epsilon, kmask)
        else:
            f_cand = data_cand
        armijo = f_cand <= f0[:, None] - ARMIJO_C * steps * decrement[:, None]
        pick = torch.where(armijo.any(dim=1), armijo.to(torch.int32).argmax(dim=1),
                           torch.argmin(f_cand, dim=1))
        f_pick = f_cand.gather(1, pick[:, None])[:, 0]
        improved = f_pick < f0
        t_step = torch.where(improved, steps[pick], torch.zeros((), dtype=dt, device=home))
        full_step = improved & (pick == 0)
        new_params = params + t_step[:, None] * delta
        new_f = torch.where(improved, f_pick, f0)

        # multiplicative scale sweep (dsm.solver._newton_step) of each
        # shard's new surface, candidate energies reduced like the line
        # search
        data_sc = _reduce([sh.scale_sweep(c[0] + t_step.to(sh.device)[:, None] * u, scales)
                           for sh, c, u in zip(shards, local, us)], home)
        if n > 6:
            f_sc = data_sc + _reg_value(new_params[:, 6:, None] * scales,
                                        alpha, epsilon, kmask)
        else:
            f_sc = data_sc
        pick_sc = torch.argmin(f_sc, dim=1)
        f_sc_pick = f_sc.gather(1, pick_sc[:, None])[:, 0]
        boost = (f_sc_pick < new_f) & torch.isfinite(f_sc_pick)
        new_params = new_params * torch.where(boost, scales[pick_sc], ones)[:, None]
        new_f = torch.where(boost, f_sc_pick, new_f)

        new_mu = torch.where(full_step, (mu * 0.25).clamp_min(MU_MIN),
                             torch.where(improved, mu, (mu * 8.0).clamp_max(MU_MAX)))
        tiny_gain = (f0 - new_f) <= tol * (1.0 + f0.abs())
        new_conv = (((0.5 * decrement <= tol * (1.0 + f0.abs())) & (mu <= 1e-4)
                     & tiny_gain) | ((~improved) & (mu >= MU_MAX) & tiny_gain))
        params = torch.where(conv[:, None], params, new_params)
        mu = torch.where(conv, mu, new_mu)
        conv = conv | new_conv
        it += 1
    return params, energy(params), conv


def _run(mesh, params0, make_shard, alpha, epsilon, kmask, maxiter, tol):
    """Splits the problems over the mesh rows and their pixels over the
    row's devices (``make_shard(rows, cols, device)``), solves each row in a
    thread of its own on that thread's stream of the row's first device
    (the rows' Newton loops each wait on the host every iteration, so they
    run at the same time) and returns the rows' results in problem order on
    the mesh's first device."""
    n_batch, n_pixel = mesh.devices.shape
    B, P = params0.shape[0], make_shard.n_pixels

    def row(i, rows):
        devs = mesh.devices[i]
        home = devs[0]
        with thread_device(home), worker_stream() as stream:
            shards = [make_shard(rows, cols, dev)
                      for cols, dev in zip(_split(P, n_pixel), devs)]
            result = _newton_row(
                torch.as_tensor(params0[rows]).to(home, _F32), shards,
                torch.as_tensor(alpha[rows]).to(home, _F32), float(epsilon),
                torch.as_tensor(kmask[rows]).to(home, _F32), int(maxiter), float(tol))
            if stream is not None:
                stream.synchronize()  # read below on the caller's stream
        return result

    with ThreadPoolExecutor(max_workers=n_batch) as pool:
        out = list(pool.map(row, range(n_batch), _split(B, n_batch)))
    for t in (t for r in out for t in r if t.is_cuda):
        # freed after the caller's stream has read them, not before
        t.record_stream(torch.cuda.current_stream(t.device))
    first = mesh.devices[0, 0]
    return tuple(torch.cat([r[k].to(first) for r in out]) for k in range(3))


class _ShardMaker:
    """Builds a row's pixel shard on its device from numpy inputs."""

    def __init__(self, coords, yv, w, pix=None, sub=None, kmask=None,
                 sigma=None, cutoff=None):
        self.coords, self.yv, self.w = (np.asarray(a, np.float32) for a in (coords, yv, w))
        self.pix, self.sub, self.kmask = pix, sub, kmask
        self.sigma, self.cutoff = sigma, cutoff
        self.n_pixels = self.yv.shape[1]

    def __call__(self, rows, cols, device):
        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device, _F32)
        Bf = _poly_basis(put(self.coords[rows, cols]))
        if self.pix is not None:
            G = build_smooth_matrix(put(self.pix[rows, cols]), put(self.sub[rows]),
                                    self.sigma, self.cutoff, put(self.kmask[rows]))
            Bf = torch.cat([Bf, G], dim=-1).contiguous()
        return _Shard(device, Bf, put(self.yv[rows, cols]), put(self.w[rows, cols]))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_sharded_poly_solver(mesh, maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL):
    """Returns a solver of 6-parameter problems sharded over ``mesh``.

    Input shapes: ``params0 (B, 6)``, ``coords (B, P, 2)``, ``yv (B, P)``,
    ``w (B, P)`` (numpy arrays or tensors); ``B`` is split over the mesh
    'batch' axis and ``P`` over the 'pixel' axis. Returns ``(params,
    energy, converged)`` tensors on the mesh's first device.
    """

    def solve(params0, coords, yv, w):
        params0 = _host(params0)
        B = params0.shape[0]
        return _run(mesh, params0, _ShardMaker(_host(coords), _host(yv), _host(w)),
                    np.zeros(B, np.float32), 1.0, np.zeros((B, 0), np.float32),
                    maxiter, tol)

    return solve


def make_sharded_dsm_solver(mesh, sigma, cutoff, epsilon=1.0,
                            maxiter=DEFAULT_MAXITER, tol=DEFAULT_TOL):
    """Returns a solver of full DSM problems sharded over ``mesh``.

    Pixel coordinates ``pix (B, P, 2)`` shard with the pixels; the subsample
    points ``sub (B, K, 2)`` and deformation mask ``kmask (B, K)`` are
    replicated along the pixel axis, so each shard builds exactly the rows of
    the smooth matrix it owns. Call as ``solve(params0, coords, pix, sub,
    kmask, yv, w, alpha)``; returns ``(params, energy, converged)``.
    """

    def solve(params0, coords, pix, sub, kmask, yv, w, alpha):
        kmask = _host(kmask).astype(np.float32)
        maker = _ShardMaker(_host(coords), _host(yv), _host(w), pix=_host(pix),
                            sub=_host(sub), kmask=kmask, sigma=float(sigma),
                            cutoff=int(cutoff))
        return _run(mesh, _host(params0), maker, _host(alpha).astype(np.float32),
                    epsilon, kmask, maxiter, tol)

    return solve
