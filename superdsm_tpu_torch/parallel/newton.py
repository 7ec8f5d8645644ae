"""Sharded batched Newton solves over a device mesh.

Port of :mod:`superdsm_tpu.parallel.newton`. Problems are split over the
mesh's ``batch`` axis (independent, no communication), and each problem's
pixels over its ``pixel`` axis. In every Newton iteration each pixel shard
computes its local surface, energy, gradient and Gauss-Newton Hessian on its
own device; the shards' sums (the JAX package's ``psum``) are reduced in a
fixed order, in float64, on the row's first device, and the small Newton
system is solved there. The rows run at the same time, each in a thread
of its own; a row whose shards share its card runs its loop as a CUDA
graph replayed a few iterations per convergence read, as the unsharded
solver does (:func:`_newton_row`). The parameters and the step are
copied back to every shard, so all shards of a problem step with the same
parameters. The line search and the scale sweep reduce their candidate
energies the same way.

The local ``g`` and ``H`` come from the port's gram path
(:func:`superdsm_tpu_torch.dsm.gram.fused_grad_hess_batched`, a CUDA
kernel on the card where the shard's ``(P, n)`` serve it, otherwise
:func:`~superdsm_tpu_torch.dsm.gram.grad_hess_plain` with float64 pixel
sums), as in :func:`superdsm_tpu_torch.dsm.solver._solve_batch_impl`:
float32 pixel sums stall the Levenberg-Marquardt loop. The step keeps the
JAX file's LM damping, line search, scale sweep and convergence rule, with
a Cholesky direction at every n, as there. Every sum of a lane goes through
:mod:`superdsm_tpu_torch.dsm.lane`, the direction and the step's guard
through ``lane.newton_direction`` with the system damped here (one
``lane_chol_step`` launch on the card, the Cholesky kernel with the guard
in its epilogue; LAPACK and the guard's plain version on the CPU), and the
rest of the step through
``solver._step_tail`` (the ``lane_step_pick`` and ``lane_step_tail``
kernels), as in the unsharded solver, so a lane's result does not depend
on its batch. The damped system is assembled here op by op: its energy
takes the regularizer's value, and its g no kmask product.

The smooth-matrix rows are per pixel (built from the replicated subsample
points), so ``G`` shards with the pixels and only the ``6 + K`` reductions
cross devices.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .._device import thread_device
from ..dsm import gram, lane, solver
from ..dsm.smooth import build_smooth_matrix
from ..dsm.solver import (_poly_basis, _reg_terms, _bmv, _step_tail, _steps, ARMIJO_C,
                          DEFAULT_MAXITER, DEFAULT_TOL)
from .pipelined import worker_stream

_F32 = torch.float32


def _split(n, parts):
    """Contiguous ``slice`` of each of ``parts`` shares of ``range(n)``."""
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n), parts)])
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


class _Shard:
    """One pixel shard of a row's problems, on its device."""

    def __init__(self, device, Bf, yv, w):
        self.device, self.Bf, self.yv, self.w = device, Bf, yv, w
        B, P, n = Bf.shape
        self.dispatched = gram.serves(n, P)
        self.band = (gram.band_ranges(Bf, w) if self.dispatched and Bf.is_cuda
                     and n in gram.BANDED_N else None)

    def surface(self, params):
        return _bmv(self.Bf, params.to(self.device))

    def contribs(self, params, active):
        """Local surface, data energy, g and H of the shard's pixels."""
        s = self.surface(params)
        data = lane.softplus_energies(s, self.yv, self.w)
        if self.dispatched:
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


def _newton_row(params0, shards, alpha, epsilon, kmask, maxiter, tol):
    """Newton iteration for the problems of one batch row whose pixels are
    split over ``shards``; every reduction and the replicated arithmetic run
    on the first shard's device. Returns ``(params, energy, conv)``.

    The loop runs as ``solver._solve_batch_impl``'s does: where every shard
    lies on the row's home device, which is a card, its first iteration
    runs eagerly, the next is captured as a CUDA graph on this thread's
    stream and replayed :data:`solver.SYNC_EVERY` iterations per read of
    the convergence flags, never past ``maxiter``, the iteration count kept
    on the card. Lanes freeze one by one (the tail's freeze writes keep
    every bit of a converged lane's params, mu and flag), so the iterations
    after the last lane converged change nothing: the result is bitwise
    the loop that reads the flags every iteration. On the CPU the same
    chunks run eagerly; a row whose shards span devices, or one under
    ``solver.eager_loop()``, reads the flags every iteration."""
    home = shards[0].device
    B, n = params0.shape
    dt = params0.dtype
    eye = torch.eye(n, dtype=dt, device=home)
    steps = _steps(dt, home)

    def energy(params):
        data = _reduce([lane.softplus_energies(sh.surface(params), sh.yv, sh.w)
                        for sh in shards], home)
        return data + _reg_terms(params, alpha, epsilon, kmask)[0]

    # the loop state, updated in place by the step's tail
    params = params0.clone()
    conv = torch.zeros(B, dtype=torch.bool, device=home)
    mu = torch.full((B,), 1e-6, dtype=dt, device=home)
    it_lane = torch.zeros(B, dtype=torch.int32, device=home)
    it_dev = torch.zeros((), dtype=torch.int32, device=home)
    freeze = lane.FreezeState(params, None, None, it_lane, it_dev, conv)

    def iteration():
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
        # the direction, its guard, decrement, regularizer candidates and
        # Armijo thresholds (one lane_chol_step launch on the card, the
        # unsharded step's without its damping)
        delta, decrement, reg_cand, armijo_f = lane.newton_direction(
            params, None, alpha, epsilon, kmask, g, H + (mu * scale_h)[:, None, None] * eye,
            steps, f0, ARMIJO_C)

        # line search: one matvec per shard, candidate energies reduced
        us = [sh.surface(delta) for sh in shards]
        data_cand = _reduce([sh.line_search(c[0], u, steps)
                             for sh, c, u in zip(shards, local, us)], home)

        def sweep(t_step, _, scales):
            # the scale sweep of each shard's new surface, candidate
            # energies reduced like the line search's
            return _reduce([sh.scale_sweep(c[0] + t_step.to(sh.device)[:, None] * u, scales)
                            for sh, c, u in zip(shards, local, us)], home)

        # the picks, mu and the convergence test, as dsm.solver's step (one
        # lane_step_pick and one lane_step_tail launch on the card); the
        # freeze writes params, mu, conv and the lanes' iterations in place
        it_dev.add_(1)
        _step_tail(params, mu, f0, delta, decrement, data_cand, reg_cand, armijo_f, alpha,
                   epsilon, kmask, tol, sweep, state=freeze)

    one_device = all(sh.device == home for sh in shards)
    graphed = home.type == 'cuda' and one_device and solver._eager['depth'] == 0
    chunk = solver.SYNC_EVERY if graphed or home.type != 'cuda' else 1
    graph = None
    it = 0
    while it < maxiter and B > 0:
        count = min(chunk, maxiter - it)
        for _ in range(count):
            if graph is not None:
                graph()
                continue
            iteration()
            if graphed:
                graph = solver._Graph(iteration, home)
        it += count
        solver._note(iterations=count, syncs=1)
        if bool(conv.all()):
            break
    solver._note(solves=1)
    return params, energy(params), conv


def _run(mesh, params0, make_shard, alpha, epsilon, kmask, maxiter, tol):
    """Splits the problems over the mesh rows and their pixels over the
    row's devices (``make_shard(rows, cols, device)``), solves each row in a
    thread of its own on that thread's stream of the row's first device
    (the rows' Newton loops each wait on the host at every convergence
    read, so they run at the same time) and returns the rows' results in
    problem order on the mesh's first device."""
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
