#!/usr/bin/env python
"""On the card: the Newton loop's linear algebra and float64 grams as the
port computes them against the libraries' per-lane and batched routes, and
where a Newton iteration's device time goes under each design.

The port computes the Cholesky direction (``solver._cholesky_direction``)
with its own ``lane_cholesky`` kernel, one launch for the batch in an order
fixed by n alone; before that kernel it called cuSOLVER once per lane,
since cuSOLVER's batched routes give a lane other bits than a batch of
one. ``_lsq_init``'s ``solve_ex`` and the float64 products of
``gram.grad_hess_plain`` (the n = 6 c2f gram) and ``_lsq_init`` run once
for the whole batch, a batch of one widened to two. This script:

1. holds ``lane_matvec``'s one-thread-per-row kernel (n <= 32) against the
   warp-per-row one, bitwise, and times both;
2. for each call of the loop, at the n and P the main path gives it and B
   from 2 to 64: whether each route gives every lane the bits of that lane
   alone (widened for a library's batched route), and the bits of the
   cuSOLVER per-lane route; and each route's device ms
   (``chip_smoke._event_ms``; a route a CUDA graph cannot hold is not
   timed);
3. solves the two stall fixtures at B = 1, 2, 4, 16 and bench seed 0 under
   each design (``'kernel'``, the port as it is; ``'per lane'``, cuSOLVER
   per lane; ``'batched'``, cuSOLVER's batched routes with triangular
   solves and the batched float64 gram), with each design's label map, and
   profiles one bench image under each (device loop and eager loop):
   device ms per Newton iteration by kernel family, and s/image in the
   order kernel, per lane, batched, batched, per lane, kernel.

Usage (on a card; prints one ``[routes]`` line per measurement)::

    python tests/data/torch_port/linalg_routes.py
"""

import collections
import contextlib
import os
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def say(msg):
    print(f'[routes] {msg}', flush=True)


def _widen(t):
    return t.expand((2,) + tuple(t.shape[1:])).contiguous()


def per_lane(fn, *args):
    """``fn`` on each lane alone (a batch of one), the outputs concatenated."""
    import torch
    outs = [fn(*(a[b:b + 1] for a in args)) for b in range(args[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def batched(fn, *args):
    """``fn`` on the whole batch, a batch of one widened to two."""
    if args[0].shape[0] != 1:
        return fn(*args)
    out = fn(*(_widen(a) for a in args))
    return tuple(o[:1] for o in out) if isinstance(out, tuple) else out[:1]


def _batched_plain(original):
    """``gram.grad_hess_plain`` at the main path's 6 passes as one batched
    float64 product, a batch of one widened to two."""
    import torch
    from superdsm_tpu_torch.dsm import gram

    def plain(Bf, s, yv, w, active=None, passes=6, mirror=False):
        if passes != 6 or mirror or not Bf.is_cuda or Bf.dim() != 3:
            return original(Bf, s, yv, w, active, passes, mirror)
        B = Bf.shape[0]
        term1, kappa = gram._logistic_weights(s, yv, w)
        if B == 1:
            Bf, term1, kappa = _widen(Bf), _widen(term1), _widen(kappa)
        Bd = Bf.double()
        g = (Bd.transpose(-1, -2) @ term1.double()[..., None])[..., 0][:B].float()
        H = ((Bd * kappa.double()[..., None]).transpose(-1, -2) @ Bd)[:B].float()
        if active is not None:
            keep = active != 0
            zero = torch.zeros((), dtype=g.dtype, device=g.device)
            g = torch.where(keep[:, None], g, zero)
            H = torch.where(keep[:, None, None], H, zero)
        return g, H
    return plain


def _cholesky_direction_tri(Hd, g):
    """The Cholesky direction by cuSOLVER with two triangular solves in place
    of ``cholesky_solve``."""
    import torch
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, g[..., None], upper=False)
    delta = -torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]
    return torch.where((info != 0)[:, None],
                       torch.full((), float('nan'), dtype=g.dtype, device=g.device),
                       delta)


@contextlib.contextmanager
def design(name):
    """``'kernel'`` (the port as it is), ``'per lane'`` (the Cholesky
    direction by cuSOLVER per lane) or ``'batched'`` (cuSOLVER's batched
    routes, triangular solves, and the batched float64 gram)."""
    from superdsm_tpu_torch.dsm import gram, solver
    saved = gram.grad_hess_plain, solver._cholesky_direction
    if name == 'per lane':
        solver._cholesky_direction = cs._per_lane_cholesky
    elif name == 'batched':
        gram.grad_hess_plain = _batched_plain(saved[0])
        solver._cholesky_direction = lambda Hd, g: batched(_cholesky_direction_tri, Hd, g)
    try:
        yield
    finally:
        gram.grad_hess_plain, solver._cholesky_direction = saved


def lane_matvec_paths():
    import torch
    from superdsm_tpu_torch.dsm import lane
    rng = np.random.RandomState(7)
    for n in (1, 5, 6, 7, 31, 32):
        A = rng.randn(64, 8192, n).astype(np.float32)
        A[:, ::7] = 0.0
        A[:, ::11] *= 1e-30
        A = torch.tensor(A, device='cuda')
        x = torch.tensor(rng.randn(64, n).astype(np.float32), device='cuda')
        small = lane.matvec_kernel(A, x)
        warp = lane.matvec_kernel(A, x, warp_rows=True)
        same = bool(torch.equal(small.view(torch.int32), warp.view(torch.int32)))
        ms = cs._event_ms(lambda: lane.matvec_kernel(A, x))
        warp_ms = cs._event_ms(lambda: lane.matvec_kernel(A, x, warp_rows=True))
        say(f'lane_matvec (64, 8192, {n}): one thread per row bitwise equal to a '
            f'warp per row: {same}; {ms:.4f} ms against {warp_ms:.4f} ms')


def _spd(rng, B, n, dtype=np.float32):
    M = rng.randn(B, n, n)
    H = M @ M.transpose(0, 2, 1) / n + np.eye(n) * 1e-3
    return H.astype(dtype)


def _calls(rng):
    """Each loop call as ``(name, fn per lane, args maker(B))``."""
    import torch
    from superdsm_tpu_torch.dsm import gram, solver

    def chol(n):
        return lambda B: (torch.tensor(_spd(rng, B, n), device='cuda'),
                          torch.tensor(rng.randn(B, n).astype(np.float32), device='cuda'))

    def gram6(P):
        def make(B):
            Bf = torch.tensor(rng.randn(B, P, 6).astype(np.float32), device='cuda')
            s = torch.tensor(rng.randn(B, P).astype(np.float32), device='cuda')
            yv = torch.tensor(np.sign(rng.randn(B, P)).astype(np.float32), device='cuda')
            w = torch.tensor((rng.rand(B, P) < 0.9).astype(np.float32), device='cuda')
            return Bf, s, yv, w
        return make

    def solve6(B):
        return (torch.tensor(_spd(rng, B, 6), device='cuda'),
                torch.tensor(rng.randn(B, 6, 1).astype(np.float32), device='cuda'))

    calls = []
    for n in (6, 32, 64, 128, 256):
        calls.append((f'cholesky direction n = {n}', cs._batched_cholesky,
                      _cholesky_direction_tri, chol(n)))
    calls.append(('solve_ex n = 6', lambda A, b: torch.linalg.solve_ex(A, b)[0],
                  None, solve6))
    for P in (2048, 8192, 32768):
        calls.append((f'float64 gram n = 6, P = {P}',
                      lambda *a: gram.grad_hess_plain(*a)[1], None, gram6(P)))
    return calls


def route_invariance():
    import torch
    from superdsm_tpu_torch.dsm import gram, solver
    rng = np.random.RandomState(11)
    plain = gram.grad_hess_plain
    plain_b = _batched_plain(plain)
    for name, fn, fn_tri, make in _calls(rng):
        variants = [('batched', fn)] + ([('batched, triangular solves', fn_tri),
                                         ('lane_cholesky', solver._cholesky_direction)]
                                        if fn_tri else [])
        for vname, vfn in variants:
            route = (lambda f, *a: f(*a)) if vname == 'lane_cholesky' else batched
            rows = []
            for B in (2, 3, 4, 5, 8, 16, 64):
                args = make(B)
                if 'gram' in name:
                    with design('batched'):
                        out = vfn(*args)
                        alone = [vfn(*(a[b:b + 1] for a in args)) for b in range(B)]
                    ref = plain(*args)[1]
                else:
                    out = route(vfn, *args)
                    alone = [route(vfn, *(a[b:b + 1] for a in args)) for b in range(B)]
                    ref = per_lane(fn, *args)
                inv = all(torch.equal(out[b:b + 1], alone[b]) for b in range(B))
                eq = bool(torch.equal(out, ref))
                rows.append((B, inv, eq))
            args = make(64)
            try:
                times = _times(name, fn, vfn, args, route, plain, plain_b)
            except RuntimeError as e:  # a batched route that a graph cannot hold
                times = f'not timed: {str(e)[:200]}'
            say(f'{name}, {vname}: (B, every lane bitwise its widened self, bitwise '
                f'the per-lane design) {rows}; {times}')


def _times(name, fn, vfn, args, route, plain, plain_b):
    if 'gram' in name:
        ms_lane = cs._event_ms(lambda: plain(*args))
        ms_b = cs._event_ms(lambda: plain_b(*args))
        ms_b1 = cs._event_ms(lambda: plain_b(*(a[:1] for a in args)))
        ms_l1 = cs._event_ms(lambda: plain(*(a[:1] for a in args)))
    else:
        ms_lane = cs._event_ms(lambda: per_lane(fn, *args))
        ms_b = cs._event_ms(lambda: route(vfn, *args))
        ms_b1 = cs._event_ms(lambda: route(vfn, *(a[:1] for a in args)))
        ms_l1 = cs._event_ms(lambda: per_lane(fn, *(a[:1] for a in args)))
    return (f'B = 64: per lane {ms_lane:.4f} ms, this route {ms_b:.4f} ms; '
            f'B = 1: per lane {ms_l1:.4f} ms, this route {ms_b1:.4f} ms')


def profile_split(tag, image, eager):
    """One bench image profiled: device ms per Newton iteration by kernel
    family, and the top kernels."""
    from superdsm_tpu_torch.dsm import solver
    solver.reset_loop_stats()
    ctx = solver.eager_loop() if eager else contextlib.nullcontext()
    with ctx:
        (_, seg, _, _, seconds), counts = cs._profiled(lambda: cs._segment(image, 12))
    iters = max(solver.LOOP_STATS['iterations'], 1)
    families = cs._family_split(counts['spans'], iters)
    names = collections.Counter()
    for name, a, b in counts['spans']:
        names[name[:90]] += (b - a) / 1e3
    say(f'{tag}: wall {seconds:.3f} s, busy {counts["busy_ms"]:.1f} ms, '
        f'{iters} Newton iterations, {sum(t for _, t, _ in families):.4f} ms of '
        f'kernels per iteration; per iteration by family (ms, launches): '
        + ', '.join(f'{f} {t:.4f} ({c:.1f})' for f, t, c in families))
    say(f'{tag}: top kernels (ms per image): '
        + '; '.join(f'{n} {ms:.2f}' for n, ms in names.most_common(12)))
    return seg


def fixtures_and_images():
    image = cs.make_image(0)[0]
    segs = {}
    for name in ('kernel', 'per lane', 'batched'):
        try:
            segs[name] = _design_runs(name, image)
        except Exception as e:  # noqa: BLE001 - report and go on to the next
            say(f'{name}: failed: {type(e).__name__}: {str(e)[:400]}')
            return
    say('bench seed 0 label maps of the per-lane and batched designs bitwise '
        f'equal to the kernel\'s: {bool(np.array_equal(segs["per lane"], segs["kernel"]))}, '
        f'{bool(np.array_equal(segs["batched"], segs["kernel"]))}')
    times = collections.defaultdict(list)
    for name in ('kernel', 'per lane', 'batched', 'batched', 'per lane', 'kernel'):
        with design(name):
            for seed in range(4):
                times[name].append(round(cs._segment(cs.make_image(seed)[0], 12)[4], 3))
    say(f'seconds per image, bench seeds 0-3, in the order kernel, per lane, '
        f'batched, batched, per lane, kernel: {dict(times)}')


def _design_runs(name, image):
    from superdsm_tpu_torch.dsm import batching
    if True:
        with design(name):
            for fx, path in cs.STALL_FIXTURES.items():
                kw, problem = cs._fixture(path)
                res = {B: batching.solve_problems([problem] * B, **kw)
                       for B in cs.FIXTURE_BATCHES}
                ref = res[1][0]
                same = all(np.array_equal(r.params, ref.params) and r.energy == ref.energy
                           for rs in res.values() for r in rs)
                say(f'{name}: {fx} fixture energy {ref.energy!r} at B = 1; every lane '
                    f'at B = {cs.FIXTURE_BATCHES} bitwise equal: {same}')
            cs._segment(image, 12)  # warm
            seg = profile_split(f'{name}, device loop, bench seed 0', image, False)
            profile_split(f'{name}, eager loop, bench seed 0', image, True)
    return seg


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('linalg_routes.py needs a CUDA card')
    import superdsm_tpu_torch as T
    T.set_device('cuda')
    os.system('nvidia-smi --query-gpu=name,power.limit --format=csv,noheader')
    lane_matvec_paths()
    route_invariance()
    fixtures_and_images()


if __name__ == '__main__':
    main()
