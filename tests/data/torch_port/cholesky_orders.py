#!/usr/bin/env python
"""On the card: the orders of operations that ``lane_cholesky`` could take,
each held against a float64 solve and run through the bench field.

``lane.cholesky_chain`` fixes the kernel's order: a right-looking factor
whose every update ``a - l m`` takes its exact product in float64 and is
rounded to float64, then to float32 (a float32 FMA's bits but in rare
double-rounding cases). This script
compares it, as plain PyTorch chains on the card (each order's bits are
what a kernel of that order gives), with the orders it was chosen over and
with cuSOLVER per lane (the solver's route before the kernel):

- ``rounded apart``: the same right-looking order, each update a product
  and a difference rounded apart, the column scaled by the reciprocal of
  the pivot's square root;
- ``rounded apart, divisions``: the same with divisions;
- ``left-looking dots``: each entry's sum of products in
  ``lane_matvec``'s order (FMA chains and a tree), then subtracted.

For each: the worst and the median lane's relative error against a
float64 solve on ``chip_smoke._chol_systems`` (Newton systems of the bench
chunks with the loop's damping); then bench seeds 0-3 on the eager loop
with that order as the Newton direction: lane iterations, the float64-sum
golden's match, and how many lanes' factorizations fail (NaN) against how
many ``cholesky_ex`` reports failed on the same systems.

Usage (on a card; prints one ``[orders]`` line per measurement)::

    python tests/data/torch_port/cholesky_orders.py
"""

import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

SHAPES = [(16, 256), (64, 128), (32, 256), (2, 256), (64, 32)]


def say(msg):
    print(f'[orders] {msg}', flush=True)


def _nan(g):
    import torch
    return torch.full((), float('nan'), dtype=g.dtype, device=g.device)


def rounded_apart(Hd, g, divide=False):
    """Right-looking, every update a product and a difference rounded apart."""
    import torch
    B, n = g.shape
    a, b = Hd.clone(), g.clone()
    diag = torch.empty_like(g)
    fail = torch.zeros(B, dtype=torch.bool, device=g.device)
    for j in range(n):
        p = a[:, j, j]
        fail = fail | ~(p > 0)
        dj = torch.sqrt(p)
        if divide:
            col, yj = a[:, j + 1:, j] / dj[:, None], b[:, j] / dj
        else:
            rj = torch.reciprocal(dj)
            col, yj = a[:, j + 1:, j] * rj[:, None], b[:, j] * rj
        diag[:, j] = dj
        a[:, j + 1:, j] = col
        b[:, j] = yj
        b[:, j + 1:] = b[:, j + 1:] - col * yj[:, None]
        a[:, j + 1:, j + 1:] = a[:, j + 1:, j + 1:] - col[:, :, None] * col[:, None, :]
    for j in range(n - 1, -1, -1):
        xj = b[:, j] / diag[:, j]
        b[:, j] = xj
        b[:, :j] = b[:, :j] - a[:, j, :j] * xj[:, None]
    return torch.where(fail[:, None], _nan(g), -b)


def left_looking(Hd, g):
    """Each entry's sum of products in ``lane_matvec``'s order, then
    subtracted from it; the substitutions the same way."""
    import torch
    from superdsm_tpu_torch.dsm import lane
    B, n = g.shape
    L = torch.zeros_like(Hd)
    diag, y = torch.empty_like(g), torch.empty_like(g)
    fail = torch.zeros(B, dtype=torch.bool, device=g.device)
    for j in range(n):
        s = lane.matvec(L[:, j:, :j], L[:, j, :j].contiguous())
        sy = lane.matvec(L[:, j:j + 1, :j], y[:, :j].contiguous())[:, 0]
        p = Hd[:, j, j] - s[:, 0]
        fail = fail | ~(p > 0)
        dj = torch.sqrt(p)
        diag[:, j] = dj
        L[:, j + 1:, j] = (Hd[:, j + 1:, j] - s[:, 1:]) / dj[:, None]
        y[:, j] = (g[:, j] - sy) / dj
    x = torch.empty_like(g)
    for j in range(n - 1, -1, -1):
        t = lane.matvec(L[:, j + 1:, j][:, None, :].contiguous(),
                        x[:, j + 1:].contiguous())[:, 0]
        x[:, j] = (y[:, j] - t) / diag[:, j]
    return torch.where(fail[:, None], _nan(g), -x)


def orders():
    from superdsm_tpu_torch.dsm import lane
    return {'fused (lane.cholesky_chain)': lane.cholesky_chain,
            'rounded apart': rounded_apart,
            'rounded apart, divisions': lambda Hd, g: rounded_apart(Hd, g, True),
            'left-looking dots': left_looking,
            'cuSOLVER per lane': cs._per_lane_cholesky}


def errors():
    import torch
    for B, n in SHAPES:
        Hd, g = cs._chol_systems(B, n)
        _, info = torch.linalg.cholesky_ex(Hd)
        ok = info == 0
        exact = -torch.linalg.solve(Hd[ok].double(), g[ok].double()[..., None])[..., 0]
        parts = []
        for name, fn in orders().items():
            x = fn(Hd, g)
            err = (x[ok].double() - exact).norm(dim=1) / exact.norm(dim=1)
            parts.append(f'{name} max {float(err.max()):.3e} median {float(err.median()):.3e}')
        say(f'(B, n) = ({B}, {n}), relative error against a float64 solve: ' + '; '.join(parts))
        cs._CHOL_SYSTEMS.clear()


def bench():
    import torch
    from superdsm_tpu_torch.dsm import batching, solver
    validate = cs._validate_module()
    former = solver._cholesky_direction
    for name, fn in orders().items():
        counts = [0, 0, 0]

        def direction(Hd, g, fn=fn, counts=counts):
            out = fn(Hd, g)
            _, info = torch.linalg.cholesky_ex(Hd)
            counts[0] += Hd.shape[0]
            counts[1] += int(torch.isnan(out).all(dim=1).sum())
            counts[2] += int((info != 0).sum())
            return out

        solver._cholesky_direction = direction
        runs = []
        try:
            for seed in range(4):
                before = batching.device_accounting()['lane_iters']
                with solver.eager_loop():
                    _, seg, _, _, _ = cs._segment(cs.make_image(seed)[0], 12)
                iters = batching.device_accounting()['lane_iters'] - before
                matched, spurious, missing = validate.match_rows(
                    validate.summarize_label_map(seg),
                    validate.load_csv(cs._bench_golden(seed, cs.F64)),
                    center_tol=3.0, size_tol=0.1)
                runs.append((iters, matched, len(spurious), len(missing)))
        finally:
            solver._cholesky_direction = former
        say(f'{name}: bench seeds 0-3 (lane iterations, float64-sum golden '
            f'matched, spurious, missing) {runs}; {counts[0]} factorizations, '
            f'{counts[1]} NaN, {counts[2]} failed in cholesky_ex')


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('cholesky_orders.py needs a CUDA card')
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.dsm import gram
    T.set_device('cuda')
    gram.build()
    os.system('nvidia-smi --query-gpu=name,power.limit --format=csv,noheader')
    errors()
    bench()


if __name__ == '__main__':
    main()
