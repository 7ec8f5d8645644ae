#!/usr/bin/env python
"""On the card: what planning the bf16 gram's pixel split from (P, n) alone
costs at the shapes where a plan from (B, P, n) ran one segment.

The bf16 kernel plans as for one lane (``gram.split_plan`` reads no B), so
that a lane's sums are the same in every batch. A launch of many lanes at
n = 1024 and 2048 then splits its pixel loop over segments and writes
float64 partials, in groups of lanes under the scratch cap, where a plan
from (B, P, n) ran one segment and wrote H itself. This script times
``gram.grad_hess_kernel`` in full mode at 1 pass (the hybrid schedule's
cheap gram, ``SDSM_GRAM_HYBRID_ITERS``) at those shapes in two checkouts,
in the turns A, B, B, A, one process each, under each checkout's own plan
(``plan``) and under a plan of one segment at every B (``one segment``:
``split_plan`` patched to ``(P / ROWS, 1)``; what a plan from (B, P, n)
ran at B >= 2, and at B = 1 the price of one segment for every B).
Device ms per call as ``chip_smoke._event_ms`` takes them (one call
captured in a CUDA graph and replayed); the lanes are
``chip_smoke._lane_features`` lanes (two distinct ones, repeated to B).

Usage (on a card; one ``[bf16-plans]`` line per measurement)::

    python tests/data/torch_port/bf16_plans.py ROOT_A ROOT_B
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[3]

#: (B, P, n): the largest bucket's GPU cap at its smallest and largest
#: pixel buckets, B = 1 and 2 at the largest, and n = 1024's phase-3 shape
#: and its lane alone.
SHAPES = [(64, 2048, 2048), (8, 131072, 2048), (2, 131072, 2048), (1, 131072, 2048),
          (8, 16384, 1024), (1, 16384, 1024)]
PLANS = ('plan', 'one segment')


def say(msg):
    print(f'[bf16-plans] {msg}', flush=True)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def turn(root):
    """One turn: the port of the checkout at ``root``; prints one JSON line
    of ms and plans by shape."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.dsm import gram
    if not T.__file__.startswith(os.path.join(os.path.abspath(root), 'superdsm_tpu_torch')):
        raise SystemExit(f'imported {T.__file__}, not the package under {root}')
    cs = _chip_smoke()
    T.set_device('cuda')
    gram.build()
    planned = gram.split_plan
    out = {}
    for B, P, n in SHAPES:
        rng = np.random.RandomState(n + P)
        lanes = [cs._lane_features(rng, P, n - 6) for _ in range(min(B, 2))]
        Bf, s, yv, w = (torch.stack([t[b % len(lanes)] for b in range(B)]).contiguous()
                        for t in zip(*lanes))
        del lanes
        active = torch.ones(B, dtype=torch.int32, device='cuda')
        results = {}
        for name in PLANS:
            gram.split_plan = planned if name == 'plan' else (
                lambda B_, P_, n_, passes=6, full=False: (P_ // gram.ROWS, 1))
            try:
                kernel = lambda: gram.grad_hess_kernel(Bf, s, yv, w, active,
                                                       passes=1, full=True)
                g, H = kernel()
                torch.cuda.synchronize()
                results[name] = H
                out[f'{(B, P, n)} {name}'] = dict(
                    ms=cs._event_ms(kernel),
                    plan=list(gram.split_plan(B, P, n, 1, True)),
                    lanes_per_launch=gram.lanes_per_launch(B, P, n, 1, True),
                    finite=bool(torch.isfinite(H).all() and torch.isfinite(g).all()))
                del g
            finally:
                gram.split_plan = planned
        H0, H1 = results.values()
        out[f'{(B, P, n)} plan'].update(rel_diff=float(
            ((H0 - H1).abs().max() / H1.abs().max()).item()))
        del Bf, s, yv, w, results, H0, H1
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(roots):
    order = roots + roots[::-1]
    turns = {root: [] for root in roots}
    for root in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), '--turn', root],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            raise SystemExit(f'--turn {root} exited {proc.returncode}:\n'
                             f'{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}')
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        turns[root].append(out)
        say(f'{root}: {json.dumps(out)}')
    for key in turns[roots[0]][0]:
        for root in roots:
            ms = [out[key]['ms'] for out in turns[root]]
            first = turns[root][0][key]
            say(f'{key}: {root}: {np.mean(ms):.4f} ms (turns {[round(t, 4) for t in ms]}); '
                f'(seg_chunks, segments) {first["plan"]}, {first["lanes_per_launch"]} lanes '
                f'a launch, finite {first["finite"]}'
                + (f', max |dH| against one segment {first["rel_diff"]:.2e} of max |H|'
                   if 'rel_diff' in first else ''))
        a, b = (np.mean([out[key]['ms'] for out in turns[root]]) for root in roots)
        say(f'{key}: {roots[0]} -> {roots[1]}: {a:.4f} -> {b:.4f} ms ({b / a:.2f}x)')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True)
    say(card.stdout.strip())


if __name__ == '__main__':
    if sys.argv[1:2] == ['--turn'] and len(sys.argv) == 3:
        turn(sys.argv[2])
    elif len(sys.argv) == 3:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
