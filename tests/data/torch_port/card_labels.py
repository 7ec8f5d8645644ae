#!/usr/bin/env python
"""The port's label maps on the card: bench seeds 0-3 (``AF_scale=12``) and
the 2048x2048 mosaic (default tiles, speculation off, one thread), as
``chip_smoke.py`` phases 4 and 10 segment them, with the gram kernel and
with the plain float64 gram. Writes ``chiprun_out/card-labels.npz`` with
the arrays ``bench{N}``, ``mosaic`` and each with the suffix ``_plain``
(``unmatched_rows.py`` reads them).

Usage, on a machine with a CUDA card::

    python3 tests/data/torch_port/card_labels.py
"""

import contextlib
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, 'chiprun_out', 'card-labels.npz')


def main():
    import numpy as np
    import torch
    import chip_smoke as cs
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.dsm import gram
    from superdsm_tpu_torch.output import get_output
    from superdsm_tpu_torch.parallel import process_mosaic, rasterize_mosaic_labels
    T.set_device('cuda')
    gram.build()
    g_mosaic, _ = cs.make_mosaic(cs.MOSAIC_SIZE)
    cfg = T.Config({'AF_scale': 12})
    cfg['c2f-region-analysis/speculate'] = False
    out = {}
    for suffix, scope in (('', contextlib.nullcontext), ('_plain', cs._plain_gram)):
        with scope():
            for seed in cs.GOLDEN_SEEDS:
                _, out[f'bench{seed}{suffix}'], _, _, seconds = cs._segment(
                    cs.make_image(seed)[0], 12)
                print(f'bench seed {seed}{suffix}: {seconds:.2f} s', flush=True)
            t0 = time.time()
            objects, _ = process_mosaic(T.create_default_pipeline, cfg, g_mosaic,
                                        out=get_output(None).derive(muted=True),
                                        threads_per_device=1)
            torch.cuda.synchronize()
            out[f'mosaic{suffix}'] = rasterize_mosaic_labels(g_mosaic.shape, objects)
            print(f'mosaic{suffix}: {len(objects)} objects, {time.time() - t0:.2f} s',
                  flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f'wrote {os.path.relpath(OUT, REPO)}')
    print(cs.phase_environment())


if __name__ == '__main__':
    main()
