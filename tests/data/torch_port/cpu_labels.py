#!/usr/bin/env python
"""The port's label map of the 2048x2048 mosaic on the CPU (default tiles,
speculation off, one thread, ``AF_scale=12``), as ``chip_smoke.py`` phase
10 segments it on the card, and once more with the JAX package's
preprocess stage in place of the port's (its float32 Gaussians, within one
int16 quantum of the port's offsets). Writes ``chiprun_out/cpu-labels.npz``
with the arrays ``mosaic_cpu`` and ``mosaic_cpu_jaxpre``
(``unmatched_rows.py`` reads it). About six minutes each on 8 cores.
``--port-only`` writes ``mosaic_cpu`` alone and imports nothing of JAX, so
that it runs on a machine without JAX (the card's host).

Usage::

    JAX_PLATFORMS=cpu python tests/data/torch_port/cpu_labels.py [--port-only]
"""

import os
import sys
import time

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, 'chiprun_out', 'cpu-labels.npz')


def main():
    import numpy as np
    import chip_smoke as cs
    import superdsm_tpu_torch as T
    from superdsm_tpu_torch.interop import from_jax
    from superdsm_tpu_torch.output import get_output
    from superdsm_tpu_torch.parallel import process_mosaic, rasterize_mosaic_labels
    T.set_device('cpu')
    port_only = sys.argv[1:] == ['--port-only']

    def with_jax_preprocess():
        from superdsm_tpu.pipeline import create_default_pipeline as jax_pipeline
        jax_preprocess = next(s for s in jax_pipeline().stages if s.name == 'preprocess')
        pipeline = T.create_default_pipeline()
        stage = next(s for s in pipeline.stages if s.name == 'preprocess')
        stage.process = lambda data, cfg, out, log_root_dir: from_jax(
            jax_preprocess.process(data, cfg, out, log_root_dir))
        return pipeline

    g, _ = cs.make_mosaic(cs.MOSAIC_SIZE)
    cfg = T.Config({'AF_scale': 12})
    cfg['c2f-region-analysis/speculate'] = False
    out = {}
    runs = [('mosaic_cpu', T.create_default_pipeline)]
    if not port_only:
        runs.append(('mosaic_cpu_jaxpre', with_jax_preprocess))
    for name, factory in runs:
        t0 = time.time()
        objects, _ = process_mosaic(factory, cfg, g, out=get_output(None).derive(muted=True),
                                    threads_per_device=1)
        out[name] = rasterize_mosaic_labels(g.shape, objects)
        print(f'{name}: {len(objects)} objects, {time.time() - t0:.2f} s', flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f'wrote {os.path.relpath(OUT, REPO)}')


if __name__ == '__main__':
    main()
