#!/usr/bin/env python
"""Regenerates the JAX-CPU golden label summaries the port is held against.

Each golden is the ``summarize_label_map`` rows (object size, center X,
center Y) of a label map the JAX package produced on the CPU, written to a
CSV beside this script. ``chip_smoke.py`` holds the port's label maps of the
same inputs against them.

- ``bench-seed{N}.csv``: seed N of the 520x696 synthetic BBBC039-like field
  of ``bench.py`` (28 nuclei with touching pairs), segmented through
  ``automation.process_image`` at ``AF_scale=12``, the configuration
  ``bench.py`` uses;
- ``mosaic-2048-seed0.csv`` (``--mosaic``): the 2048x2048 dense mosaic of
  ``tools/mosaic_bench.make_mosaic`` (seed 0, 441 nuclei), segmented by
  ``parallel.mosaic.process_mosaic`` at the default tile (1024, 1024) and
  halo 160, ``AF_scale=12`` with ``c2f-region-analysis/speculate`` off, one
  thread; the rows are those of ``rasterize_mosaic_labels``. About five
  minutes on an 8-core CPU.

``--f64-sums`` writes the same goldens of the JAX package under the port's
numerics contract, its Newton-system pixel sums in float64
(``f64sums.install``), to ``bench-seed{N}-f64sums.csv`` and
``mosaic-2048-seed0-f64sums.csv``: the same inputs and configurations.

Usage::

    JAX_PLATFORMS=cpu python tests/data/torch_port/make_golden.py [--seeds 0 1 2 3] [--mosaic] [--f64-sums]

With no option it writes seed 0.
"""

import argparse
import os
import pathlib
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[2]
sys.path.insert(0, str(REPO))

MOSAIC_SIZE = 2048


def bench_golden(seed, suffix=''):
    from bench import make_image
    from superdsm_tpu.automation import process_image
    from superdsm_tpu.config import Config
    from superdsm_tpu.output import get_output
    from superdsm_tpu.pipeline import create_default_pipeline
    from superdsm_tpu.render import rasterize_labels
    from tests.regression.validate import save_csv, summarize_label_map

    g, _ = make_image(seed)
    data, _, _ = process_image(create_default_pipeline(),
                               Config({'AF_scale': 12}), g,
                               out=get_output(None).derive(muted=True))
    rows = summarize_label_map(rasterize_labels(data))
    path = HERE / f'bench-seed{seed}{suffix}.csv'
    save_csv(path, rows)
    print(f'wrote {path}: {len(rows)} objects')


def mosaic_golden(suffix=''):
    from tools.mosaic_bench import make_mosaic
    from superdsm_tpu.config import Config
    from superdsm_tpu.output import get_output
    from superdsm_tpu.parallel.mosaic import process_mosaic, rasterize_mosaic_labels
    from superdsm_tpu.pipeline import create_default_pipeline
    from tests.regression.validate import save_csv, summarize_label_map

    g, n = make_mosaic(MOSAIC_SIZE, seed=0)
    cfg = Config({'AF_scale': 12})
    cfg['c2f-region-analysis/speculate'] = False
    objects, n_tiles = process_mosaic(create_default_pipeline(), cfg, g,
                                      out=get_output(None).derive(muted=True),
                                      threads_per_device=1)
    rows = summarize_label_map(rasterize_mosaic_labels(g.shape, objects))
    path = HERE / f'mosaic-{MOSAIC_SIZE}-seed0{suffix}.csv'
    save_csv(path, rows)
    print(f'wrote {path}: {len(rows)} objects from {n_tiles} tiles '
          f'({n} planted nuclei)')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seeds', type=int, nargs='*', default=None,
                        help='bench seeds to write (default: 0, unless --mosaic)')
    parser.add_argument('--mosaic', action='store_true',
                        help=f'write mosaic-{MOSAIC_SIZE}-seed0.csv')
    parser.add_argument('--f64-sums', action='store_true',
                        help='the JAX package with float64 Newton-system pixel '
                             'sums (f64sums.py), into *-f64sums.csv')
    args = parser.parse_args()
    suffix = ''
    if args.f64_sums:
        from tests.data.torch_port import f64sums
        f64sums.install()
        suffix = '-f64sums'
    seeds = args.seeds if args.seeds is not None else ([] if args.mosaic else [0])
    for seed in seeds:
        bench_golden(seed, suffix)
    if args.mosaic:
        mosaic_golden(suffix)


if __name__ == '__main__':
    main()
