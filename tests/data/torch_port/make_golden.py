#!/usr/bin/env python
"""Regenerates the JAX-CPU golden label summary of the bench field.

Segments seed 0 of the 520x696 synthetic BBBC039-like field of ``bench.py``
(28 nuclei with touching pairs) with the JAX package on the CPU at
``AF_scale=12``, the configuration ``bench.py`` uses, and writes the
``summarize_label_map`` rows (object size, center X, center Y) of the label
map to ``bench-seed0.csv`` beside this script. ``chip_smoke.py`` holds the
port's label map of the same field against it.

Usage::

    JAX_PLATFORMS=cpu python tests/data/torch_port/make_golden.py
"""

import os
import pathlib
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[2]
sys.path.insert(0, str(REPO))

GOLDEN = HERE / 'bench-seed0.csv'


def main():
    from bench import make_image
    from superdsm_tpu.automation import process_image
    from superdsm_tpu.config import Config
    from superdsm_tpu.output import get_output
    from superdsm_tpu.pipeline import create_default_pipeline
    from superdsm_tpu.render import rasterize_labels
    from tests.regression.validate import save_csv, summarize_label_map

    g, _ = make_image(0)
    data, _, _ = process_image(create_default_pipeline(),
                               Config({'AF_scale': 12}), g,
                               out=get_output(None).derive(muted=True))
    rows = summarize_label_map(rasterize_labels(data))
    save_csv(GOLDEN, rows)
    print(f'wrote {GOLDEN}: {len(rows)} objects')


if __name__ == '__main__':
    main()
