#!/usr/bin/env python
"""Writes ``f64sums-unmatched.csv``: every row where the port's label maps
on the card (``card_labels.py``'s ``chiprun_out/card-labels.npz``) leave a
float64-sum golden at center 3 px and size 10%, with what is known of its
cause: a record for ROADMAP section C 1, which no gate reads.

Causes, the first that holds:

- ``c2f solve stalls``: a c2f solve stops far above the exact float64
  minimum of its energy in the reference under the port's numerics
  contract, and the reference with that one energy set to its exact
  minimum gives the port's row (:data:`PROVEN`, from ``diverge.py
  --f64-sums --c2f-exact``); the port's solve of the same problem may
  stall too (``make_stall_fixture.py --report``);
- ``backend noise``: the port's own row flips between the gram kernel and
  the plain float64 gram on the card (ROADMAP section C 6);
- ``device noise``: the port's own row flips between the card and the CPU
  (``cpu_labels.py``'s ``mosaic_cpu``): the same code and float64 sums,
  another device's rounding in everything else;
- ``preprocess rounding``: the port on the CPU with the JAX package's
  preprocess stage (``mosaic_cpu_jaxpre``; offsets within one int16 quantum
  of the port's) takes the golden's decision there;
- ``reference flips with its sums``: the JAX package's own row flips
  between float32 and float64 pixel sums (the float32 golden holds the
  port's row, or lacks the golden's);
- ``DSM solves stall``: the object there, its footprint re-solved alone in
  each package on the same atoms, ends far above the exact minimum of its
  energy in the reference and lower in the port, which may stall above it
  too (:data:`RESOLVED`, from ``diverge.py --f64-sums --mosaic-tile ...
  --object-at``);
- ``not isolated``: none of these; a suspect of a port fault.

Usage::

    python tests/data/torch_port/unmatched_rows.py [chiprun_out/card-labels.npz \
        [chiprun_out/cpu-labels.npz]]
"""

import csv
import os
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

OUT = HERE / 'f64sums-unmatched.csv'
COLUMNS = ['golden', 'kind', 'size', 'x', 'y', 'cause', 'evidence']
#: Rows shown to come from a reference solve that stalls with float64 sums:
#: per image the rows of the reference with that solve's energy set to its
#: exact minimum, and how it was shown.
PROVEN = {
    'bench3': ({'spurious': [(711, 398.7, 418.8), (733, 414.9, 441.6)],
                'missing': [(1429, 406.7, 430.1)]},
               'c2f solve at offset (279, 380), 4022 pixels: reference 559.9240, '
               'exact minimum 95.0227, port 95.4780 in its batch and 323.4516 '
               'alone (CPU); diverge.py --f64-sums --seed 3 --c2f-exact 430 407'),
}


#: Mosaic rows whose object was re-solved alone (tile crop origin, pixel
#: in the crop): the JAX energy function at the reference's and the port's
#: solution, and the exact minimum.
RESOLVED = {
    (1286.0, 711.0): ((0, 864), (422, 711), 927.4823, 144.6568, 41.0245),
    (1758.7, 998.6): ((0, 864), (895, 999), 3343.6237, 1263.2145, 112.4661),
    (1759.0, 923.9): ((0, 864), (895, 924), 1826.2191, 274.0040, 46.5574),
    (823.2, 1672.8): ((864, 0), (823, 809), 1202.3145, 512.1519, 42.5656),
    (891.1, 1985.2): ((864, 0), (891, 1121), 1580.1676, 1069.1415, 54.8870),
    (932.0, 1785.3): ((864, 0), (932, 921), 2323.5483, 545.5583, 56.1327),
    (1005.1, 1482.0): ((864, 0), (1005, 618), 1388.9595, 788.9497, 61.4502),
    (1019.8, 1866.0): ((864, 0), (1020, 1002), 1280.2278, 464.2746, 49.6064),
    (601.2, 792.1): ((0, 0), (601, 792), 961.8659, 53.6188, 48.8256),
    (1761.0, 258.0): ((0, 864), (897, 258), 1079.3011, 28.5253, 28.2178),
    (1848.7, 547.6): ((0, 864), (985, 548), 638.2318, 299.3511, 41.0534),
    (1698.0, 1693.9): ((864, 864), (834, 830), 1072.7450, 220.8005, 68.8505),
    (1759.9, 1697.2): ((864, 864), (896, 833), 1129.2042, 624.2278, 63.1280),
    (602.8, 1798.7): ((864, 0), (603, 935), 777.7144, 387.0181, 26.1822),
    (1857.0, 1788.3): ((864, 864), (993, 922), 1383.3969, 873.5212, 46.4465),
    (1470.9, 985.9): ((0, 864), (607, 986), 1453.1774, 268.2334, 43.1089),
    (1960.7, 1003.3): ((0, 864), (1097, 1003), 1682.3036, 1190.1127, 77.1142),
}


def _resolved(row):
    """:data:`RESOLVED`'s evidence for ``row``, or None."""
    for (x, y), (tile, pixel, e_ref, e_port, e_min) in RESOLVED.items():
        if abs(row[1] - x) <= 0.5 and abs(row[2] - y) <= 0.5:
            return (f're-solved alone: JAX energy {e_ref:.4f} at the reference\'s '
                    f'solution, {e_port:.4f} at the port\'s, exact minimum {e_min:.4f}; '
                    f'diverge.py --f64-sums --mosaic-tile {tile[0]} {tile[1]} '
                    f'--object-at {pixel[0]} {pixel[1]}')
    return None


def _holds(rows, row):
    from tests.regression.validate import match_rows
    return bool(rows) and bool(match_rows([row], rows, center_tol=3.0, size_tol=0.1)[0])


def classify(image, labels, golden, golden_f32):
    """``(kind, row, cause, evidence)`` of every row where ``labels[image]``
    leaves ``golden``."""
    from tests.regression.validate import load_csv, match_rows, summarize_label_map
    expected, expected_f32 = load_csv(golden), load_csv(golden_f32)
    rows_of = {k: summarize_label_map(v) for k, v in labels.items()
               if k.startswith(image + '_') or k == image}
    _, spurious, missing = match_rows(rows_of[image], expected,
                                      center_tol=3.0, size_tol=0.1)
    _, spurious_p, missing_p = match_rows(rows_of[f'{image}_plain'],
                                          expected, center_tol=3.0, size_tol=0.1)
    port_cpu, port_jaxpre = rows_of.get(f'{image}_cpu'), rows_of.get(f'{image}_cpu_jaxpre')
    proven, evidence = PROVEN.get(image, ({'spurious': [], 'missing': []}, ''))
    out = []
    for kind, rows, rows_plain in (('spurious', spurious, spurious_p),
                                   ('missing', missing, missing_p)):
        for row in rows:
            in_f32 = _holds(expected_f32, row)
            if _holds(proven[kind], row):
                out.append((kind, row, 'c2f solve stalls', evidence))
            elif not _holds(rows_plain, row):
                out.append((kind, row, 'backend noise', 'not unmatched with the '
                            'plain float64 gram on the card'))
            elif port_cpu is not None and _holds(port_cpu, row) == (kind == 'missing'):
                out.append((kind, row, 'device noise', "the port's row there differs "
                            'on the CPU'))
            elif port_jaxpre is not None and \
                    _holds(port_jaxpre, row) == (kind == 'missing'):
                out.append((kind, row, 'preprocess rounding', "the port with the JAX "
                            "package's preprocess stage takes the golden's decision"))
            elif in_f32 == (kind == 'spurious'):
                out.append((kind, row, 'reference flips with its sums',
                            f"{'in' if in_f32 else 'not in'} the float32 golden"))
            elif _resolved(row):
                out.append((kind, row, 'DSM solves stall', _resolved(row)))
            else:
                out.append((kind, row, 'not isolated', ''))
    return out


def main():
    import numpy as np
    out_dir = HERE.parents[2] / 'chiprun_out'
    paths = sys.argv[1:] or [str(out_dir / 'card-labels.npz'), str(out_dir / 'cpu-labels.npz')]
    labels = {}
    for path in paths:
        if os.path.exists(path):
            labels.update(np.load(path))
    images = [(f'bench{seed}', f'bench-seed{seed}') for seed in range(4)] + \
        [('mosaic', 'mosaic-2048-seed0')]
    rows = []
    for image, stem in images:
        golden = HERE / f'{stem}-f64sums.csv'
        found = classify(image, labels, golden, HERE / f'{stem}.csv')
        for kind, row, cause, evidence in found:
            rows.append([golden.name, kind, row[0], row[1], row[2], cause, evidence])
        counts = {}
        for _, _, cause, _ in found:
            counts[cause] = counts.get(cause, 0) + 1
        print(f'{image}: {len(found)} unmatched rows against {golden.name}: {counts}')
    with open(OUT, 'w', newline='') as fout:
        writer = csv.writer(fout)
        writer.writerow(COLUMNS)
        writer.writerows(rows)
    print(f'wrote {OUT}: {len(rows)} rows')


if __name__ == '__main__':
    main()
