"""Readings from which the check's limits are set, for one cell, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds 10 \
        --seeds 1 2 ... --control-seeds 101 102 103 --out readings.json

Runs the cell at its own load with a short window, in one process, once
for every seed of ``--seeds`` (sound runs of the program: the lower
readings), then, in a second process with the program's one-pass bfloat16
gram switched on (``SDSM_GRAM_PASSES=1``), once for every seed of
``--control-seeds`` (the control). Besides the numbers compared, each row
keeps what they were computed from (each sampled problem's gaps, each label
map's planted, spurious and centroid distances), so that a limit can be set
from the readings, and two readings that are not runs of the program:

- ``y_lsb_bf16_reference``: ``y_lsb`` with the reference's offset image
  computed in bfloat16 standing in the program's place (the control of
  ``y_lsb``, control rows only);
- ``label_fault``: the label maps of the run with every other object
  removed (a label map altered where it is produced).

Writes the rows to ``--out`` as JSON, and one line per row to standard
output.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(workload, seed, seconds, control, device='cuda'):
    import numpy as np
    import torch
    from portbench import check, harness
    result, run, notes = harness.run_cell(workload, seed, seconds, False, device)
    d = run.check_details
    row = dict(workload=workload, seed=seed, control='gram one-pass bf16' if control else None,
               correct=result['correct'], check=result['check'],
               images_per_s=run.images_in_window() / run.window_s, notes=notes,
               labels=[list(s) for s in d['labels'].values()], y=d['y'], problems=d['problems'])
    fault = []
    for i in d['labels']:
        labels = np.array(run.records[i]['labels'])
        labels[labels % 2 == 0] = 0
        fault.append(check.label_stats(labels, run.truth(i)))
    row['label_fault'] = [list(s) for s in fault]
    if control:
        pick = sorted(d['y'])
        row['y_lsb_bf16_reference'] = max(
            check.y_numbers(run, pick, device, dtype=torch.bfloat16).values())
    del run
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, default=10)
    ap.add_argument('--seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control-seeds', type=int, nargs='*', default=[])
    ap.add_argument('--control', action='store_true', help=argparse.SUPPRESS)
    ap.add_argument('--out', required=True)
    args = ap.parse_args(argv)
    from portbench import run as runmod
    runmod.environment()
    rows = []
    for seed in args.seeds:
        try:
            row = readings(args.workload, seed, args.seconds, args.control)
        except Exception as err:  # a run that crashes is a reading too
            row = dict(workload=args.workload, seed=seed, control=args.control,
                       correct=False, error=repr(err))
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k not in ('labels', 'problems', 'label_fault')}), flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(rows, f)
    if args.control_seeds:
        env = dict(os.environ, SDSM_GRAM_PASSES='1')
        subprocess.run([sys.executable, os.path.abspath(__file__), '--workload', args.workload,
                        '--seconds', str(args.seconds), '--control', '--out',
                        args.out + '.control', '--seeds']
                       + [str(s) for s in args.control_seeds], cwd=ROOT, env=env)
    return 0


if __name__ == '__main__':
    sys.exit(main())
