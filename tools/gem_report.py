"""Runs one benchmark cell with the port's span recorder on and prints, per
window image, what the global energy minimization did, and the shapes of
the DSM chunks the solver ran.

    python3 tools/gem_report.py --workload gowt1-batch --seeds 1 2 --seconds 51

For each seed, one traced run of the cell (``portbench/spans.run_cell``),
then one JSON line on standard output:

- ``images``: per window image, the generations (``sdsm.gem.generation``
  spans), the sums of their counts (``grown``, ``pruned``, ``solved``,
  ``kept``; generation 1's ``clusters``, ``atoms``, ``direct``,
  ``largest_cluster``), the c2f's ``splits_tried`` and ``splits_kept``, and
  the host seconds inside ``sdsm.gem.bounds`` and ``sdsm.gem.estimate``;
- ``chunks``: the window images' DSM chunks, from their
  ``sdsm.solve.dispatch`` spans, as ``[stage, P bucket, n, B, chunks,
  lanes]`` (the canonical re-solves, one lane each, are counted by
  ``dsm.canonical`` in ``images``);
- the run's metrics, check and top device operations (``breakdown``).

It reads what ``portbench/span_report.py`` reads, and goes with it once
the benchmark's own metrics read the spans (``portbench/spans.py``).
Needs a CUDA card; writes the lines to ``chiprun_out/gem_report.jsonl`` too.
"""

import argparse
import collections
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GEN_COUNTS = ('grown', 'pruned', 'solved', 'kept', 'clusters', 'atoms', 'direct',
              'largest_cluster')


def chunk_histogram(run):
    """``[stage, P, n, B, chunks, lanes]`` of the window images' DSM chunks,
    the stage being the ``sdsm.stage.*`` span the dispatch lies in."""
    from portbench import spans
    by_id = {s['id']: s for s in spans.spans_of(run)}

    def stage(s):
        while s is not None and not s['name'].startswith('sdsm.stage.'):
            s = by_id.get(s['parent'])
        return None if s is None else s['name'][len('sdsm.stage.'):]

    hist = collections.Counter()
    lanes = collections.Counter()
    for s in spans.window_spans(run, 'sdsm.solve.dispatch'):
        a = s['attrs']
        if 'n' in a:
            key = (stage(s), a['P'], a['n'], a['B'])
            hist[key] += 1
            lanes[key] += a['lanes']
    return sorted(list(k) + [hist[k], lanes[k]] for k in hist)


def per_image(run):
    from portbench import spans
    window = spans.window_images(run)
    rows = collections.defaultdict(lambda: collections.Counter())
    for s in run.program_spans['spans']:
        if s['image'] not in window:
            continue
        row = rows[s['image']]
        if s['name'] == 'sdsm.gem.generation':
            row['generations'] += 1
            for k in GEN_COUNTS:
                row[k] += s['counts'].get(k, 0)
        elif s['name'] == 'sdsm.c2f.cluster':
            for k in ('splits_tried', 'splits_kept'):
                row[k] += s['counts'].get(k, 0)
        elif s['name'] in ('sdsm.gem.bounds', 'sdsm.gem.estimate'):
            row[s['name'].split('.')[-1] + '_s'] += s['end'] - s['start']
        elif s['name'] == 'sdsm.solve.canonical':
            row['dsm.canonical'] += s['counts'].get('dsm.canonical', 0)
        elif s['name'] == 'sdsm.image':
            row['image_s'] += s['end'] - s['start']
    return [dict(image=i, **{k: round(v, 4) if isinstance(v, float) else v
                             for k, v in sorted(row.items())})
            for i, row in sorted(rows.items())]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=51)
    args = ap.parse_args(argv)
    from portbench import run as runmod
    runmod.environment()
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 3
    from portbench import spans
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    for seed in args.seeds:
        result, run, notes = spans.run_cell(args.workload, seed, args.seconds, True)
        line = dict(workload=args.workload, seed=seed, card=runmod.power_limit(),
                    correct=result['correct'], failed=result['failed'],
                    attempted=result['attempted'], check=result['check'],
                    metrics={k: v['value'] for k, v in result['metrics'].items()},
                    device=result['device'], images=per_image(run),
                    chunks=chunk_histogram(run),
                    breakdown=result.get('breakdown'), notes=notes)
        text = json.dumps(line)
        print(text, flush=True)
        with open(os.path.join(ROOT, 'chiprun_out', 'gem_report.jsonl'), 'a') as f:
            f.write(text + '\n')
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
