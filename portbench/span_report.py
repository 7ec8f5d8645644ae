"""Runs one cell once, as ``run.py`` does, with the port's span recorder on
in a traced run, and prints the readings of its spans, which no metric of
``BENCHMARK.json`` carries (``spans.py``). It goes once the benchmark's own
metrics read the spans.

    python3 portbench/span_report.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One JSON line on standard output: the card and its power limit, the run's
metrics, and ``window_images_per_s`` and ``host_syncs_per_image`` read in
either mode (the recorder is the only difference of a traced run's window,
so a traced run against an untraced one on the same seed gives its cost). A
traced run adds: the span readings (``spans.readings``), the idle seconds
of the window by innermost span (``spans.idle_by_span``), the unattributed
share (an image or stage span innermost), the device's busy share inside
``sdsm.solve.fetch``, how far each capture span's ``cudaStreamBeginCapture``
lies from the span's start early and late in the run (the check that the
spans and the device trace share a clock), the lane-cause counts, and how
many ranges of the spans' names the profiler recorded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import run as runmod  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    runmod.environment()
    import torch
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 3
    from portbench import harness, spans
    result, run, notes = spans.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), 'cuda', t_process=T_PROCESS)
    out = dict(workload=args.workload, seed=args.seed, trace=args.trace,
               card=runmod.power_limit(), correct=result['correct'],
               metrics={k: v['value'] for k, v in result['metrics'].items()})
    for name in ('window_images_per_s', 'host_syncs_per_image'):
        out[name] = harness.load_module('metrics', name).read(run)
    if args.trace:
        idle = spans.window_idle(run) or {}
        out.update(
            readings=spans.readings(run),
            idle_s=sum(idle.values()),
            idle_outside_images_s=idle.get(None, 0.0),
            idle_by_span=sorted(([k, v] for k, v in idle.items() if k is not None),
                                key=lambda kv: -kv[1]),
            unattributed_share=spans.unattributed_share(run),
            fetch_busy_share=spans.fetch_busy_share(run),
            lanes=dict(dsm=spans.lane_counts(run, 'dsm'), poly=spans.lane_counts(run, 'poly'),
                       dsm_resolves=spans.lane_counts(run, 'dsm', resolves=True)),
            images_in_window=run.images_in_window(),
            window_images=len(spans.window_images(run) or ()),
            spans=len(spans.spans_of(run) or ()),
            dropped=(run.program_spans or {}).get('dropped'),
            profiler_ranges=sum(1 for name, _ in run.trace.host if name.startswith('sdsm.')))
        leads = spans.capture_leads(run)
        if len(leads) >= 2:
            xs, ys = zip(*leads)
            third = max(len(leads) // 3, 1)
            out['capture_leads'] = dict(
                n=len(leads), span_s=[xs[0], xs[-1]],
                first_ms=1e3 * statistics.median(ys[:third]),
                last_ms=1e3 * statistics.median(ys[-third:]),
                slope_ms_per_100s=1e5 * statistics.linear_regression(xs, ys).slope)
    print(json.dumps(out))
    for note in notes:
        print(note, file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
