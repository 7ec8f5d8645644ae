"""Runs one cell of the benchmark of ``superdsm_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port. The cell is an entry
of ``BENCHMARK.json``'s ``workloads``. The last line of standard output is
the result object; the numbers the check compared, each beside its limit,
are the last lines of standard error. Exits with a code other than 0 and
prints no result when no CUDA card (or fewer than the cell asks for) is
present, when the port cannot be loaded, or when JAX or the JAX package is
loaded in this process once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that must not be loaded in the measured process
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'superdsm_tpu')


def environment():
    """Build and kernel caches at fixed places inside the checkout, and one
    intra-op thread for torch and the numerical libraries: the cell's worker
    threads are the process's only parallelism on the shared host."""
    os.environ.setdefault('USE_FLAX', '0')
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        os.environ[var] = '1'
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(ROOT, 'build', 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(ROOT, 'build', 'triton')


def forbidden_modules():
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cell = next((w for w in bench['workloads'] if w['name'] == args.workload), None)
    if cell is None:
        print(f'no workload {args.workload!r} in BENCHMARK.json', file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        print(f'the cell needs {cell["chips"]} CUDA card(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} present',
              file=sys.stderr)
        return 3
    from portbench import harness
    result, run, notes = harness.run_cell(args.workload, args.seed, args.seconds,
                                          bool(args.trace), 'cuda', t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f'loaded in the measured process: {", ".join(found)}', file=sys.stderr)
        return 4
    import importlib.util
    result['device'].update(cuda=torch.version.cuda,
                            triton=importlib.util.find_spec('triton') is not None,
                            power=power_limit())
    for line in notes:
        print(line, file=sys.stderr)
    # the numbers compared, each beside its limit, last on standard error
    for name, num in result['check'].items():
        print(f'check {name} {num["value"]!r} limit {num["limit"]!r}', file=sys.stderr)
    print(f'check correct {result["correct"]}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
