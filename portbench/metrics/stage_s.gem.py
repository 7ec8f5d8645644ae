"""Seconds per image of the global energy minimization stage, from the
pipeline's own stage timings (wall time; under threads it includes waiting
for the interpreter lock)."""

STAGE = 'global-energy-minimization'


def read(run):
    times = [r['timings'][STAGE] for r in run.done if STAGE in r.get('timings', {})]
    return sum(times) / len(times) if times else None
