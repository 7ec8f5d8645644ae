"""Seconds per image of the coarse-to-fine region analysis stage, from the
pipeline's own stage timings (wall time; under threads it includes waiting
for the interpreter lock)."""

STAGE = 'c2f-region-analysis'


def read(run):
    times = [r['timings'][STAGE] for r in run.done if STAGE in r.get('timings', {})]
    return sum(times) / len(times) if times else None
