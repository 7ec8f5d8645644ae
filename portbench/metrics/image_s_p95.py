"""95th percentile of each window image's seconds, from its hand-off to
its label map (the benchmark's own host-clock spans), over every image."""

import statistics


def read(run):
    times = [r['end'] - r['start'] for r in run.done]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method='inclusive')[18]
