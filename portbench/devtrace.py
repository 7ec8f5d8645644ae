"""Reading a ``torch.profiler`` trace of the window, frozen in the benchmark.

The method is the repository's earlier one-image profile, copied: the
profiler's raw kineto events (building ``prof.events()``' tree takes
minutes), the device's busy time as the union of its activities, the host
calls that wait for the card, and the activities that belong to a CUDA
graph's replay by the replay's correlation id.
"""

import collections

#: CUDA API calls that make the host wait for the card, and the graph launches.
HOST_SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
                   'cudaEventSynchronize', 'cuStreamSynchronize',
                   'cuCtxSynchronize', 'cudaMemcpy')
GRAPH_LAUNCH_CALLS = ('cudaGraphLaunch', 'cuGraphLaunch')
#: Marker range that ties the profiler's clock to the host's.
MARK = 'portbench.window'


def merged(intervals):
    """Union of ``(start, end)`` intervals: ``[(start, end)]``, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def short_name(name, width=80):
    """A kernel's name without its argument list, cut to ``width``."""
    name = name.replace('(anonymous namespace)::', '')
    name = name[5:] if name.startswith('void ') else name
    name = name.split('(')[0]
    return name if len(name) <= width else name[:width - 3] + '...'


class Trace:
    """The reduced trace: device activities ``(name, start_s, end_s)`` on the
    host's :func:`time.perf_counter` clock, host API calls by name, the
    graph replays' activities."""

    def __init__(self, prof, mark_perf):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        events = list(prof.profiler.kineto_results.events())
        marks = [e for e in events if e.name() == MARK]
        # profiler ns -> perf_counter s, through the marker's start
        shift = mark_perf - (marks[0].start_ns() / 1e9 if marks else 0.0)
        self.device = [(e.name(), e.start_ns() / 1e9 + shift,
                        (e.start_ns() + e.duration_ns()) / 1e9 + shift)
                       for e in events if e.device_type() == cuda]
        host = [e for e in events if e.device_type() != cuda]
        self.host = [(e.name(), e.start_ns() / 1e9 + shift) for e in host]
        replays = {e.correlation_id() for e in host if e.name() in GRAPH_LAUNCH_CALLS}
        self.replayed = [(e.name(), e.start_ns() / 1e9 + shift,
                          (e.start_ns() + e.duration_ns()) / 1e9 + shift)
                         for e in events
                         if e.device_type() == cuda and e.correlation_id() in replays]

    def busy(self, t0, t1):
        """Seconds in ``[t0, t1]`` during which some activity ran."""
        total = 0.0
        for a, b in merged((max(a, t0), min(b, t1)) for _, a, b in self.device
                           if b > t0 and a < t1):
            total += b - a
        return total

    def gaps(self, t0, t1):
        """Idle intervals of the device within ``[t0, t1]``."""
        out, cur = [], t0
        for a, b in merged((max(a, t0), min(b, t1)) for _, a, b in self.device
                           if b > t0 and a < t1):
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if t1 > cur:
            out.append((cur, t1))
        return out

    def host_calls(self, names, t0, t1):
        """Host calls named in ``names`` that started in ``[t0, t1]``."""
        return sum(1 for name, t in self.host if name in names and t0 <= t <= t1)

    def within(self, activities, t0, t1):
        return [(n, a, b) for n, a, b in activities if a >= t0 and b <= t1]

    def device_seconds(self, match, activities=None):
        """Device seconds of the activities whose name ``match`` accepts."""
        acts = self.device if activities is None else activities
        return sum(b - a for name, a, b in acts if match(name))

    def top_ops(self, t0, t1, k=10):
        total = collections.Counter()
        for name, a, b in self.within(self.device, t0, t1):
            total[short_name(name)] += b - a
        return [[n, s] for n, s in total.most_common(k)]
