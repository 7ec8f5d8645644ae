"""Reading the port's own spans (``superdsm_tpu_torch.trace``) of a traced run.

:func:`run_cell` runs one cell as ``harness.run_cell`` does, with the
port's span recorder on in a traced run, and keeps what it drained as
``run.program_spans``; a program without the recorder leaves it None, and
every reader here then returns None. The benchmark's own command does not
turn the recorder on (``harness.py`` would have to), so these readings are
printed by ``span_report.py`` and carried by no metric of
``BENCHMARK.json``. Once ``harness.run_cell`` keeps the drained spans and
metrics read them, :func:`run_cell` and ``span_report.py`` go, and this
module keeps only the readers. Spans are on :func:`time.perf_counter`, the
clock on which :class:`devtrace.Trace` places the device's activities.

A window image is an ``sdsm.image`` span that started in ``[t0, t1)`` (the
recorder keeps finished spans only). The device's idle time in ``[t0, t1]``
is shared, at each instant, equally among the threads that have an image
span open then, and each share goes to that thread's innermost open span.
Pool threads open no image span of their own, so their spans (carried from
a worker's span) take no share.
"""

import bisect
import collections

IMAGE = 'sdsm.image'
STAGES = {'c2f': 'c2f-region-analysis', 'gem': 'global-energy-minimization'}


def run_cell(workload, seed, seconds, trace, device='cuda', **kwargs):
    """``harness.run_cell``, with the port's span recorder on from the
    set-up to the check in a traced run (``run.program_spans``: what it
    drained, or None where the program has no recorder or the run is not
    traced)."""
    from portbench import harness
    recorder = drained = None
    if trace:
        try:
            from superdsm_tpu_torch import trace as recorder
        except ImportError:
            pass
    if recorder is not None:
        recorder.enable(True)
    try:
        result, run, notes = harness.run_cell(workload, seed, seconds, trace, device, **kwargs)
    finally:
        if recorder is not None:
            drained = recorder.drain()
            recorder.enable(False)
    run.program_spans = drained
    return result, run, notes


def spans_of(run):
    """The run's spans (a list of dicts), or None."""
    drained = getattr(run, 'program_spans', None)
    return None if not drained else drained['spans']


def window_images(run):
    """Image ids of the window images, or None."""
    spans = spans_of(run)
    if spans is None:
        return None
    return {s['image'] for s in spans
            if s['name'] == IMAGE and run.t0 <= s['start'] < run.t1}


def idle_group(name):
    """Which ``idle_ms_per_image.<group>`` an innermost span's share goes
    to, or None."""
    if name.startswith('sdsm.c2f.') or name == 'sdsm.stage.' + STAGES['c2f']:
        return 'c2f'
    if name.startswith(('sdsm.gem.', 'sdsm.objects.')) or name == 'sdsm.stage.' + STAGES['gem']:
        return 'gem'
    if name.startswith('sdsm.solve'):
        return 'solve'
    if name == 'sdsm.loop.capture':
        return 'capture'
    return None


def unattributed(name):
    """Whether an innermost span says no more than that an image or a stage
    was open."""
    return name == IMAGE or name.startswith('sdsm.stage.')


def innermost_segments(spans):
    """``(start, end, thread, name)``: each thread's time inside an image
    span, cut where its innermost open span changes. Spans of one thread
    nest, so the one that started last among those open is the innermost."""
    by_thread = collections.defaultdict(list)
    for s in spans:
        by_thread[s['thread']].append(s)
    segments = []
    for thread, own in by_thread.items():
        stack, t = [], None

        def emit(a, b):
            if stack and stack[0]['name'] == IMAGE and b > a:
                segments.append((a, b, thread, stack[-1]['name']))

        for s in sorted(own, key=lambda s: (s['start'], -s['end'])):
            while stack and stack[-1]['end'] <= s['start']:
                emit(t, stack[-1]['end'])
                t = stack.pop()['end']
            if t is not None:
                emit(t, s['start'])
            t = s['start']
            stack.append(s)
        while stack:
            emit(t, stack[-1]['end'])
            t = stack.pop()['end']
    return segments


def idle_by_span(spans, gaps):
    """Idle seconds by innermost span name (key None: idle while no thread
    had an image open), from the device's idle intervals ``gaps``."""
    events = []
    for a, b, thread, name in innermost_segments(spans):
        events += [(a, 1, thread, name), (b, 0, thread, None)]
    for a, b in gaps:
        events += [(a, 1, None, None), (b, 0, None, None)]
    events.sort(key=lambda e: (e[0], e[1]))
    out = collections.defaultdict(float)
    active, idle, prev = {}, False, None
    for t, opens, thread, name in events:
        if idle and prev is not None and t > prev:
            if active:
                share = (t - prev) / len(active)
                for held in active.values():
                    out[held] += share
            else:
                out[None] += t - prev
        prev = t
        if thread is None:
            idle = bool(opens)
        elif opens:
            active[thread] = name
        else:
            active.pop(thread, None)
    return dict(out)


def window_idle(run):
    """:func:`idle_by_span` of the run's window (computed once), or None."""
    cached = getattr(run, '_idle_by_span', None)
    if cached is None:
        spans = spans_of(run)
        if spans is None or run.trace is None:
            return None
        cached = run._idle_by_span = idle_by_span(spans, run.trace.gaps(run.t0, run.t1))
    return cached


def idle_ms_per_image(run, group):
    """Milliseconds of device idle time per window image whose innermost
    span belongs to ``group``."""
    idle = window_idle(run)
    n = run.images_in_window() if run.done else 0
    if idle is None or n <= 0:
        return None
    return 1e3 * sum(v for k, v in idle.items() if k is not None and idle_group(k) == group) / n


def unattributed_share(run):
    """Share of the window's idle seconds whose innermost span is an image
    or a stage span, or None."""
    idle = window_idle(run)
    total = sum(idle.values()) if idle else 0.0
    if total <= 0:
        return None
    return sum(v for k, v in idle.items() if k is not None and unattributed(k)) / total


def stage_cpu_s(run, key):
    """Mean over window images of the thread-CPU seconds of the stage span
    ``STAGES[key]``, with the CPU of the spans carried from inside it onto
    pool threads (each span whose parent ran on another thread counts with
    its own nested spans)."""
    spans, images = spans_of(run), window_images(run)
    if not spans or not images:
        return None
    name = 'sdsm.stage.' + STAGES[key]
    by_id = {s['id']: s for s in spans}
    cpu = {s['id']: s['cpu'] for s in spans if s['name'] == name and s['image'] in images}
    for s in spans:
        parent = by_id.get(s['parent'])
        if parent is None or parent['thread'] == s['thread']:
            continue
        while parent is not None and parent['name'] != name:
            parent = by_id.get(parent['parent'])
        if parent is not None and parent['id'] in cpu:
            cpu[parent['id']] += s['cpu']
    return sum(cpu.values()) / len(cpu) if cpu else None


def window_spans(run, name):
    images = window_images(run)
    if not images:
        return []
    return [s for s in spans_of(run) if s['name'] == name and s['image'] in images]


def solve_wait_ms_per_image(run):
    """Milliseconds in ``sdsm.solve.fetch`` spans of window images, per
    window image."""
    images = window_images(run)
    if not images:
        return None
    fetches = window_spans(run, 'sdsm.solve.fetch')
    return 1e3 * sum(s['end'] - s['start'] for s in fetches) / len(images)


def lane_counts(run, kind='dsm', resolves=False):
    """The lane-cause counts ``{cause: lanes}`` of ``kind`` over the window
    images' spans, or None when the program counts none: of each lane's
    first solve, or with ``resolves`` of the canonical re-solves alone (the
    counts made inside an ``sdsm.solve.canonical`` span)."""
    images = window_images(run)
    if not images:
        return None
    spans = spans_of(run)
    canonical = {s['id'] for s in spans if s['name'] == 'sdsm.solve.canonical'}
    total = collections.Counter()
    for s in spans:
        if s['image'] in images and (s['parent'] in canonical) == resolves:
            total.update({k.split('.', 1)[1]: v for k, v in s['counts'].items()
                          if k.startswith(kind + '.')})
    return dict(total) if total else None


def busy_within(run, intervals):
    """Seconds of device activity inside each ``(start, end)``."""
    from portbench import devtrace
    busy = devtrace.merged((a, b) for _, a, b in run.trace.device)
    starts = [a for a, _ in busy]
    out = []
    for a, b in intervals:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        total = 0.0
        while i < len(busy) and busy[i][0] < b:
            total += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        out.append(total)
    return out


def fetch_busy_share(run):
    """Share of the window images' ``sdsm.solve.fetch`` seconds in which some
    activity ran on the card (low where the Newton loop's own reads have
    already waited for the card's work)."""
    fetches = [(s['start'], s['end']) for s in window_spans(run, 'sdsm.solve.fetch')]
    total = sum(b - a for a, b in fetches)
    if run.trace is None or total <= 0:
        return None
    return sum(busy_within(run, fetches)) / total


def capture_leads(run):
    """``(seconds since the profiler's marker, lead)`` for every
    ``sdsm.loop.capture`` span of the run (warm-up included) with a
    ``cudaStreamBeginCapture`` of the profiler's within 0.1 s of its start:
    the lead is the nearest such call's time less the span's start. The
    span's own call follows its start by microseconds, so a constant lead is
    the offset between the profiler's clock and the host's, and a lead that
    grows with the time since the marker their drift."""
    if run.trace is None:
        return []
    begins = sorted(t for name, t in run.trace.host if name == 'cudaStreamBeginCapture')
    out = []
    for s in spans_of(run) or ():
        if s['name'] != 'sdsm.loop.capture':
            continue
        i = bisect.bisect_left(begins, s['start'] - 0.1)
        near = [t for t in begins[i:i + 64] if abs(t - s['start']) <= 0.1]
        if near:
            lead = min(near, key=lambda t: abs(t - s['start'])) - s['start']
            out.append((s['start'] - run.mark_perf, lead))
    return sorted(out)


def lanes_capped_pct(run):
    """Share (%) of the window images' deformable-model lanes whose Newton
    loop ran to its iteration cap without freezing in their first solve:
    ``dsm.capped`` over ``dsm.converged``, ``dsm.capped`` and
    ``dsm.fallback``, each lane counted once (its canonical re-solve is
    not)."""
    counts = lane_counts(run, 'dsm')
    if not counts:
        return None
    lanes = sum(counts.get(k, 0) for k in ('converged', 'capped', 'fallback'))
    return 100.0 * counts.get('capped', 0) / lanes if lanes else None


def readings(run):
    """The per-layer readings of the spans, by the names a metric of
    ``BENCHMARK.json`` would give them (None where a reader finds nothing):
    the stages' CPU seconds an image under threads, the milliseconds an
    image that the workers waited in ``sdsm.solve.fetch``, the device's idle
    milliseconds an image by the group of the innermost span, and the share
    of deformable lanes that reached the iteration cap."""
    out = {f'stage_cpu_s.{k}': stage_cpu_s(run, k) for k in STAGES}
    out['solve_wait_ms_per_image'] = solve_wait_ms_per_image(run)
    for group in ('c2f', 'gem', 'solve', 'capture'):
        out[f'idle_ms_per_image.{group}'] = idle_ms_per_image(run, group)
    out['lanes_capped_pct'] = lanes_capped_pct(run)
    return out
