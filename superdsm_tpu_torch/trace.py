"""Spans and counts of the port's host side: the one tracing mechanism.

A span is a named interval of one thread's work, kept in memory while the
recorder is on (:func:`enable`): its name, its id, its parent's id, the id
of the image it works for, its thread, its start and end on
:func:`time.perf_counter` (the clock on which a ``torch.profiler`` trace can
be placed through one marker range), the thread's CPU seconds inside it
(:func:`time.thread_time`), its counts (:func:`count`) and its attributes.
Each span also opens a profiler range of its name (what
``torch.profiler.record_function`` opens), so a profiler's trace shows the
spans above the kernels. The profiler records the ranges of the thread that
started it only: the spans of worker and pool threads are kept here but
appear in no profiler trace.

The spans of one image share its image id: the ``sdsm.image`` span opens a
new one unless an image span is already open in the thread. Work submitted
to a pool keeps its place in the tree through :func:`carry`: spans opened
in the pool thread take the submitting span as parent and its image id.

Off by default. While off, :func:`span` returns one shared no-op object
after a single check of a module flag, :func:`count` does nothing and
:func:`carry` returns the callable it was given. Nothing here synchronizes
the card. :func:`drain` hands over (and forgets) the finished spans::

    from superdsm_tpu_torch import trace
    trace.enable(True)
    automation.process_image(pipeline, cfg, img)
    spans = trace.drain()['spans']

``SDSM_SOLVE_TELEMETRY=1`` (read at import of :mod:`.dsm.batching`) and the
batch CLI's ``--debug`` turn the recorder on without keeping the spans
(``enable(True, keep=False)``); their lines on standard error are printed
from the span objects as each closes.
"""

import itertools
import threading
import time

import torch

#: Name of the span that opens an image's id.
IMAGE = 'sdsm.image'
#: Spans the recorder holds until :func:`drain`; later ones are dropped
#: and counted.
MAX_RECORDS = 1 << 20
#: The profiler's range: the C type behind ``record_function``, which
#: neither dispatches an operator nor releases the interpreter lock (a
#: contended lock costs the span's thread a switch interval to take back).
_RANGE = torch._C._profiler._RecordFunctionFast

_ON = False
_KEEP = False
_local = threading.local()
_lock = threading.Lock()
_ids = itertools.count(1)
_image_ids = itertools.count(1)
_records = []
_dropped = 0
_loose = {}  # counts made where no span of the thread was open


class _Off:
    """The shared no-op span of a recorder that is off."""
    __slots__ = ()
    start = end = cpu = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def times(self, start, end):
        pass


OFF = _Off()


class _Carried:
    """The submitting span's place, at the bottom of a pool thread's stack."""
    __slots__ = ('id', 'image')

    def __init__(self, span_id, image):
        self.id, self.image = span_id, image


def _stack():
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span while the recorder is on; a context manager."""
    __slots__ = ('name', 'id', 'parent', 'image', 'thread', 'start', 'end', 'cpu',
                 'counts', 'attrs', '_cpu0', '_range')

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.counts = {}
        self.end = None

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if top is None else top.id
        self.image = None if top is None else top.image
        if self.name == IMAGE:
            self.image = next(_image_ids)
        self.thread = threading.get_ident()
        self._range = _RANGE(self.name)
        self._range.__enter__()
        stack.append(self)
        self._cpu0 = time.thread_time()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.end is None:
            self.end = time.perf_counter()
        self.cpu = time.thread_time() - self._cpu0
        _stack().pop()
        self._range.__exit__(None, None, None)
        self._range = None
        if _KEEP:
            _keep(self)
        return False

    def times(self, start, end):
        """Takes the span's start and end from the caller's own two reads
        of :func:`time.perf_counter` (so that a number the caller derives
        from them and the span agree)."""
        self.start, self.end = start, end


def _keep(span):
    global _dropped
    with _lock:
        if len(_records) < MAX_RECORDS:
            _records.append(span)
        else:
            _dropped += 1


def enable(on=True, keep=True):
    """Turns the recorder on or off; what it holds stays until :func:`drain`.
    With ``keep`` false the spans run (their times, counts and profiler
    ranges) but none is held for :func:`drain`: for readers of the span
    objects themselves, which would otherwise fill the store."""
    global _ON, _KEEP
    _ON, _KEEP = bool(on), bool(keep)


def enabled():
    return _ON


def span(name, **attrs):
    """A context manager that records the enclosed block as the span
    ``name`` (attributes ``attrs``) while the recorder is on; the shared
    no-op :data:`OFF` while it is off, and for an :data:`IMAGE` span inside
    an open image."""
    if not _ON:
        return OFF
    if name == IMAGE:
        stack = _stack()
        if stack and stack[-1].image is not None:
            return OFF
    return Span(name, attrs)


def count(key, n=1):
    """Adds ``n`` to the count ``key`` of the thread's innermost open span
    (or, with none open in the thread, to the counts :func:`drain` returns
    on their own)."""
    if not _ON:
        return
    stack = _stack()
    top = stack[-1] if stack else None
    if isinstance(top, Span):
        top.counts[key] = top.counts.get(key, 0) + n
        return
    with _lock:
        _loose[key] = _loose.get(key, 0) + n


def carry(fn):
    """``fn`` wrapped for a pool: spans it opens in the pool's thread take
    the span open here now as their parent, and its image id."""
    if not _ON:
        return fn
    stack = _stack()
    if not stack:
        return fn
    base = _Carried(stack[-1].id, stack[-1].image)

    def carried(*args, **kwargs):
        saved = getattr(_local, 'stack', None)
        _local.stack = [base]
        try:
            return fn(*args, **kwargs)
        finally:
            _local.stack = saved

    return carried


def drain():
    """The finished spans since the last drain, and forgets them:
    ``{'spans': [dict], 'dropped': int, 'counts': dict}``. Each span's dict
    has the keys ``name, id, parent, image, thread, start, end, cpu, counts,
    attrs`` (times in seconds; ``parent`` and ``image`` may be None);
    ``counts`` holds the counts made outside any span."""
    global _records, _dropped, _loose
    with _lock:
        records, dropped, loose = _records, _dropped, _loose
        _records, _dropped, _loose = [], 0, {}
    spans = [dict(name=s.name, id=s.id, parent=s.parent, image=s.image, thread=s.thread,
                  start=s.start, end=s.end, cpu=s.cpu, counts=s.counts, attrs=s.attrs)
             for s in records]
    return dict(spans=spans, dropped=dropped, counts=loose)
