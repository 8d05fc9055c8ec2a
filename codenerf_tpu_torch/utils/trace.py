"""Spans: named intervals of the host's work at the port's layer
boundaries, kept in memory while tracing is on.

    trace.enable()
    with trace.span("train.step", step=state.step):   # a step's root
        with trace.span("train.forward"):             # its child
            ...
    spans = trace.drain()

A span given ``step`` is the root of that step; every span opened inside
it on the same thread carries its step id and points to it as parent.
Spans on another thread (the loader's worker) have no parent there and
step id ``None``.  A span names its thread twice: by its native id, the
``tid`` of a ``torch.profiler`` trace's host operators, and by its
``threading.get_ident`` (``pthread_self``), whose low 32 bits are the
``tid`` CUPTI gives the CUDA runtime calls in the same trace.  Each span is timed with ``time.perf_counter_ns``;
``drain`` puts its times on the Unix clock through one
(``perf_counter_ns``, ``time_ns``) pair taken at ``enable``, the clock of
a ``torch.profiler`` Chrome trace (``ts`` x 1000 + ``baseTimeNanoseconds``),
and ``chrome_events`` writes them as that trace's events.

With tracing off, ``span`` is one check of a module flag and returns one
shared no-op context: no clock read, no allocation, no per-thread stack.
The module imports no torch and makes no CUDA call, on or off: no event,
no synchronisation, no stream work.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from typing import NamedTuple, Optional

CAP = 200_000               # spans a buffer holds; later ones are dropped

_on = False
_records: list = []         # [name, step, parent, tid, ident, t0, t1]
_dropped = 0
_clock = (0, 0)             # (perf_counter_ns, time_ns) at enable()
_lock = threading.Lock()
_local = threading.local()


class Span(NamedTuple):
    """A drained span: ``parent`` is the index of its parent in the same
    drain (-1: none); ``tid`` the native thread id, ``ident`` the thread's
    ``threading.get_ident``; times are Unix nanoseconds (``end_ns`` None
    while the span was still open)."""
    name: str
    step: Optional[int]
    parent: int
    tid: int
    ident: int
    start_ns: int
    end_ns: Optional[int]


_OFF = contextlib.nullcontext()


class _On:
    __slots__ = ("name", "step", "rec", "stack")

    def __init__(self, name, step):
        self.name, self.step = name, step

    def __enter__(self):
        global _dropped
        here = getattr(_local, "here", None)
        if here is None:
            # the native id is a system call: read once per thread
            here = _local.here = ([], threading.get_native_id(),
                                  threading.get_ident())
        stack, tid, ident = here
        parent = stack[-1] if stack else None
        step = self.step if self.step is not None else (
            parent[1] if parent is not None else None)
        rec = [self.name, step, parent, tid, ident, 0, None]
        with _lock:
            if len(_records) >= CAP:
                _dropped += 1
                self.rec = None
                return None
            _records.append(rec)
        self.rec, self.stack = rec, stack
        stack.append(rec)
        rec[5] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        if self.rec is not None:
            self.rec[6] = t
            self.stack.pop()
        return False


def span(name: str, step: Optional[int] = None):
    """A context manager timing the block as span ``name``; ``step``
    makes it a step's root with that id."""
    if not _on:
        return _OFF
    return _On(name, step)


def enable() -> None:
    """Start recording into an empty buffer of at most ``CAP`` spans
    (later ones are counted and dropped)."""
    global _on, _records, _dropped, _clock
    with _lock:
        _records, _dropped = [], 0
        _clock = (time.perf_counter_ns(), time.time_ns())
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain``."""
    global _on
    _on = False


def drain() -> list:
    """The recorded spans as ``Span``s in the order they opened, on the
    Unix clock, and an empty buffer.  A parent drained earlier reads -1."""
    global _records, _dropped
    with _lock:
        recs, dropped = _records, _dropped
        _records, _dropped = [], 0
    if dropped:
        warnings.warn(f"{dropped} spans past the cap of {CAP} were not "
                      "recorded", RuntimeWarning, stacklevel=2)
    pc0, wall0 = _clock
    index = {id(r): i for i, r in enumerate(recs)}
    return [Span(name, step, index.get(id(parent), -1), tid, ident,
                 t0 - pc0 + wall0, None if t1 is None else t1 - pc0 + wall0)
            for name, step, parent, tid, ident, t0, t1 in recs]


def chrome_events(spans: list, base_ns: int, pid: int) -> list:
    """``spans`` as Chrome trace events of category ``program_span`` on a
    trace whose ``baseTimeNanoseconds`` is ``base_ns`` (``ts`` and
    ``dur`` in microseconds, ``tid`` the native thread id, as a
    ``torch.profiler`` trace has them for host operators; ``args`` holds
    the step, the parent's index and the thread's ident); open spans are
    left out."""
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
             "tid": s.tid, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"step": s.step, "parent": s.parent, "index": i,
                      "ident": s.ident}}
            for i, s in enumerate(spans) if s.end_ns is not None]
