"""Spans and counters at the port's layer boundaries.

``span(name, **attrs)`` is a context manager around one piece of host work:
the serving entry's copy-in, a sampler step, a graph replay, the feed's
next batch (PERF.md names each span and the metric that reads it).  A
record holds the name, its start and end in ns on ``time.time_ns()``'s
clock (``CLOCK_REALTIME``, the clock of ``torch.profiler``'s Chrome
trace: an event's ``ts`` plus the trace's ``baseTimeNanoseconds / 1000``
is that clock in µs), the span's id, its parent's, the thread's, its
group and its attributes.  ``batch=`` or ``step=`` among the attributes
starts a group: every span inside it carries ``("batch", id)`` or
``("step", id)``, so a reader can take one batch's or one step's spans
together.

Tracing is off unless a ``torch.profiler`` profile is active or the
caller is inside ``recording()``.  Off, ``span`` returns one shared null
context and records nothing.  On, each span is also entered as
``torch.profiler.record_function(name)``, so it lands in the profile's
trace beside the aten ops and the device's kernels, and its record goes
into a bounded buffer in memory (the oldest dropped), which ``records()``
returns and ``clear()`` empties.  Nothing is written to disk.

No span may sit inside a body that is captured into a CUDA graph: a host
span there runs at the first use and never at a replay.  Nor may one stay
open across a ``yield`` of a generator that another runs in turn on the
same thread (``serving/export.py``'s shards): it would misnest.

``count(name, n)`` adds to one counter of rare events, always on:
``graph.captures``, ``graph.replays`` and ``programs.built``.
``counters()`` returns them.  Kernel launches are counted apart, by
``ops/cuda_build.LAUNCHES``.

``timed(name)`` is a span that reads its clock even when tracing is off,
for a caller that keeps the seconds itself (``utils/cuda_graphs.py``'s
first use and capture): its ``seconds`` and its record share the readings.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

MAX_RECORDS = 200_000
COUNTERS = ("graph.captures", "graph.replays", "programs.built")
GROUPS = ("batch", "step")


class Record(NamedTuple):
    name: str
    start: int          # ns, time.time_ns()
    end: int            # ns
    id: int
    parent: int | None  # the enclosing span's id on this thread
    thread: int
    group: tuple | None  # ("batch", id) or ("step", id), from this span or its parents
    attrs: dict


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_counts: collections.Counter = collections.Counter(dict.fromkeys(COUNTERS, 0))
_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's open spans
_forced = 0                # recording() depth
_lock = threading.Lock()   # guards _forced and _counts


def enabled() -> bool:
    """Whether spans record: inside ``recording()`` or a profile."""
    return bool(_forced or _profiler._is_profiler_enabled)


class _Span:
    """One span; records on exit when ``keep``, and reads the clock either
    way."""
    __slots__ = ("name", "attrs", "keep", "start", "end", "id", "parent", "group", "thread",
                 "_rf")

    def __init__(self, name: str, attrs: dict, keep: bool, start: int):
        self.name, self.attrs, self.keep, self.start = name, attrs, keep, start

    def __enter__(self):
        if self.keep:
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            up = stack[-1] if stack else None
            self.id, self.parent = next(_ids), None if up is None else up.id
            self.group = next(((k, self.attrs[k]) for k in GROUPS if k in self.attrs),
                              None if up is None else up.group)
            self.thread = threading.get_ident()
            stack.append(self)
            self._rf = record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.keep:
            self._rf.__exit__(*exc)
            self._rf = None  # freed inside the span
            _open.stack.pop()
            self.end = time.time_ns()
            _records.append((self.name, self.start, self.end, self.id, self.parent,
                             self.thread, self.group, self.attrs))
        else:
            self.end = time.time_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


_NULL = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records ``name`` where tracing is on, and
    the shared null context where it is off."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _NULL
    # the start is read before the span is built, and the end once its
    # range has closed: a span's time holds its own bookkeeping, and its
    # parent's time between children does not
    return _Span(name, attrs, True, time.time_ns())


def timed(name: str, **attrs) -> _Span:
    """``span`` that reads the clock even off: ``.seconds`` after exit."""
    return _Span(name, attrs, enabled(), time.time_ns())


@contextlib.contextmanager
def recording():
    """Spans record inside this block, with or without a profile."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def records() -> list[Record]:
    """The buffer's records, oldest first (ended spans only)."""
    return [Record._make(r) for r in list(_records)]


def clear() -> None:
    _records.clear()


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counts[name] += n


def counters() -> dict:
    """name -> count, every counter of ``COUNTERS`` among them."""
    with _lock:
        return dict(_counts)
