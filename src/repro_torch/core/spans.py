"""Spans at the port's layer boundaries, kept in one bounded ring in host
memory.

``with span(name, **attrs):`` records the name, its start and end on
`time.perf_counter_ns`, the span it opened inside (a per-thread stack), a
request id and the attributes. `repro.solve` and `repro.matmat` open a new
request; the spans inside them share it. A span that exits through an
exception is closed all the same.

The spans sit at layer boundaries only (the planner's stages, a solve, one
block of its guarded steps and the host read after it, a matmat's launch,
a kernel build), never per guarded step, per kernel launch or inside a
captured CUDA graph, so recording stays on by default: about two
microseconds a span on the H100 machine's host. `enable(False)` turns it off; `span` then hands back
one shared null context and records nothing.

While a `torch.profiler` is recording, each span also opens
``torch.profiler.record_function(name)``, so the device trace's host events
carry the port's span names on the profiler's own clock, and the record
notes that it was made under the profiler. `profiler_clock_ns` maps a
record's times onto that clock (kineto's wall-clock nanoseconds).

`records()` returns the spans oldest first (in the order they closed);
`dropped()` counts the records the ring overwrote. `self_ns`, `after_profiler`
and `last_planning` are the arithmetic the benchmark's readers share.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

__all__ = [
    "CAPACITY",
    "REQUESTS",
    "Recorder",
    "Span",
    "after_profiler",
    "dropped",
    "enable",
    "last_planning",
    "profiler_clock_ns",
    "records",
    "self_ns",
    "span",
]

#: Records the ring holds before it overwrites the oldest.
CAPACITY = 1 << 18
#: Span names that open a request of their own.
REQUESTS = frozenset({"repro.solve", "repro.matmat"})
#: The planner's spans (the prefix of their names) and the calls they plan.
PLAN_PREFIX = "repro.plan."

Span = collections.namedtuple(
    "Span", "name start_ns end_ns id parent request profiled attrs")
Span.__doc__ = """One closed span. Times are `time.perf_counter_ns`; ``parent``
and ``request`` are span ids, 0 for none; ``profiled`` says a
`torch.profiler` was recording when it opened; ``attrs`` is the dict of
keyword attributes (None without)."""

_NULL = contextlib.nullcontext()
_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class _Stack(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.open: list = []


class _Open:
    """One open span (the context manager `Recorder.span` returns)."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "request", "t0",
                 "prof", "stack")

    def __init__(self, rec: "Recorder", name: str, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        self.stack = stack = rec._local.open
        self.id = sid = next(rec._ids)
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
        else:
            self.parent = self.request = 0
        if self.name in REQUESTS:
            self.request = sid
        stack.append(self)
        self.prof = None
        self.t0 = _now()
        if _profiling():
            self.prof = torch.profiler.record_function(self.name)
            self.prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        prof = self.prof
        if prof is not None:
            prof.__exit__(exc_type, exc, tb)
        self.stack.pop()
        rec = self.rec
        slot = next(rec._slots)
        rec._ring[slot % rec.capacity] = (
            slot, self.name, self.t0, t1, self.id, self.parent, self.request,
            prof is not None, self.attrs)
        return False


class Recorder:
    """A bounded ring of spans, preallocated, shared by every thread of the
    process (each thread keeps its own stack of open spans). A closing span
    takes the next slot from an `itertools.count` (one step under the
    interpreter lock), so recording takes no lock."""

    def __init__(self, capacity: int = CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.enabled = True
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._slots = itertools.count()
        self._local = _Stack()
        self._ids = itertools.count(1)
        self._clock_offset: Optional[int] = None

    def span(self, name: str, **attrs):
        """A context manager that records `name` from entry to exit."""
        if not self.enabled:
            return _NULL
        return _Open(self, name, attrs or None)

    def _held(self) -> List[tuple]:
        return sorted(r for r in list(self._ring) if r is not None)

    def records(self) -> List[Span]:
        """The spans in the ring, oldest (first closed) first."""
        return [Span._make(r[1:]) for r in self._held()]

    def dropped(self) -> int:
        """Records the ring has overwritten."""
        held = self._held()
        return held[-1][0] + 1 - len(held) if held else 0

    def profiler_clock_ns(self, t_ns: int) -> int:
        """`t_ns` (a record's `time.perf_counter_ns`) on the profiler's clock:
        kineto stamps its events in wall-clock nanoseconds
        (`time.time_ns`). The offset is sampled once, the smallest of a few
        reads of the wall clock taken just after the counter."""
        if self._clock_offset is None:
            samples = []
            for _ in range(8):
                p = time.perf_counter_ns()
                samples.append(time.time_ns() - p)
            self._clock_offset = min(samples)
        return int(t_ns) + self._clock_offset


_default = Recorder()

#: The process's recorder, which the port's spans go to, and its methods.
span = _default.span
records = _default.records
dropped = _default.dropped
profiler_clock_ns = _default.profiler_clock_ns


def enable(flag: bool = True) -> None:
    """Turn the process's recording on or off."""
    _default.enabled = bool(flag)


# --------------------------------------------------------------------------
# Reading a record of spans


def self_ns(recs: Sequence[Span], name: str) -> int:
    """The self time (ns) of the spans of `recs` called `name`: each one's
    duration less the durations of its children among `recs`."""
    ids = {r.id for r in recs if r.name == name}
    total = 0
    for r in recs:
        if r.id in ids:
            total += r.end_ns - r.start_ns
        if r.parent in ids:
            total -= r.end_ns - r.start_ns
    return total


def after_profiler(recs: Sequence[Span]) -> Optional[List[Span]]:
    """The records after the last one made under a profiler (a traced
    window's untraced tail). None where the ring holds no record made under
    one (none was, or the ring has overwritten it)."""
    for i in range(len(recs) - 1, -1, -1):
        if recs[i].profiled:
            return list(recs[i + 1:])
    return None


def last_planning(recs: Sequence[Span], dropped_n: int = 0
                  ) -> Optional[List[Span]]:
    """The spans of the last planning: scanning back from the newest top-level
    span past every other top-level span (the calls), the last unbroken run
    of top-level `repro.plan.*` spans, with everything opened inside them.
    None where there is none, or where the run reaches the oldest record
    and the ring has dropped records (part of it may be gone)."""
    roots = [r for r in recs if r.parent == 0]
    chosen = set()
    complete = False
    for r in reversed(roots):
        if r.name.startswith(PLAN_PREFIX):
            chosen.add(r.id)
        elif chosen:
            complete = True
            break
    if not chosen or (not complete and dropped_n > 0):
        return None
    by_id: Dict[int, Span] = {r.id: r for r in recs}
    out = []
    for r in recs:
        root = r
        while root.parent != 0 and root.parent in by_id:
            root = by_id[root.parent]
        if root.parent == 0 and root.id in chosen:
            out.append(r)
    return out
