"""The port's tracer: spans, events and counts at the layer boundaries, the
PTTS_TIMING analogue.

The reference gates wall-clock stderr spans on the PTTS_TIMING env var
(reference/ptts.c:31-44, ptts_internal.h:16-17). Same contract here:

    PTTS_TIMING=1 python -m ptts_torch.cli ...
        [ptts] FlowLM latents: 12.34 ms (50 frames)
        [ptts] Mimi decode: 5.67 ms

Beyond it, always on:

  * ``span(name, **attrs)`` (a context manager) records its name, its start
    and end on ``time.perf_counter``, its parent (the innermost span open on
    the same thread) and its attributes (a request's ``rid``, lengths, a
    graph key) into a bounded ring of the newest CAPACITY records, and adds
    its duration to the running aggregates of its label (``GLOBAL_STATS``:
    count, total, min, max, whatever the number of calls);
  * ``event(name, t=None, **attrs)`` records an instant (a request's stamp);
  * ``count(name, n=1)`` records a count and adds it to ``counters()``.

``records()`` returns the ring, oldest first, as plain tuples whose fields
are KIND, NAME, T0, T1, SID, PARENT, DATA (SID: a span's id, 0 for events
and counts; PARENT: the enclosing span's id, 0 for none; DATA: a span's or
an event's attributes, a dict or None; a count's n). A span is written when
it ends. While a ``torch.profiler`` records, each span also opens
``record_function`` under its name (prefixed ``ptts.`` where it lacks it),
so the program's spans sit in the Chrome trace on the device events'
clock; otherwise that costs one check.

Inside a CUDA graph capture (runtime/graphs) the counts of the capturing
thread are held back (``capture_counts``) and added again at every replay
(``add_counts``), so a count made in a captured body counts executions.

For device profiles use ptts_torch/utils/profiling.py. The JAX package's
ptts_tpu/utils/timing.py has ``Stats`` and ``span`` with the same summary.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

_enabled: Optional[bool] = None

CAPACITY = 1 << 17      # records in the ring: a 51 s window of 400 req/s serving
MAX_LABELS = 4096       # labels with aggregates; later labels reach the ring only

SPAN, EVENT, COUNT = "span", "event", "count"
KIND, NAME, T0, T1, SID, PARENT, DATA = range(7)   # the fields of a record

_perf = time.perf_counter
_profiling = torch.autograd._profiler_enabled


def timing_enabled() -> bool:
    global _enabled
    if _enabled is None:
        v = os.environ.get("PTTS_TIMING", "")
        _enabled = bool(v) and v != "0"
    return _enabled


class Stats:
    """Span accumulator: count/total/min/max per label (ms), kept as running
    aggregates, so its size does not grow with the number of calls."""

    def __init__(self, max_labels: int = MAX_LABELS) -> None:
        self._agg: Dict[str, list] = {}
        self._lock = threading.Lock()
        self.max_labels = max_labels

    def record(self, label: str, ms: float) -> None:
        lock = self._lock
        lock.acquire()
        try:
            a = self._agg.get(label)
            if a is None:
                if len(self._agg) < self.max_labels:
                    self._agg[label] = [1, ms, ms, ms]
                return
            a[0] += 1
            a[1] += ms
            if ms < a[2]:
                a[2] = ms
            if ms > a[3]:
                a[3] = ms
        finally:
            lock.release()

    def summary(self) -> Dict[str, dict]:
        with self._lock:
            items = [(label, list(a)) for label, a in self._agg.items()]
        return {label: {"count": n, "total_ms": round(total, 3), "min_ms": round(lo, 3),
                        "max_ms": round(hi, 3), "mean_ms": round(total / n, 3)}
                for label, (n, total, lo, hi) in items}

    def reset(self) -> None:
        with self._lock:
            self._agg.clear()


GLOBAL_STATS = Stats()


class _Ring:
    """The newest ``capacity`` records; slots are claimed in order by an
    atomic counter, so threads never write one slot twice."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self.buf: List[Optional[tuple]] = [None] * capacity
        self.slots = itertools.count()
        self.n = 0

    def append(self, rec: tuple) -> None:
        i = next(self.slots)
        self.buf[i % self.capacity] = rec
        self.n = i + 1

    def snapshot(self) -> List[tuple]:
        n, cap, buf = self.n, self.capacity, self.buf
        out = buf[n % cap:] + buf[:n % cap] if n > cap else buf[:n]
        return [r for r in out if r is not None]

    def clear(self) -> None:
        self.buf[:] = [None] * self.capacity
        self.slots = itertools.count()
        self.n = 0


_ring = _Ring(CAPACITY)
_ids = itertools.count(1)
_counts: Dict[str, int] = collections.Counter()
_counts_lock = threading.Lock()


class _Local(threading.local):
    held = None                   # a capture's counts (capture_counts), or None

    def __init__(self) -> None:
        self.stack: List[int] = []   # the ids of the spans open on this thread


_local = _Local()


def trace_name(name: str) -> str:
    """The name of a span's range in a profiler trace."""
    return name if name.startswith("ptts.") else "ptts." + name


class span:
    """A wall-clock span, used as ``with span(name, **attrs) as s:``. Always
    recorded (ring and aggregates); printed to stderr when PTTS_TIMING is
    set, with ``detail``; a profiler range while a profiler records.
    ``stats``: the aggregates to add to (default GLOBAL_STATS). ``s.t0``,
    ``s.t1``: its perf_counter reads, for callers that reuse them."""

    __slots__ = ("name", "detail", "stats", "attrs", "t0", "t1", "sid", "parent", "_rf")

    def __init__(self, name: str, detail: str = "", stats: Optional[Stats] = None,
                 **attrs) -> None:
        self.name, self.detail, self.stats, self.attrs = name, detail, stats, attrs
        self._rf = None

    def __enter__(self) -> "span":
        stack = _local.stack
        self.parent = stack[-1] if stack else 0
        self.sid = sid = next(_ids)
        stack.append(sid)
        if _profiling():
            self._rf = torch.autograd.profiler.record_function(trace_name(self.name))
            self._rf.__enter__()
        self.t0 = _perf()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = t1 = _perf()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _local.stack.pop()
        ring = _ring              # _Ring.append, inline on the hot path
        i = next(ring.slots)
        ring.buf[i % ring.capacity] = (SPAN, self.name, self.t0, t1, self.sid, self.parent,
                                       self.attrs or None)
        ring.n = i + 1
        ms = (t1 - self.t0) * 1000.0
        (self.stats or GLOBAL_STATS).record(self.name, ms)
        if _enabled is False:
            return
        if timing_enabled():
            suffix = f" ({self.detail})" if self.detail else ""
            print(f"[ptts] {self.name}: {ms:.2f} ms{suffix}", file=sys.stderr)


def event(name: str, t: Optional[float] = None, **attrs) -> None:
    """An instant at perf_counter time ``t`` (default: now), in the ring."""
    if t is None:
        t = _perf()
    stack = _local.stack
    _ring.append((EVENT, name, t, t, 0, stack[-1] if stack else 0, attrs or None))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``: a record in the ring (now) and the
    running total; held back while the thread captures a graph."""
    held = _local.held
    if held is not None:
        held[name] += n
        return
    stack = _local.stack
    t = _perf()
    _ring.append((COUNT, name, t, t, 0, stack[-1] if stack else 0, n))
    with _counts_lock:
        _counts[name] += n


def counters() -> Dict[str, int]:
    """Every counter's total so far."""
    with _counts_lock:
        return dict(_counts)


@contextlib.contextmanager
def capture_counts() -> Iterator[collections.Counter]:
    """Hold back this thread's counts for the block (a graph capture) and
    yield them, by name, for ``add_counts`` at each replay."""
    prev = _local.held
    held = _local.held = collections.Counter()
    try:
        yield held
    finally:
        _local.held = prev


def add_counts(counts: Dict[str, int]) -> None:
    """Count again what a captured body counted (``capture_counts``)."""
    for name, n in counts.items():
        count(name, n)


def records() -> List[tuple]:
    """The ring's records, oldest first."""
    return _ring.snapshot()


def clear() -> None:
    """Empty the ring and the counters (the aggregates: GLOBAL_STATS.reset)."""
    _ring.clear()
    with _counts_lock:
        _counts.clear()
