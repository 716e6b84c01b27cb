"""What the per-layer readers of the program's own tracing share: the
tracer's records in a traced run's host window (ptts_torch/utils/timing),
and the device time between the program's marker kernels in the profiled
stretch (ptts_torch/csrc/markers.cu). A program without a tracer ring or
markers gives nothing to read: each helper then returns None, and so does
the metric."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Optional, Tuple

from .trace import busy_union, card_of


def tracer_records() -> Optional[List[tuple]]:
    """The program tracer's records, oldest first, each (kind, name, t0,
    t1, sid, parent, data); None where the program keeps no ring."""
    from ptts_torch.utils import timing
    records = getattr(timing, "records", None)
    return None if records is None else records()


def host_window(obs: dict, recs: Optional[List[tuple]]) -> Optional[Tuple[float, float]]:
    """(a, z): the traced run's host window on perf_counter, the
    ``flops_window_s`` that ends where the harness cut its host metrics,
    just before the profiler started. Starting the profiler takes seconds,
    so the cut is read from the records: ``z`` is the end of the last
    record made before the profiled stretch (the cut is at most one loop
    iteration earlier). None untraced, or with no ring or no record."""
    sub, w = obs.get("sub"), obs.get("flops_window_s")
    if sub is None or not w or not recs:
        return None
    z = max((r[3] for r in recs if r[3] < sub.t0), default=None)
    return None if z is None else (z - w, z + 1e-9)


def window_records(obs: dict) -> Optional[List[tuple]]:
    """The tracer's records that end inside the host window; None when
    there is no window or no ring."""
    recs = tracer_records() if obs.get("sub") is not None else None
    win = host_window(obs, recs)
    if win is None:
        return None
    a, z = win
    return [r for r in recs if a <= r[3] < z]


def marker_ms_per_frame(obs: dict, start: str, stop: str) -> Optional[float]:
    """The busy union of the profiled stretch's device events from each
    ``start`` marker kernel to the next ``stop`` marker on the same card
    (the events that start in between, cut at ``stop``), in ms per pool
    frame: over several cards, the mean of the cards that ran such a pair,
    as ``busy_s`` is. None where no such pair is in the stretch."""
    sub, info = obs.get("sub"), obs.get("sub_info") or {}
    if sub is None or sub.events is None or not info.get("frames"):
        return None
    by_card = defaultdict(list)
    for e in sub.device_events():
        by_card[card_of(e)].append(e)
    busy = []
    for events in by_card.values():
        b, pairs, open_at, iv = 0.0, 0, None, []
        for e in sorted(events, key=lambda e: float(e["ts"])):
            name, ts = str(e["name"]), float(e["ts"])
            if name.startswith(start):
                open_at, iv = ts, []
            elif name.startswith(stop) and open_at is not None:
                b += busy_union([(a, min(z, ts)) for a, z in iv if a < ts])
                pairs, open_at = pairs + 1, None
                continue
            if open_at is not None:
                iv.append((ts, ts + float(e["dur"])))
        if pairs:
            busy.append(b)
    if not busy:
        return None
    return sum(busy) / len(busy) * 1e-3 / info["frames"]


def idle_inside(sub, range_name: str) -> Optional[float]:
    """Seconds of device idle in the profiled stretch whose gap (between
    merged device intervals) has its midpoint inside a host range named
    ``range_name``; None where the trace has no such range."""
    if sub is None or sub.events is None:
        return None
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in sub.events
                    if e.get("cat") == "user_annotation" and e.get("name") == range_name)
    if not ranges:
        return None
    starts = [a for a, _ in ranges]
    # the latest end among the ranges that start at or before each one
    reach, top = [], -float("inf")
    for _, z in ranges:
        top = max(top, z)
        reach.append(top)
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in sub.device_events())
    idle, end = 0.0, None
    for a, z in iv:
        if end is not None and a > end:
            mid = 0.5 * (a + end)
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and reach[i] >= mid:
                idle += a - end
        end = z if end is None else max(end, z)
    return idle * 1e-6
