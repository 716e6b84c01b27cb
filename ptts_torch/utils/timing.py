"""Timing/tracing spans, the PTTS_TIMING analogue.

The reference gates wall-clock stderr spans on the PTTS_TIMING env var
(reference/ptts.c:31-44, ptts_internal.h:16-17). Same contract here,
plus an in-process stats registry the serving layer can export.

    PTTS_TIMING=1 python -m ptts_torch.cli ...
        [ptts] FlowLM latents: 12.34 ms (50 frames)
        [ptts] Mimi decode: 5.67 ms

For device profiles use ptts_torch/utils/profiling.py (torch.profiler
traces) -- these spans are the cheap always-available layer. The port's
copy of ptts_tpu/utils/timing.py.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

_enabled: Optional[bool] = None


def timing_enabled() -> bool:
    global _enabled
    if _enabled is None:
        v = os.environ.get("PTTS_TIMING", "")
        _enabled = bool(v) and v != "0"
    return _enabled


def time_ms() -> float:
    return time.perf_counter() * 1000.0


class Stats:
    """Span accumulator: count/total/min/max per label."""

    def __init__(self) -> None:
        self._spans: Dict[str, List[float]] = defaultdict(list)

    def record(self, label: str, ms: float) -> None:
        self._spans[label].append(ms)

    def summary(self) -> Dict[str, dict]:
        out = {}
        for label, xs in self._spans.items():
            out[label] = {
                "count": len(xs),
                "total_ms": round(sum(xs), 3),
                "min_ms": round(min(xs), 3),
                "max_ms": round(max(xs), 3),
                "mean_ms": round(sum(xs) / len(xs), 3),
            }
        return out

    def reset(self) -> None:
        self._spans.clear()


GLOBAL_STATS = Stats()


@contextlib.contextmanager
def span(label: str, detail: str = "", stats: Optional[Stats] = None) -> Iterator[None]:
    """Wall-clock span; prints to stderr when PTTS_TIMING is set and always
    records into the stats registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1000.0
        (stats or GLOBAL_STATS).record(label, ms)
        if timing_enabled():
            suffix = f" ({detail})" if detail else ""
            print(f"[ptts] {label}: {ms:.2f} ms{suffix}", file=sys.stderr)
