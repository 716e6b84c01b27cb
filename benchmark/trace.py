"""The traced sub-window of a ``--trace 1`` run: torch.profiler over a
bounded stretch of steady work, its Chrome trace read back into device
intervals, kernel sums, the busy union and the idle gaps named by what the
host was doing, then deleted. The harness marks its own phases with
record_function ranges (``bench.*``), the names the idle gaps carry.

A run over several cards profiles them all in one stretch: each device
event names its card (``args.device``), and the summary takes each card's
busy union and idle gaps apart, over the same stretch."""

from __future__ import annotations

import gzip
import json
import os
import shutil
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")


def busy_union(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, -float("inf")
    for a, z in sorted(intervals):
        if z > end:
            busy += z - max(a, end)
            end = z
    return busy


def card_of(event: dict) -> int:
    """The CUDA device index of a device event."""
    return int((event.get("args") or {}).get("device", 0))


class SubWindow:
    """Profile between start() and stop(); summary() reads the trace once.
    ``cards``: the CUDA device indices the run uses, each synchronized at
    start and stop and summarized apart (default: the current device, and
    the cards that events name)."""

    def __init__(self, cards: Optional[List[int]] = None):
        self.prof = None
        self.cards = list(cards) if cards else None
        self.t0 = self.t1 = 0.0
        self.events: Optional[List[dict]] = None

    def _sync(self) -> None:
        if torch.cuda.is_available():
            for c in self.cards or [torch.cuda.current_device()]:
                torch.cuda.synchronize(c)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._sync()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        d = tempfile.mkdtemp(prefix="bench_trace_")
        try:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                data = json.load(f)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        self.prof = None
        ev = data if isinstance(data, list) else data.get("traceEvents", [])
        self.events = [e for e in ev if e.get("ph") == "X" and "dur" in e]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def device_events(self) -> List[dict]:
        return [e for e in self.events if e.get("cat") in DEVICE_CATS]

    def kernel_time_s(self, match) -> float:
        """Seconds of device events whose name satisfies ``match``."""
        return sum(float(e["dur"]) for e in self.device_events() if match(str(e["name"]))) * 1e-6

    def summary(self) -> dict:
        """Each card's busy union over the stretch (``busy_by_card``) and
        their mean (``busy_s``); kernel time by name summed over the cards;
        the idle gaps of every card, named by card where there are more
        than one. On one card: that card's union, sums and gaps."""
        dev = self.device_events()
        per_card: Dict[int, list] = defaultdict(list)
        for e in dev:
            per_card[card_of(e)].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        cards = self.cards or sorted(per_card) or [0]
        busy = {c: busy_union(per_card.get(c, ())) * 1e-6 for c in cards}
        by_name: Dict[str, float] = defaultdict(float)
        for e in dev:
            by_name[str(e["name"])] += float(e["dur"]) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps: List[list] = []
        for c in cards:
            named = self._idle_gaps(sorted(per_card.get(c, ())))
            gaps += [[f"cuda:{c} {n}", g] for n, g in named] if len(cards) > 1 else named
        gaps = sorted(gaps, key=lambda kv: -kv[1])[:10]
        return {"busy_s": sum(busy.values()) / len(cards), "window_s": self.window_s,
                "busy_by_card": [[c, b] for c, b in busy.items()],
                "device_ops": [list(o) for o in ops], "idle_gaps": gaps,
                "n_device_events": len(dev)}

    def _idle_gaps(self, iv, longest: int = 400) -> List[list]:
        """Gaps between one card's device work inside the window, by the
        innermost host event and the harness range around their midpoint;
        seconds summed per name, the 10 largest."""
        if not iv:
            return []
        merged = [list(iv[0])]
        for a, z in iv[1:]:
            if a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], z)
            else:
                merged.append([a, z])
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        host = [e for e in self.events if e.get("cat") in HOST_CATS + ("user_annotation",)]
        if not host:
            return []
        st = np.array([float(e["ts"]) for e in host])
        en = st + np.array([float(e["dur"]) for e in host])
        du = en - st
        ann = np.array([e.get("cat") == "user_annotation" and str(e["name"]).startswith("bench.")
                        for e in host])
        out: Dict[str, float] = defaultdict(float)
        for g, a, z in gaps[:longest]:
            mid = 0.5 * (a + z)
            on = (st <= mid) & (en >= mid)
            inner = np.nonzero(on & ~ann)[0]
            outer = np.nonzero(on & ann)[0]
            name = (str(host[outer[np.argmax(du[outer])]]["name"]) if outer.size else "outside")
            name += ":" + (str(host[inner[np.argmin(du[inner])]]["name"]) if inner.size
                           else "no host op")
            out[name] += g * 1e-6
        rest = sum(g for g, _, _ in gaps[longest:]) * 1e-6
        if rest:
            out["shorter gaps"] += rest
        return [list(kv) for kv in sorted(out.items(), key=lambda kv: -kv[1])[:10]]
