"""Device-level profiling (port of ptts_tpu/utils/profiling.py).

Two pieces:

  * ``device_trace(label)`` -- context manager around torch.profiler
    (CPU activity always, CUDA activity when a card is visible). Active
    when PTTS_PROFILE is set (or ``force=True``); writes a gzipped Chrome
    trace into a fresh directory under $PTTS_PROFILE_DIR/<label> (default
    base: ptts_profile in the temp directory, which honours TMPDIR), so two
    runs with one label never read each other's trace.

  * ``summarize_trace(dir)`` -- reads the newest trace there and returns the
    DEVICE events (the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
    categories) aggregated by name; ``busy_us(dir)`` the union of their
    intervals.

Usage:
    with device_trace("serve", force=True) as d:
        ...; torch.cuda.synchronize()
    print(format_summary(d))
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_enabled() -> bool:
    return os.environ.get("PTTS_PROFILE", "0") not in ("", "0")


def profile_dir(label: str) -> str:
    base = os.environ.get("PTTS_PROFILE_DIR",
                          os.path.join(tempfile.gettempdir(), "ptts_profile"))
    return os.path.join(base, label)


@contextlib.contextmanager
def device_trace(label: str, force: bool = False):
    """Profile a code region when profiling is on; on exit, write its Chrome
    trace into a new directory of its own under profile_dir(label).

    Yields that directory (or None when disabled). The caller must
    synchronize the device inside the region for its events to be complete.
    """
    if not (force or profile_enabled()):
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    base = profile_dir(label)
    os.makedirs(base, exist_ok=True)
    out = tempfile.mkdtemp(prefix="run_", dir=base)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out
    prof.export_chrome_trace(os.path.join(out, f"trace_{time.time_ns()}.json.gz"))


def _latest_trace(trace_dir: str) -> Optional[str]:
    paths = (glob.glob(os.path.join(trace_dir, "*.json"))
             + glob.glob(os.path.join(trace_dir, "*.json.gz")))
    return max(paths, key=lambda p: (os.path.getmtime(p), p)) if paths else None


def _events(trace_dir: str) -> List[dict]:
    """The complete ("X") events of the newest trace in trace_dir."""
    path = _latest_trace(trace_dir)
    if path is None:
        raise FileNotFoundError(f"no Chrome trace (*.json, *.json.gz) under {trace_dir}")
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        data = json.load(f)
    events = data if isinstance(data, list) else data.get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X"]


def device_events(trace_dir: str) -> List[dict]:
    """The device events (kernels, copies, sets) of the newest trace in
    trace_dir, in start-time order."""
    return sorted((e for e in _events(trace_dir) if e.get("cat") in DEVICE_CATEGORIES),
                  key=lambda e: float(e["ts"]))


def summarize_trace(trace_dir: str) -> Dict[str, dict]:
    """Aggregate device event durations of the newest trace in trace_dir.

    Returns {name: {"total_us": float, "count": int, "max_us": float}},
    covering only device events (host events are dropped).
    """
    agg: Dict[str, dict] = defaultdict(lambda: {"total_us": 0.0, "count": 0, "max_us": 0.0})
    for e in device_events(trace_dir):
        dur = float(e.get("dur", 0.0))
        a = agg[str(e.get("name", ""))]
        a["total_us"] += dur
        a["count"] += 1
        a["max_us"] = max(a["max_us"], dur)
    return dict(agg)


def busy_us(trace_dir: str) -> float:
    """Device busy time in us: the union of the device events' intervals
    (the caller divides it by its own wall clock)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in device_events(trace_dir))
    busy, end = 0.0, -float("inf")
    for a, z in spans:
        if z > end:
            busy += z - max(a, end)
            end = z
    return busy


def launch_calls(trace_dir: str) -> Dict[str, int]:
    """The host's launch calls in the newest trace in trace_dir, from its
    CUDA runtime and driver events: "kernel" (cudaLaunchKernel and kin),
    "graph" (cudaGraphLaunch: one replays a whole captured graph) and
    "copy" (memcpy and memset calls)."""
    out = {"kernel": 0, "graph": 0, "copy": 0}
    for e in _events(trace_dir):
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        name = str(e.get("name", ""))
        if "GraphLaunch" in name:
            out["graph"] += 1
        elif "LaunchKernel" in name:
            out["kernel"] += 1
        elif "Memcpy" in name or "Memset" in name:
            out["copy"] += 1
    return out


def top_ops(trace_dir: str, n: int = 20) -> List[Tuple[str, dict]]:
    agg = summarize_trace(trace_dir)
    return sorted(agg.items(), key=lambda kv: -kv[1]["total_us"])[:n]


def format_summary(trace_dir: str, n: int = 20, width: int = 60) -> str:
    rows = top_ops(trace_dir, n)
    total = sum(v["total_us"] for _, v in rows)
    lines = [f"{'op':<{width}}{'total ms':>10}{'count':>8}{'max us':>10}"]
    for name, v in rows:
        shown = name if len(name) <= width - 1 else name[: width - 4] + "..."
        lines.append(f"{shown:<{width}}{v['total_us'] / 1000:>10.3f}{v['count']:>8}"
                     f"{v['max_us']:>10.1f}")
    lines.append(f"{'TOTAL (top shown)':<{width}}{total / 1000:>10.3f}")
    return "\n".join(lines)
