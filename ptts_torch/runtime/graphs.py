"""CUDA graphs: the port's counterpart of the JAX package's jitted, donated
hot loops (``jax.jit`` with ``donate_argnames``, a ``lax.scan`` or
``lax.while_loop`` inside).

A GraphCache holds captured graphs, keyed by every static shape and every
Python value their bodies branch on, and the static buffers those bodies
read and write. ``GraphCache.run(key, device, body)``:

  * the first ``warmup`` calls with a key (WARMUP = 2 by default): ``body()``
    runs eagerly on the device's side stream. That is the warm-up (cuBLAS
    and cuDNN handles and workspaces, allocator blocks) and it is each
    call's step: its outputs are returned. Two calls, so that a streaming
    session's first chunk never waits for a capture (step() dispatches
    frame 1 before it reads frame 0); the offline loop takes one, so that
    its first call captures;
  * the next call: ``body()`` is captured into a ``torch.cuda.CUDAGraph``
    that draws on the cache's memory pool for that device, then the graph
    is replayed;
  * later calls: replay only.

The body reads and writes its state in place, at fixed addresses, and
returns the tensors the caller reads after the step. Those outputs live in
the pool that the cache's graphs on the device share: a graph captured
later may reuse a block that an earlier one frees inside its own body, so
an output is valid only until the next replay of any graph of the cache.
Callers consume each output (a ``copy_`` into state, a readback into pinned
memory) in stream order before they replay again. The pool is one per cache
and device, not one per device: the graphs of one owner live and die
together and replay from one thread, while two owners (a batcher and a
streaming session) may replay from two threads; and PyTorch's allocator
refuses a capture into a pool whose graphs have all been freed. A Python
value that the body reads (a frame index, a threshold) is baked into the
graph: it must be in the key or be read from a device buffer that the
caller refills before the replay.

Counts that a body makes while it is captured (the tracer's
``utils/timing.count`` and the ``.launches`` and ``.shapes`` of every
kernel wrapper in ops/cuda/build.WRAPPERS) are held back and added again
at each replay, so they count the body's executions, as an eager body's
do. Each capture and each replay is a span (``ptts.graph.capture``,
``ptts.graph.replay``, with the key's first element).

Capture runs in ``capture_error_mode="thread_local"``: the server's handler
threads may write the device (a voice bank row) while the serving thread
captures. There is no eager fallback: an error in capture or replay
propagates, and a key whose capture failed is captured again next time.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Hashable

import torch

from ..ops.cuda import build
from ..utils import timing

# captures, their host seconds (capture_begin .. capture_end) and replays,
# over every GraphCache of the process; chip_smoke and the benches read them
STATS = {"captures": 0, "capture_s": 0.0, "replays": 0}

WARMUP = 2

_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_lock = threading.Lock()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's side stream for warm-ups and captures (made once)."""
    with _lock:
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        return _STREAMS[device]


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


class _Entry:
    __slots__ = ("calls", "graph", "outputs", "counts", "launches")

    def __init__(self):
        self.calls = 0
        self.graph = None
        self.outputs = None
        self.counts = None      # the tracer's counts made in the captured body
        self.launches = ()      # (wrapper, launches, shapes) made in it


def _launch_counts() -> list:
    return [(fn, fn.launches, collections.Counter(fn.shapes))
            for fn in build.WRAPPERS.values()]


def _held_launches(before: list) -> tuple:
    """The kernel launches counted since ``before`` (a capture's), taken
    back off the wrappers' counters: (wrapper, launches, shapes) each."""
    out = []
    for fn, n, shapes in before:
        if fn.launches != n:
            out.append((fn, fn.launches - n, fn.shapes - shapes))
            fn.launches = n
            fn.shapes.clear()
            fn.shapes.update(shapes)
    return tuple(out)


def _replay(entry: _Entry) -> None:
    entry.graph.replay()
    if entry.counts:
        timing.add_counts(entry.counts)
    for fn, n, shapes in entry.launches:
        fn.launches += n
        fn.shapes.update(shapes)


class GraphCache:
    """Captured graphs and their static buffers, for one owner (an engine's
    offline loop, a batcher's shards, a streaming session). The graphs read
    the owner's weights at their addresses, so a cache never outlives them."""

    def __init__(self):
        self._graphs: Dict[Hashable, _Entry] = {}
        self._buffers: Dict[Hashable, Any] = {}
        self._pools: Dict[torch.device, list] = {}   # device -> [handle, graphs in it]
        # held by a caller for the whole of a step that fills static buffers,
        # replays and reads them back (the buffers are shared by every call)
        self.lock = threading.RLock()

    def __len__(self) -> int:
        return sum(e.graph is not None for e in self._graphs.values())

    def buffers(self, key: Hashable, make: Callable[[], Any]) -> Any:
        """The static buffers stored under ``key``, made by ``make()`` at
        first use."""
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = make()
        return buf

    def run(self, key: Hashable, device, body: Callable[[], Any],
            warmup: int = WARMUP) -> Any:
        """One step of ``body`` on ``device``: eagerly on the side stream at
        the first ``warmup`` calls with ``key``, captured and replayed at
        the next, replayed after that. Returns the body's outputs."""
        dev = _device(device)
        entry = self._graphs.setdefault(key, _Entry())
        head = key[0] if isinstance(key, tuple) else key
        side = _side_stream(dev)
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            if entry.calls < warmup:
                side.wait_stream(cur)
                with torch.cuda.stream(side):
                    out = body()
                cur.wait_stream(side)
                entry.calls += 1
                return out
            if entry.graph is None:
                pool = self._pools.get(dev)
                if pool is None:
                    pool = self._pools[dev] = [torch.cuda.graph_pool_handle(), 0]
                graph = torch.cuda.CUDAGraph()
                side.wait_stream(cur)
                t0 = time.perf_counter()
                launches = _launch_counts()
                try:
                    with timing.span("ptts.graph.capture", key=head), \
                            timing.capture_counts() as counts, torch.cuda.stream(side):
                        graph.capture_begin(pool[0], capture_error_mode="thread_local")
                        try:
                            outputs = body()
                        finally:
                            graph.capture_end()
                except BaseException:
                    # a pool whose only graph failed cannot take another capture
                    if pool[1] == 0:
                        del self._pools[dev]
                    raise
                finally:
                    entry.launches = _held_launches(launches)
                pool[1] += 1
                cur.wait_stream(side)
                STATS["captures"] += 1
                STATS["capture_s"] += time.perf_counter() - t0
                entry.graph, entry.outputs, entry.counts = graph, outputs, dict(counts)
            with timing.span("ptts.graph.replay", key=head):
                _replay(entry)
            STATS["replays"] += 1
            return entry.outputs
