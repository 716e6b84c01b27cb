"""Packed host -> device weight upload: one copy for a whole weight tree
(port of ptts_tpu/utils/packing.py).

``tree_to_device`` converts every float leaf of a nested tree into one host
buffer in the target dtype (pinned when the target is a CUDA device), ships
it with one non-blocking copy, and returns a tree of the same shape whose
float leaves are views of the one flat device tensor.

Every leaf starts at a 256-byte offset of that tensor. The JAX package's
unpack returns fresh device buffers; a torch view keeps its offset into the
flat buffer, and a bf16 leaf at an odd element offset would hand cuBLAS a
2-byte-aligned weight, which sends it to slower kernels. 256 bytes is the
alignment of a fresh allocation of the CUDA caching allocator.

The values equal a per-leaf conversion bit for bit: f32 leaves are copied,
and the bf16 cast is torch's round to nearest even, the rounding of the JAX
package's host conversion.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

ALIGN = 256  # bytes: the start of every packed leaf


class _Slot:
    """Placeholder for packed leaf ``index`` between the two passes."""

    def __init__(self, index: int):
        self.index = index


def _map(tree: Any, fn: Callable[[Any], Any]) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def _aligned_empty(n: int, dtype: torch.dtype, device: torch.device,
                   pin: bool = False) -> torch.Tensor:
    """A flat tensor of n elements whose data starts at a multiple of ALIGN bytes."""
    esize = torch.empty((), dtype=dtype).element_size()
    raw = torch.empty(n + ALIGN // esize, dtype=dtype, device=device, pin_memory=pin)
    shift = (-raw.data_ptr() % ALIGN) // esize
    return raw[shift : shift + n]


def tree_to_device(tree: Any, dtype: torch.dtype = torch.float32, device="cpu",
                   stats: Optional[Dict[str, float]] = None) -> Any:
    """The tree (nested dicts, lists and tuples) on ``device`` through one copy.

    Float leaves (numpy float arrays and scalars, float torch CPU tensors)
    are converted to ``dtype`` on the host and packed; the returned leaves
    are views of one flat tensor on ``device``, each at a 256-byte-aligned
    offset. Non-float arrays go across directly; None and Python scalars
    pass through. With ``stats``, adds the host seconds of the packing to
    ``stats["pack"]`` and those of the copy, waited for, to ``stats["copy"]``.
    """
    device = torch.device(device)
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    hosts: List[torch.Tensor] = []

    def collect(x):
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.asarray(x)
            if not (a.flags.c_contiguous and a.flags.writeable):
                a = np.array(a, order="C")  # keeps 0-d shapes, unlike ascontiguousarray
            x = torch.from_numpy(a)
        if not isinstance(x, torch.Tensor):
            return x                      # None, Python scalars
        if not x.is_floating_point():
            return x.to(device)           # a rare integer tensor: its own copy
        hosts.append(x.to(dtype))
        return _Slot(len(hosts) - 1)

    shaped = _map(tree, collect)
    if not hosts:
        return shaped
    step = ALIGN // torch.empty((), dtype=dtype).element_size()
    offsets, total = [], 0
    for h in hosts:
        offsets.append(total)
        total += -(-h.numel() // step) * step
    host = _aligned_empty(total, dtype, torch.device("cpu"), pin=on_card)
    for h, off in zip(hosts, offsets):
        host[off : off + h.numel()].copy_(h.reshape(-1))
    t1 = time.perf_counter()
    if on_card:
        flat = _aligned_empty(total, dtype, device)
        flat.copy_(host, non_blocking=True)
        if stats is not None:
            torch.cuda.current_stream(device).synchronize()
    else:
        flat = host
    t2 = time.perf_counter()
    if stats is not None:
        stats["pack"] = stats.get("pack", 0.0) + (t1 - t0)
        stats["copy"] = stats.get("copy", 0.0) + (t2 - t1)

    def unpack(x):
        if not isinstance(x, _Slot):
            return x
        h, off = hosts[x.index], offsets[x.index]
        return flat[off : off + h.numel()].view(h.shape)

    return _map(shaped, unpack)
