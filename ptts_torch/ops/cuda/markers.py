"""Marker kernels: empty launches that name the stretches of a step in a
device trace (ptts_torch/csrc/markers.cu).

``device_mark(FLOWLM, x)`` launches ``ptts_mark_flowlm`` on the current
stream of ``x``'s device (``MIMI``: ``ptts_mark_mimi``, ``END``:
``ptts_mark_end``); on a CPU tensor it does nothing. Inside a graph capture
the launch becomes a node of the graph, so every replay carries it.
"""

from __future__ import annotations

import torch

from . import build

FLOWLM, MIMI, END = 0, 1, 2
KERNELS = ("ptts_mark_flowlm", "ptts_mark_mimi", "ptts_mark_end")


def device_mark(which: int, like: torch.Tensor) -> None:
    """Launch marker ``which`` on the device of ``like``; nothing on the CPU."""
    if like.device.type != "cuda":
        return
    with torch.cuda.device(like.device):
        rc = build.library().ptts_mark(which, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = build.library().ptts_error_string(rc).decode()
        raise RuntimeError(f"{KERNELS[which]}: CUDA error {rc} ({msg})")
