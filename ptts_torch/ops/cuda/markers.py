"""Marker kernels: empty launches that name the stretches of a step in a
device trace (ptts_torch/csrc/markers.cu).

``device_mark(FLOWLM, x)`` launches ``ptts_mark_flowlm`` on the current
stream of ``x``'s device (``MIMI``: ``ptts_mark_mimi``, ``END``:
``ptts_mark_end``, ``SSM_IN``/``SSM_OUT``: ``ptts_mark_ssm_in``/``_out``); on
a CPU tensor it does nothing. Inside a graph capture
the launch becomes a node of the graph, so every replay carries it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

FLOWLM, MIMI, END, SSM_IN, SSM_OUT = 0, 1, 2, 3, 4
KERNELS = ("ptts_mark_flowlm", "ptts_mark_mimi", "ptts_mark_end", "ptts_mark_ssm_in",
           "ptts_mark_ssm_out")
build.declare("ptts_mark", [ctypes.c_int, ctypes.c_void_p])


def device_mark(which: int, like: torch.Tensor) -> None:
    """Launch marker ``which`` on the device of ``like``; nothing on the CPU."""
    if like.device.type != "cuda":
        return
    with torch.cuda.device(like.device):
        rc = build.entry("ptts_mark")(which, torch.cuda.current_stream().cuda_stream)
    build.raise_on(rc, KERNELS[which])
