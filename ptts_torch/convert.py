"""Weights carried across: the JAX package's host parameter dicts -> the
port's weight modules.

Both packages load a checkpoint into the same nested dict of numpy arrays
(``ptts_tpu.models.flowlm.load_weights`` / ``mimi.load_weights`` and their
ports in ptts_torch/models, or the JAX ``random_weights``). The functions
here turn such a dict into an ``nn.Module`` whose buffers carry the same
names (``in_proj``, ``flow.res.ada_w``, ``stages.0.up_w1``, ...), on one
device in one dtype, after applying the Q/K row permutation to the halves
RoPE layout once, as the JAX ``to_device`` does. The engine's own loader
goes through the same functions, so tests can feed identical weights to
both packages.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .config import FlowLMConfig, MimiConfig
from .ops.rope import permute_qk_rows_for_rope


class TensorTree(nn.Module):
    """A nested weight dict as buffers: dicts become submodules, lists
    ModuleLists, arrays buffers, None an absent (None) buffer. Python
    scalars (the Mimi stage strides) are left out: they come from the config."""

    def __init__(self, tree: Mapping, dtype: torch.dtype, device):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                self.add_module(name, TensorTree(leaf, dtype, device))
            elif isinstance(leaf, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    TensorTree(x, dtype, device) for x in leaf))
            elif leaf is None:
                self.register_buffer(name, None)
            elif isinstance(leaf, (np.ndarray, np.generic)):
                host = torch.from_numpy(np.array(leaf, dtype=np.float32))
                self.register_buffer(name, host.to(device=device, dtype=dtype))


def flowlm_weights(w: Mapping, cfg: FlowLMConfig = FlowLMConfig(),
                   dtype: torch.dtype = torch.float32, device="cpu") -> TensorTree:
    """FlowLM host dict -> device weights, in_proj in the halves RoPE layout."""
    if w["in_proj"].shape[-2] != 3 * cfg.d_model:
        raise ValueError("FlowLMConfig does not match the weights")
    w = dict(w)
    w["in_proj"] = permute_qk_rows_for_rope(np.asarray(w["in_proj"]), cfg.num_heads, cfg.head_dim)
    return TensorTree(w, dtype, device)


def mimi_weights(w: Mapping, cfg: MimiConfig = MimiConfig(),
                 dtype: torch.dtype = torch.float32, device="cpu") -> TensorTree:
    """Mimi host dict -> device weights, the transformer's in_proj in the
    halves RoPE layout (the test-only "_torch" views are dropped)."""
    w = {k: v for k, v in w.items() if k != "_torch"}
    tr = dict(w["transformer"])
    if tr["in_proj"].shape[-2] != 3 * cfg.num_heads * cfg.head_dim:
        raise ValueError("MimiConfig does not match the weights")
    tr["in_proj"] = permute_qk_rows_for_rope(np.asarray(tr["in_proj"]), cfg.num_heads,
                                             cfg.head_dim)
    w["transformer"] = tr
    return TensorTree(w, dtype, device)
