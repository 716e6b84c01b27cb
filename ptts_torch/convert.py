"""Weights carried across: the JAX package's host parameter dicts -> the
port's weight modules.

Both packages load a checkpoint into the same nested dict of host arrays
(``ptts_tpu.models.flowlm.load_weights`` / ``mimi.load_weights`` and their
ports in ptts_torch/models, or the JAX ``random_weights``); a bf16 load
holds torch.bfloat16 CPU tensors where the JAX one holds ml_dtypes arrays.
The functions here apply the Q/K row permutation to the halves RoPE layout
once, as the JAX ``to_device`` does, move the whole dict to one device in
one dtype through one packed copy (utils/packing.tree_to_device), and wrap
it in an ``nn.Module`` whose buffers carry the dict's names (``in_proj``,
``flow.res.ada_w``, ``stages.0.up_w1``, ...). The engine's loader goes
through the same functions (models/flowlm.to_device, models/mimi.to_device),
so tests can feed identical weights to both packages.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .config import FlowLMConfig, MimiConfig, is_hybrid
from .ops.rope import permute_qk_rows_for_rope
from .utils.packing import tree_to_device


class TensorTree(nn.Module):
    """A nested dict of device tensors as buffers: dicts become submodules,
    lists ModuleLists, tensors buffers, None an absent (None) buffer. Python
    scalars (the Mimi stage strides) are left out: they come from the config."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                self.add_module(name, TensorTree(leaf))
            elif isinstance(leaf, (list, tuple)):
                self.add_module(name, nn.ModuleList(TensorTree(x) for x in leaf))
            elif leaf is None or isinstance(leaf, torch.Tensor):
                self.register_buffer(name, leaf)


def flowlm_weights(w: Mapping, cfg: FlowLMConfig = FlowLMConfig(),
                   dtype: torch.dtype = torch.float32, device="cpu",
                   stats: Optional[Dict[str, float]] = None) -> TensorTree:
    """FlowLM host dict -> device weights, in_proj in the halves RoPE layout
    (a hybrid backbone, which has no RoPE, as it is). ``stats``: see
    utils/packing.tree_to_device."""
    w = dict(w)
    if is_hybrid(cfg):
        if w["hybrid"]["mlp_in"].shape[-1] != cfg.d_model:
            raise ValueError("FlowLMConfig does not match the weights")
    else:
        if w["in_proj"].shape[-2] != 3 * cfg.d_model:
            raise ValueError("FlowLMConfig does not match the weights")
        w["in_proj"] = permute_qk_rows_for_rope(w["in_proj"], cfg.num_heads, cfg.head_dim)
    return TensorTree(tree_to_device(w, dtype, device, stats))


def mimi_weights(w: Mapping, cfg: MimiConfig = MimiConfig(),
                 dtype: torch.dtype = torch.float32, device="cpu",
                 stats: Optional[Dict[str, float]] = None) -> TensorTree:
    """Mimi host dict -> device weights, the transformer's in_proj in the
    halves RoPE layout (the test-only "_torch" views are dropped)."""
    w = {k: v for k, v in w.items() if k != "_torch"}
    tr = dict(w["transformer"])
    if tr["in_proj"].shape[-2] != 3 * cfg.num_heads * cfg.head_dim:
        raise ValueError("MimiConfig does not match the weights")
    tr["in_proj"] = permute_qk_rows_for_rope(tr["in_proj"], cfg.num_heads, cfg.head_dim)
    w["transformer"] = tr
    return TensorTree(tree_to_device(w, dtype, device, stats))
