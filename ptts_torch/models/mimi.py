"""Mimi decoder: acoustic latents -> 24 kHz waveform (port of
ptts_tpu/models/mimi.py).

Quantizer out-proj -> depthwise transposed upsample (12.5 -> 200 Hz) ->
sliding-window depth transformer -> SEANet transposed-conv stack, batch-first
and channels-last at the function boundaries as in the JAX package. The
transformer's attention is the fused RoPE + window kernel
(ops/cuda/fused_attention.window_attention_qkv) or, with
``window_impl="plain"``, its plain version. ``w`` is the module from
to_device (ptts_torch.convert.mimi_weights), buffers named as the JAX host
dict.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import convert
from ..config import MimiConfig, resolve_kernel_impl
from ..ops.activations import gelu_tanh
from ..ops.conv import (conv1d_causal, convtr1d_2s, elu, prepare_conv_kernel,
                        prepare_convtr_halves)
from ..ops.cuda.fused_attention import window_attention_qkv, window_attention_qkv_plain
from ..ops.norms import layernorm
from .flowlm import _linear


def resolve_window_impl(choice: str = "auto", device="cpu") -> str:
    """The windowed attention for an engine on ``device``: "kernel" (B2,
    ops/cuda/fused_attention.window_attention_qkv) or "plain" (its plain
    version). "auto" consults PTTS_PALLAS_WINDOW (0 -> plain, 1 -> kernel),
    then the device; "kernel" on a CPU device raises ValueError
    (config.resolve_kernel_impl)."""
    on_card = torch.device(device).type == "cuda"
    return resolve_kernel_impl(choice, "PTTS_PALLAS_WINDOW", on_card, "window_impl")


# ---------------------------------------------------------------------------
# Weight loading (numpy; returns the same host dict as the JAX load_weights)
# ---------------------------------------------------------------------------


def _find(st, name: str):
    """exact -> 'mimi.' -> 'model.' -> suffix."""
    for cand in (name, "mimi." + name, "model." + name):
        t = st.find(cand)
        if t is not None:
            return t
    for cand in st.tensors:
        if cand.name.endswith(name):
            return cand
    return None


def _get(st, name: str, optional: bool = False) -> Optional[np.ndarray]:
    t = _find(st, name)
    if t is None:
        if optional:
            return None
        raise KeyError(f"Missing tensor: {name}")
    return st.get_f32(t)


def load_weights(st, cfg: MimiConfig = MimiConfig()) -> dict:
    """The Mimi host dict (f32 numpy, conv kernels prepared) from a
    SafetensorsFile; leaf for leaf the dict ptts_tpu.models.mimi.load_weights
    returns."""
    L = cfg.num_layers

    def stack(fmt: str, optional: bool = False):
        vals = [_get(st, fmt.format(i), optional=optional) for i in range(L)]
        return None if any(v is None for v in vals) else np.stack(vals)

    quant = _get(st, "quantizer.output_proj.weight").reshape(cfg.d_model, cfg.latent_dim)
    up_w = _get(st, "upsample.convtr.weight", optional=True)
    if up_w is None:
        up_w = _get(st, "upsample.convtr.convtr.weight")
    up_w1, up_w2 = prepare_convtr_halves(up_w, groups=cfg.d_model)

    # decoder.model indices: 0 conv, then per stage (ELU, convtr, resblock)
    # at 2/3, 5/6, 8/9, and the final ELU + conv at 11
    stages = []
    idx = 2
    for ratio in cfg.ratios:
        s_w1, s_w2 = prepare_convtr_halves(_get(st, f"decoder.model.{idx}.convtr.weight"),
                                           groups=1)
        res = f"decoder.model.{idx + 1}.block"
        stages.append({
            "up_w1": s_w1,
            "up_w2": s_w2,
            "up_bias": _get(st, f"decoder.model.{idx}.convtr.bias"),
            "res1_kernel": prepare_conv_kernel(_get(st, f"{res}.1.conv.weight")),
            "res1_bias": _get(st, f"{res}.1.conv.bias"),
            "res2_kernel": prepare_conv_kernel(_get(st, f"{res}.3.conv.weight")),
            "res2_bias": _get(st, f"{res}.3.conv.bias"),
            "stride": ratio,
        })
        idx += 3

    tl = "decoder_transformer.transformer.layers.{}."
    return {
        "quant_w": quant,
        "upsample_w1": up_w1,
        "upsample_w2": up_w2,
        "dec_in_kernel": prepare_conv_kernel(_get(st, "decoder.model.0.conv.weight")),
        "dec_in_bias": _get(st, "decoder.model.0.conv.bias"),
        "stages": stages,
        "dec_out_kernel": prepare_conv_kernel(_get(st, f"decoder.model.{idx}.conv.weight")),
        "dec_out_bias": _get(st, f"decoder.model.{idx}.conv.bias"),
        "transformer": {
            "in_proj": stack(tl + "self_attn.in_proj.weight"),
            "out_proj": stack(tl + "self_attn.out_proj.weight"),
            "norm1_w": stack(tl + "norm1.weight"),
            "norm1_b": stack(tl + "norm1.bias"),
            "norm2_w": stack(tl + "norm2.weight"),
            "norm2_b": stack(tl + "norm2.bias"),
            "linear1": stack(tl + "linear1.weight"),
            "linear2": stack(tl + "linear2.weight"),
            "ls1": stack(tl + "layer_scale_1.scale", optional=True),
            "ls2": stack(tl + "layer_scale_2.scale", optional=True),
        },
    }


def to_device(w: dict, dtype: torch.dtype = torch.float32, cfg: MimiConfig = MimiConfig(),
              device="cpu", stats=None) -> convert.TensorTree:
    """The host dict as device weights in the compute dtype, the
    transformer's Q/K rows permuted to the halves RoPE layout, through one
    packed copy (convert.mimi_weights, utils/packing). ``stats``: see
    utils/packing.tree_to_device."""
    return convert.mimi_weights(w, cfg, dtype, device, stats)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def transformer(w, x: torch.Tensor, cfg: MimiConfig, window_impl: str = "auto") -> torch.Tensor:
    """Sliding-window causal depth transformer with LayerScale, positions
    0..T-1. x: [B, T, d_model]; ``w`` is the weights' ``transformer`` part.
    ``window_impl``: "kernel" (B2; on a CPU tensor its wrapper computes the
    plain version), "plain" (the plain version on any device) or "auto"
    (from x's device: the kernel on CUDA)."""
    H, D = cfg.num_heads, cfg.head_dim
    if window_impl == "auto":
        window_impl = "kernel" if x.device.type == "cuda" else "plain"
    if window_impl not in ("kernel", "plain"):
        raise ValueError(f"window_impl {window_impl!r}: expected auto, kernel or plain")
    attention = window_attention_qkv if window_impl == "kernel" else window_attention_qkv_plain
    for l in range(cfg.num_layers):
        xn = layernorm(x, w.norm1_w[l], w.norm1_b[l], cfg.ln_eps)
        qkv = _linear(w.in_proj[l], None, xn)
        attn = attention(qkv, num_heads=H, head_dim=D, context=cfg.context,
                         max_period=cfg.max_period)
        add = _linear(w.out_proj[l], None, attn)
        if w.ls1 is not None:
            add = add * w.ls1[l]
        x = x + add
        xn = layernorm(x, w.norm2_w[l], w.norm2_b[l], cfg.ln_eps)
        add = _linear(w.linear2[l], None, gelu_tanh(_linear(w.linear1[l], None, xn)))
        if w.ls2 is not None:
            add = add * w.ls2[l]
        x = x + add
    return x


def conv_stack(w, x: torch.Tensor, cfg: MimiConfig) -> torch.Tensor:
    """SEANet decoder stack: [B, T, d_model] -> [B, T * prod(ratios), 1]."""
    x = conv1d_causal(x, w.dec_in_kernel, w.dec_in_bias)
    for st, ratio in zip(w.stages, cfg.ratios):
        x = elu(x)
        x = convtr1d_2s(x, st.up_w1, st.up_w2, st.up_bias, stride=ratio)
        h = elu(x)
        h = conv1d_causal(h, st.res1_kernel, st.res1_bias)
        h = elu(h)
        h = conv1d_causal(h, st.res2_kernel, st.res2_bias)
        x = x + h
    x = elu(x)
    return conv1d_causal(x, w.dec_out_kernel, w.dec_out_bias)


def decode(w, latents: torch.Tensor, cfg: MimiConfig, window_impl: str = "auto") -> torch.Tensor:
    """Scaled latents [B, F, latent_dim] -> PCM [B, F * frame_samples]
    (``window_impl``: see transformer)."""
    x = _linear(w.quant_w, None, latents)  # quantizer out-proj (1x1 conv)
    x = convtr1d_2s(x, w.upsample_w1, w.upsample_w2, None,
                    stride=cfg.upsample_stride, depthwise=True)
    x = transformer(w.transformer, x, cfg, window_impl)
    return conv_stack(w, x, cfg)[..., 0]
