"""Fused RoPE + attention off the raw [B, T, 3*H*D] QKV projection.

Wrappers of the CUDA kernels in ptts_torch/csrc/fused_attention.cu, each
with its plain PyTorch version beside it:

  * causal_attention_qkv  -- FlowLM prefill (B1); replaces the Pallas kernel
    ptts_tpu/ops/pallas/fused_attention.py:361. Returns (attn, k_rot).
  * window_attention_qkv  -- Mimi transformer (B2); replaces
    ptts_tpu/ops/pallas/fused_attention.py:186.

Both take the projection in the halves RoPE layout
(ops/rope.permute_qk_rows_for_rope) and rotate q and k at positions 0..T-1.
A wrapper given a CPU tensor computes the plain version; given a CUDA tensor
it launches its kernel or raises -- there is no fallback from one to the
other. Each wrapper counts its kernel launches in ``<wrapper>.launches``
and, per (dtype, B, T), in the Counter ``<wrapper>.shapes``.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..attention import causal_attention, windowed_attention_local
from ..rope import rope_freqs, rope_rotate_halves
from . import build

KERNEL_HEAD_DIM = 64      # the head dim the kernels are compiled for
LOCAL_ATTN_BLOCK = 256    # query block of the plain windowed version


def _split_qkv(qkv: torch.Tensor, H: int, D: int):
    B, T, _ = qkv.shape
    d = H * D
    return (qkv[..., :d].reshape(B, T, H, D), qkv[..., d : 2 * d].reshape(B, T, H, D),
            qkv[..., 2 * d :].reshape(B, T, H, D))


def causal_attention_qkv_plain(qkv: torch.Tensor, lengths: torch.Tensor, *,
                               num_heads: int, head_dim: int,
                               max_period: float = 10000.0):
    """rope_rotate_halves, then causal_attention(lengths=). Returns
    (attn [B, T, H*D], k_rot [B, T, H*D])."""
    B, T, _ = qkv.shape
    q, k, v = _split_qkv(qkv, num_heads, head_dim)
    pos = torch.arange(T, device=qkv.device)[None, :]
    q, k = rope_rotate_halves(q, k, pos, max_period)
    attn = causal_attention(q, k, v, lengths=lengths)
    return attn.reshape(B, T, -1), k.reshape(B, T, -1)


def window_attention_qkv_plain(qkv: torch.Tensor, *, num_heads: int, head_dim: int,
                               context: int, max_period: float = 10000.0) -> torch.Tensor:
    """rope_rotate_halves, then the sliding window: windowed_attention_local
    when T spans more than one block, else causal_attention(context=).
    Returns [B, T, H*D]."""
    B, T, _ = qkv.shape
    q, k, v = _split_qkv(qkv, num_heads, head_dim)
    pos = torch.arange(T, device=qkv.device)[None, :]
    q, k = rope_rotate_halves(q, k, pos, max_period)
    block = max(LOCAL_ATTN_BLOCK, context - 1)
    if T > block:
        attn = windowed_attention_local(q, k, v, context=context, block=block)
    else:
        attn = causal_attention(q, k, v, context=context)
    return attn.reshape(B, T, -1)


@functools.lru_cache(maxsize=32)
def _rope_tables(T: int, head_dim: int, max_period: float, device: torch.device):
    """[T, D/2] f32 cos and sin at positions 0..T-1, built on the host."""
    angle = np.arange(T, dtype=np.float32)[:, None] * rope_freqs(head_dim, max_period)[None, :]
    return (torch.from_numpy(np.cos(angle)).to(device),
            torch.from_numpy(np.sin(angle)).to(device))


def _check_qkv(qkv: torch.Tensor, num_heads: int, head_dim: int) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"qkv must be a CUDA or CPU tensor, got {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if head_dim != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernels are built for head_dim {KERNEL_HEAD_DIM}, got {head_dim}")
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * num_heads * head_dim:
        raise ValueError(f"qkv must be [B, T, {3 * num_heads * head_dim}], got {list(qkv.shape)}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")


def _tag(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = build.library().ptts_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def causal_attention_qkv(qkv: torch.Tensor, lengths: torch.Tensor, *, num_heads: int,
                         head_dim: int, max_period: float = 10000.0):
    """Full-causal attention with keys masked to t < lengths[b], RoPE inside.

    qkv [B, T, 3*H*D] (f32 or bf16), lengths [B] int32 on the same device.
    Returns (attn [B, T, H*D], k_rot [B, T, H*D]): the rotated keys at every
    position, for the KV cache."""
    if qkv.device.type == "cpu":
        return causal_attention_qkv_plain(qkv, lengths, num_heads=num_heads,
                                          head_dim=head_dim, max_period=max_period)
    _check_qkv(qkv, num_heads, head_dim)
    B, T, _ = qkv.shape
    if (lengths.device != qkv.device or lengths.dtype != torch.int32
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous()):
        raise ValueError("lengths must be a contiguous [B] int32 tensor on qkv's device")
    cos, sin = _rope_tables(T, head_dim, float(max_period), qkv.device)
    out = torch.empty(B, T, num_heads * head_dim, dtype=qkv.dtype, device=qkv.device)
    k_rot = torch.empty_like(out)
    with torch.cuda.device(qkv.device):
        rc = build.library().ptts_causal_attn_qkv(
            qkv.data_ptr(), lengths.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            out.data_ptr(), k_rot.data_ptr(), B, T, num_heads,
            int(qkv.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "causal_attention_qkv")
    causal_attention_qkv.launches += 1
    causal_attention_qkv.shapes[(_tag(qkv.dtype), B, T)] += 1
    return out, k_rot


causal_attention_qkv.launches = 0
causal_attention_qkv.shapes = collections.Counter()


def window_attention_qkv(qkv: torch.Tensor, *, num_heads: int, head_dim: int,
                         context: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sliding-window causal attention (key k valid for query q iff
    0 <= q - k < context), RoPE inside. qkv [B, T, 3*H*D] -> [B, T, H*D]."""
    if qkv.device.type == "cpu":
        return window_attention_qkv_plain(qkv, num_heads=num_heads, head_dim=head_dim,
                                          context=context, max_period=max_period)
    _check_qkv(qkv, num_heads, head_dim)
    if context < 1:
        raise ValueError(f"context must be >= 1, got {context}")
    B, T, _ = qkv.shape
    cos, sin = _rope_tables(T, head_dim, float(max_period), qkv.device)
    out = torch.empty(B, T, num_heads * head_dim, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = build.library().ptts_window_attn_qkv(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), B, T,
            num_heads, context, int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "window_attention_qkv")
    window_attention_qkv.launches += 1
    window_attention_qkv.shapes[(_tag(qkv.dtype), B, T)] += 1
    return out


window_attention_qkv.launches = 0
window_attention_qkv.shapes = collections.Counter()


def attribute_calls() -> int:
    """How many times the kernel library has raised a kernel's dynamic
    shared-memory limit in this process: once per kernel and device, so a
    launch at a shape already seen adds nothing."""
    return build.library().ptts_attr_calls()
