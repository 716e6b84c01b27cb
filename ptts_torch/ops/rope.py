"""Rotary position embeddings in the halves layout (port of
ptts_tpu/ops/rope.py).

The Q/K rows of every fused in_proj are permuted once at load
(permute_qk_rows_for_rope) so that each head's even pair components land in
its first D/2 lanes and the odd ones in its last D/2. Attention is invariant
to that permutation; RoPE then rotates two contiguous halves. The CUDA
kernels in ops/cuda assume the same layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def rope_freqs(head_dim: int, max_period: float = 10000.0) -> np.ndarray:
    """Per-pair frequencies [head_dim // 2] in float32 (host constant)."""
    half = head_dim // 2
    i = np.arange(half, dtype=np.float32)
    return np.exp(-np.log(np.float32(max_period))
                  * (2.0 * i / np.float32(head_dim))).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_freqs(head_dim: int, max_period: float, device: torch.device) -> torch.Tensor:
    """rope_freqs on the device, uploaded once: an upload per call would be a
    host sync in every decode step."""
    return torch.from_numpy(rope_freqs(head_dim, max_period)).to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 max_period: float = 10000.0):
    """cos/sin for integer positions; shapes [..., head_dim // 2], f32."""
    freqs = _device_freqs(head_dim, float(max_period), positions.device)
    angle = positions.float()[..., None] * freqs
    return torch.cos(angle), torch.sin(angle)


def rope_head_permutation(head_dim: int) -> np.ndarray:
    """Within-head order [0, 2, ..., D-2, 1, 3, ..., D-1]."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def permute_qk_rows_for_rope(in_proj, num_heads: int, head_dim: int):
    """Reorder the Q and K output rows of a fused [..., 3d, d] in_proj into
    the halves layout; V rows are untouched. Takes a numpy array or a torch
    CPU tensor (a bf16 host load) and returns a new one of the same kind."""
    d = num_heads * head_dim
    perm = rope_head_permutation(head_dim)
    idx = np.arange(3 * d)
    for blk in (0, 1):  # q rows, k rows
        for h in range(num_heads):
            base = blk * d + h * head_dim
            idx[base : base + head_dim] = base + perm
    if isinstance(in_proj, torch.Tensor):
        return in_proj[..., torch.from_numpy(idx), :]
    return np.asarray(in_proj)[..., idx, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of the last axis, (x0, x1) -> (x0*c - x1*s,
    x0*s + x1*c), in f32 (cos/sin are f32); returns the input dtype.

    Oracle variant (with rope_rotate), as in the JAX package: the model
    permutes the Q/K rows at load and rotates contiguous halves; the tests
    hold the two formulations against each other."""
    shape = x.shape
    xp = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    x0, x1 = xp[..., 0], xp[..., 1]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(shape).to(x.dtype)


def rope_rotate(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                max_period: float = 10000.0):
    """RoPE on interleaved-pair q, k: [..., T, H, D]; positions broadcast to
    [..., T]. Oracle variant (see apply_rope)."""
    cos, sin = rope_cos_sin(positions, q.shape[-1], max_period)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def apply_rope_halves(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate in f32 (cos/sin are f32); return in the input dtype."""
    half = x.shape[-1] // 2
    lo = x[..., :half]
    hi = x[..., half:]
    return torch.cat([lo * cos - hi * sin, lo * sin + hi * cos],
                     dim=-1).to(x.dtype)


def rope_rotate_halves(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                       max_period: float = 10000.0):
    """RoPE on halves-layout q, k: [..., T, H, D]; positions broadcast to [..., T]."""
    cos, sin = rope_cos_sin(positions, q.shape[-1], max_period)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return apply_rope_halves(q, cos, sin), apply_rope_halves(k, cos, sin)
