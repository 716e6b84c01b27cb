"""Attention ops (port of ptts_tpu/ops/attention.py): full causal,
sliding-window causal, and single-query decode over a KV cache.

Layouts are [B, T, H, D] as in the JAX package. Numerics: scale 1/sqrt(D);
masked logits are REPLACED by -1e30 with ``where`` (a multiply would turn a
non-finite masked score into NaN); softmax statistics in f32. Products take
their inputs up to f32, which for bf16 inputs is the JAX package's "dot in
the input dtype with f32 accumulation" (a bf16 x bf16 product is exact in
f32); probabilities are rounded to the value dtype before the p.V product,
as ``probs.astype(v.dtype)`` does there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _scale(head_dim: int) -> float:
    return float(1.0 / np.sqrt(np.float32(head_dim)))


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     context: int = 0,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full causal attention on [B, T, H, D]. ``context`` > 0 masks keys with
    (tq - tk) >= context (the Mimi window); ``lengths`` [B] masks key
    positions t >= length (ragged prompts)."""
    B, T, H, D = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(D)
    t = torch.arange(T, device=q.device)
    tq, tk = t[:, None], t[None, :]
    mask = tk <= tq
    if context > 0:
        mask = mask & ((tq - tk) < context)
    mask = mask[None, None]
    if lengths is not None:
        valid = tk[None] < lengths.to(q.device)[:, None, None]  # [B, 1, T]
        mask = mask & valid[:, None]
    probs = _masked_softmax(scores, mask)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def windowed_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             context: int, block: int = 256) -> torch.Tensor:
    """Sliding-window causal attention in block-local form: each query block
    of ``block`` rows sees only its own and the previous key block, which
    covers the window when block >= context - 1. Equals
    causal_attention(..., context=context). q, k, v: [B, T, H, D]."""
    B, T, H, D = q.shape
    S = block
    assert S >= context - 1, (S, context)
    nb = -(-T // S)
    pad = nb * S - T
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
    qb = q.reshape(B, nb, S, H, D)
    kb = k.reshape(B, nb, S, H, D)
    vb = v.reshape(B, nb, S, H, D)
    # previous block (zeros before block 0)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)  # [B, nb, 2S, H, D]
    v2 = torch.cat([vprev, vb], dim=2)

    scores = torch.einsum("bnqhd,bnkhd->bnhqk", qb.float(), k2.float()) * _scale(D)
    dev = q.device
    qi = torch.arange(S, device=dev)[:, None]            # row within the block
    kj = torch.arange(2 * S, device=dev)[None, :] - S    # key offset to block start
    rel = qi - kj                                        # q_pos - k_pos
    k_abs = torch.arange(nb, device=dev)[:, None, None] * S + kj[None]
    mask = (rel[None] >= 0) & (rel[None] < context) & (k_abs >= 0) & (k_abs < T)
    probs = _masked_softmax(scores, mask[None, :, None])
    out = torch.einsum("bnhqk,bnkhd->bnqhd", probs.to(v2.dtype).float(), v2.float())
    return out.reshape(B, nb * S, H, D)[:, :T].to(q.dtype)


def decode_attention_masked(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Single-query attention over a KV cache with an explicit validity mask.

    q: [B, H, D]; k_cache/v_cache: [B, Tmax, H, D]; mask: [B, Tmax] bool.
    Returns [B, H, D]. Plain PyTorch, as the JAX package leaves it to XLA.
    """
    scores = torch.einsum("bhd,bthd->bht", q.float(), k_cache.float()) * _scale(q.shape[-1])
    probs = _masked_softmax(scores, mask[:, None, :])
    out = torch.einsum("bht,bthd->bhd", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, context: int = 0) -> torch.Tensor:
    """decode_attention_masked with a per-stream length (+ window) mask:
    key t of stream b is valid iff t < lengths[b] (and lengths[b] - 1 - t <
    context when context > 0). Oracle variant, as in the JAX package: the
    model builds its mask from the cursor-aligned KVCache; the tests keep
    this independent formulation."""
    t = torch.arange(k_cache.shape[1], device=k_cache.device)[None, :]
    lengths = lengths.to(k_cache.device)[:, None]
    mask = t < lengths
    if context > 0:
        mask = mask & ((lengths - 1 - t) < context)
    return decode_attention_masked(q, k_cache, v_cache, mask)


def decode_attention_blocked(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             prefix_len: torch.Tensor, start: torch.Tensor, cursor: int, *,
                             block_t: int = 128) -> torch.Tensor:
    """Online-softmax decode attention that reads the cache only in blocks of
    ``block_t`` columns up to the cursor: ceil((cursor + 1) / block_t) blocks.
    ``cursor`` (the last valid decode column) is a host int, from the host
    mirror of the KVCache's device cursor (KVCache.cursor_host, kept by the
    eager frame loop), so the trip count needs no device read. block_t shrinks
    until it divides Tmax. Column t of stream b is valid iff t < prefix_len[b]
    or start[b] <= t <= cursor: the cache must not have wrapped (offline
    paths; the continuous batcher's ring refuses this path).

    q: [B, H, D]; k_cache/v_cache: [B, Tmax, H, D]. Returns [B, H, D]."""
    B, Tmax, H, D = k_cache.shape
    block_t = min(block_t, Tmax)
    while Tmax % block_t:
        block_t -= 1
    scale = _scale(D)
    dev = k_cache.device
    prefix_len = prefix_len.to(dev)[:, None]
    start = start.to(dev)[:, None]
    qf = q.float()
    m = torch.full((B, H, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, D), dtype=torch.float32, device=dev)
    for j in range(-(-(cursor + 1) // block_t)):
        lo = j * block_t
        k_blk = k_cache[:, lo : lo + block_t]
        v_blk = v_cache[:, lo : lo + block_t]
        t = torch.arange(lo, lo + block_t, device=dev)[None, :]
        valid = (t < prefix_len) | ((t >= start) & (t <= cursor))
        s = torch.einsum("bhd,bthd->bht", qf, k_blk.float()) * scale
        s = torch.where(valid[:, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bht,bthd->bhd", p.to(v_cache.dtype).float(),
                                        v_blk.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
