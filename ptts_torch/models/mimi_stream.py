"""Streaming Mimi decoder: one 80 ms PCM chunk per FlowLM frame (port of
ptts_tpu/models/mimi_stream.py).

Decodes a chunk of frames at a time and equals the same frames' slice of
the whole-sequence models/mimi.decode:

  * causal conv1d: carry the last (k - stride) input samples per stream
  * k == 2*stride transposed conv: carry the previous input frame
  * windowed transformer (context 250): a ring-buffer KV cache of RING
    slots that stores each key's absolute position, so the window mask stays
    exact for unbounded audio

The state is a dict of [B, ...] tensors that decode_stream updates in place
(ring K/V and positions, conv carries, the ring write cursor), as the
offline KV cache is; the write cursor ``wc`` is a 0-d int32 tensor on the
device shared by the B lockstep streams, as in the JAX package, so a
captured step (runtime/graphs) advances it in place. The ring attention is
a plain masked einsum, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..config import MimiConfig
from ..ops.activations import gelu_tanh
from ..ops.attention import _masked_softmax, _scale
from ..ops.conv import conv1d_causal, convtr1d_2s, elu
from ..ops.norms import layernorm
from ..ops.rope import rope_rotate_halves
from .flowlm import _linear

RING = 384  # >= context (250) + positions per frame (16); read at call time

State = Dict[str, Any]


# ---------------------------------------------------------------------------
# Streaming conv primitives
# ---------------------------------------------------------------------------


def conv_carry_init(batch: int, k: int, stride: int, in_ch: int, dtype,
                    device) -> torch.Tensor:
    """Zero left context: matches the whole-sequence decoder's zero pad."""
    return torch.zeros(batch, k - stride, in_ch, dtype=dtype, device=device)


def conv1d_stream(x: torch.Tensor, carry: torch.Tensor, kernel: torch.Tensor, bias,
                  *, stride: int = 1, groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal conv of a chunk x [B, Tc, Cin] (any strides) with its
    carry [B, k - stride, Cin]. Returns (y [B, Tc//stride, Cout], carry), the
    carry overwritten in place with the last k - stride inputs."""
    ctx = kernel.shape[0] - stride
    # the concatenation is the one copy: [B, Cin, ctx + Tc], contiguous
    full = torch.cat([carry.transpose(1, 2).to(x.dtype), x.transpose(1, 2)], dim=2)
    y = F.conv1d(full, kernel.permute(2, 1, 0).to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=stride, groups=groups)
    if ctx > 0:
        carry.copy_(full[:, :, full.shape[2] - ctx:].transpose(1, 2))
    return y.transpose(1, 2), carry


def convtr_carry_init(batch: int, in_ch: int, dtype, device) -> torch.Tensor:
    """A k == 2*stride transposed conv needs only the previous input frame."""
    return torch.zeros(batch, 1, in_ch, dtype=dtype, device=device)


def convtr1d_2s_stream(x: torch.Tensor, carry: torch.Tensor, w1: torch.Tensor,
                       w2: torch.Tensor, bias, *, stride: int,
                       depthwise: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming k == 2*stride transposed conv (ops/conv.convtr1d_2s form):
    y[t*s + j] = x[t] . W1[:, j] + x[t-1] . W2[:, j]. Runs on [carry, x] and
    drops the first s outputs, which belong to the carried frame and were
    emitted with the previous chunk. The carry becomes x's last frame."""
    full = torch.cat([carry.to(x.dtype), x], dim=1)             # [B, Tc+1, C]
    y = convtr1d_2s(full, w1, w2, bias, stride=stride, depthwise=depthwise)[:, stride:]
    carry.copy_(x[:, -1:])
    return y, carry


# ---------------------------------------------------------------------------
# Streaming windowed transformer (ring-buffer KV)
# ---------------------------------------------------------------------------


def ring_init(cfg: MimiConfig, batch: int, dtype, device) -> State:
    shape = (cfg.num_layers, batch, RING, cfg.num_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # per-stream positions processed so far
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        # absolute position of the key in each (stream, slot); -1 = empty
        "kpos": torch.full((batch, RING), -1, dtype=torch.int32, device=device),
        # next free slot column, shared by the lockstep streams
        "wc": torch.zeros((), dtype=torch.int32, device=device),
    }


def _ring_attention(q: torch.Tensor, k_ring: torch.Tensor, v_ring: torch.Tensor,
                    kpos: torch.Tensor, pos0: torch.Tensor, Tc: int,
                    context: int) -> torch.Tensor:
    """q [B, Tc, H, D] (rotated) over the ring slots [B, R, H, D]: slot j is
    a valid key for query position p iff kpos[j] >= 0 and
    0 <= p - kpos[j] < context."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_ring.float()) * _scale(q.shape[-1])
    q_pos = pos0[:, None] + torch.arange(Tc, device=q.device, dtype=torch.int32)
    key = kpos[:, None, :]                                        # [B, 1, R]
    dist = q_pos[:, :, None] - key                                # [B, Tc, R]
    valid = (key >= 0) & (dist >= 0) & (dist < context)
    probs = _masked_softmax(scores, valid[:, None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v_ring.dtype).float(), v_ring.float())
    return out.to(q.dtype)


def transformer_stream(w, ring: State, x: torch.Tensor,
                       cfg: MimiConfig) -> Tuple[State, torch.Tensor]:
    """A chunk of Tc 200 Hz positions x [B, Tc, d] through the depth
    transformer (``w`` is the weights' ``transformer`` part).

    All streams advance in lockstep, so the chunk's K/V land in the same
    ring columns [s, s + Tc) for every stream; s wraps to 0 when the chunk
    would run past the ring's end. The stored positions keep the mask exact
    after a wrap. Updates ``ring`` in place (the cursor included) and
    returns it with the output."""
    B, Tc, d = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    R = ring["k"].shape[2]
    if Tc > R:
        raise ValueError(f"a chunk of {Tc} positions does not fit the {R}-slot ring")
    pos0 = ring["pos"]              # advanced in place after the layers
    positions = pos0[:, None] + torch.arange(Tc, device=x.device, dtype=torch.int32)
    wc = ring["wc"]
    s = torch.where(wc + Tc <= R, wc, 0)
    cols = (s + torch.arange(Tc, device=x.device)).long()
    ring["kpos"].index_copy_(1, cols, positions)
    for l in range(cfg.num_layers):
        xn = layernorm(x, w.norm1_w[l], w.norm1_b[l], cfg.ln_eps)
        qkv = _linear(w.in_proj[l], None, xn)
        q, k, v = (qkv[..., i * d : (i + 1) * d].reshape(B, Tc, H, D) for i in range(3))
        q, k = rope_rotate_halves(q, k, positions, cfg.max_period)
        ring["k"][l].index_copy_(1, cols, k.to(ring["k"].dtype))
        ring["v"][l].index_copy_(1, cols, v.to(ring["v"].dtype))
        attn = _ring_attention(q, ring["k"][l], ring["v"][l], ring["kpos"], pos0, Tc,
                               cfg.context)
        add = _linear(w.out_proj[l], None, attn.reshape(B, Tc, d))
        if w.ls1 is not None:
            add = add * w.ls1[l]
        x = x + add
        xn = layernorm(x, w.norm2_w[l], w.norm2_b[l], cfg.ln_eps)
        add = _linear(w.linear2[l], None, gelu_tanh(_linear(w.linear1[l], None, xn)))
        if w.ls2 is not None:
            add = add * w.ls2[l]
        x = x + add
    ring["pos"] += Tc
    wc.copy_(torch.remainder(s + Tc, R))
    return ring, x


# ---------------------------------------------------------------------------
# Full streaming state
# ---------------------------------------------------------------------------


def init_state(w, cfg: MimiConfig, batch: int, dtype=torch.float32) -> State:
    """Fresh state for ``batch`` streams on the weights' device."""
    dev = w.quant_w.device
    ch = 2 ** len(cfg.ratios) * cfg.n_filters
    stages = []
    for _ in cfg.ratios:
        out_ch = ch // 2
        stages.append({
            "up": convtr_carry_init(batch, ch, dtype, dev),
            "res1": conv_carry_init(batch, cfg.residual_kernel, 1, out_ch, dtype, dev),
            # the second residual conv has k = 1: no carry
        })
        ch = out_ch
    return {
        "up": convtr_carry_init(batch, cfg.d_model, dtype, dev),
        "ring": ring_init(cfg, batch, dtype, dev),
        "dec_in": conv_carry_init(batch, cfg.kernel_size, 1, cfg.d_model, dtype, dev),
        "stages": stages,
        "dec_out": conv_carry_init(batch, cfg.last_kernel_size, 1, cfg.n_filters, dtype, dev),
    }


def reset_state(state: State) -> None:
    """Return ``state`` to init_state's values in place (its tensors keep
    their addresses, which a captured step reads)."""
    ring = state["ring"]
    for t in (ring["k"], ring["v"], ring["pos"], ring["wc"], state["up"], state["dec_in"],
              state["dec_out"], *(c for st in state["stages"] for c in st.values())):
        t.zero_()
    ring["kpos"].fill_(-1)


def decode_stream(w, state: State, latents: torch.Tensor,
                  cfg: MimiConfig) -> Tuple[State, torch.Tensor]:
    """Decode a chunk of F frames: scaled latents [B, F, latent] ->
    PCM [B, F * frame_samples]; ``state`` is updated in place and returned."""
    x = _linear(w.quant_w, None, latents)
    x, _ = convtr1d_2s_stream(x, state["up"], w.upsample_w1, w.upsample_w2, None,
                              stride=cfg.upsample_stride, depthwise=True)
    _, x = transformer_stream(w.transformer, state["ring"], x, cfg)
    x, _ = conv1d_stream(x, state["dec_in"], w.dec_in_kernel, w.dec_in_bias)
    for st, stw, ratio in zip(state["stages"], w.stages, cfg.ratios):
        x = elu(x)
        x, _ = convtr1d_2s_stream(x, st["up"], stw.up_w1, stw.up_w2, stw.up_bias, stride=ratio)
        h = elu(x)
        h, _ = conv1d_stream(h, st["res1"], stw.res1_kernel, stw.res1_bias)
        h = elu(h)
        h = conv1d_causal(h, stw.res2_kernel, stw.res2_bias)  # k = 1: stateless
        x = x + h
    x = elu(x)
    x, _ = conv1d_stream(x, state["dec_out"], w.dec_out_kernel, w.dec_out_bias)
    return state, x[..., 0]
