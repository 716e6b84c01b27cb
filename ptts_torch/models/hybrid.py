"""Granite 4.0-H's hybrid stack as FlowLM's backbone: Mamba-2 and GQA layers
in the place of Pocket-TTS's transformer, between the same latent input and
the same flow net and EOS head (models/flowlm.py dispatches here when
``FlowLMConfig.layer_types`` is set). The JAX package has no such backbone.

Each layer, with r = residual_multiplier and RMSNorms that carry a weight:

    h  = x + r * Mixer(RMSNorm1(x))
    x' = h + r * W_out(silu(a) * b),   [a, b] = split(W_in RMSNorm2(h))

The attention mixer is grouped-query attention without position encoding:
q [Hq, D], k and v [Hkv, D], causal softmax of q.k * attention_multiplier,
KV head j serving query heads j*G .. j*G + G-1. The Mamba-2 mixer:

    [z, xBC, dt] = W_in u
    xBC = silu(causal depthwise conv1d(xBC, d_conv taps, bias))
    [x, B, C] = split(xBC)                     x: H heads of P; B, C: N
    dt = softplus(dt + dt_bias),  A = -exp(A_log)              per head
    S_t[h, p, n] = exp(dt_t[h] A[h]) S_{t-1}[h, p, n] + dt_t[h] x_t[h, p] B_t[n]
    y_t[h, p] = sum_n C_t[n] S_t[h, p, n] + D[h] x_t[h, p]
    out = W_out(RMSNorm(y * silu(z)) * w)      over all H*P channels

Per-slot state beside the KV cache (flowlm.KVCache): the attention layers'
K/V in ``k``/``v`` [La, B, Tmax, Hkv, D], and for each Mamba layer its SSM
state ``ssm`` [Lm, B, H, P, N] and its conv state ``conv`` [Lm, B,
d_conv - 1, conv channels], the last inputs of the conv, both in the
cache's dtype: a bf16 engine keeps a bf16 state (each frame's decay and
update compute in float32 and round once to bf16 as they are stored). The state
has no positions and no mask: a prefill writes each row's final state
whole (flowlm.write_state), and a frame updates it in place.

The prompt pass runs the scan in its chunked (SSD) form, in float32, over
chunks of ``mamba_chunk`` positions: within a chunk as a masked matrix
product, across chunks by the chunk-end states. Padding positions past a
prompt's length get dt = 0, which leaves the state as it was, so the final
state of a back-padded row is its state at its own last position. The frame
step runs the recurrence (ops/cuda/ssm_step: on the card a prologue kernel
for the conv window and dt, then one pass that reads and writes each
row's state once; on the CPU its plain version): the state decays and
takes the outer product x B^T in place, and y contracts it with C. The
attention layer's prompt pass is torch's SDPA (the B1 kernel applies RoPE,
which this backbone has not), its frame the grouped decode attention
kernel (ops/cuda/decode_attention).

Tracing (utils/timing): each Mamba layer's prompt scan, and the write of
the final states into the cache, are ``ptts.ssm_prefill`` spans; the
counters ``ssm.state_bytes`` (state allocated with a cache) and
``ssm.state_resets`` (rows whose state a prefill overwrote); the frame step
launches the marker kernels ``ptts_mark_ssm_in`` and ``ptts_mark_ssm_out``
around each Mamba mixer's core, from the input projection's output to the
gated norm's, so a device trace reads the state update's time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FlowLMConfig
from ..ops.activations import silu
from ..ops.cuda import markers
from ..ops.cuda.ssm_step import ssm_step
from ..ops.norms import rmsnorm
from ..utils import timing


def _linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def load_backbone(get, stack_fn, cfg: FlowLMConfig) -> dict:
    """The backbone's host dict from a checkpoint in Granite's layer names
    under FlowLM's ``transformer.layers.{i}.`` prefix: ``get(name)`` reads
    one tensor, ``stack_fn`` stacks a list (np.stack or torch.stack)."""
    tl = "transformer.layers.{}."
    L, M, A = range(cfg.num_layers), cfg.mamba_layers, cfg.attention_layers

    def stack(fmt: str, layers, reshape=None):
        vals = [get(tl.format(i) + fmt) for i in layers]
        if reshape is not None:
            vals = [v.reshape(reshape) for v in vals]
        return stack_fn(vals)

    def qkv(i):
        parts = [get(tl.format(i) + f"self_attn.{p}_proj.weight") for p in "qkv"]
        return np.concatenate(parts) if stack_fn is np.stack else torch.cat(parts)

    K = cfg.mamba_d_conv
    return {
        "ln1": stack("input_layernorm.weight", L),
        "ln2": stack("post_attention_layernorm.weight", L),
        "mlp_in": stack("shared_mlp.input_linear.weight", L),
        "mlp_out": stack("shared_mlp.output_linear.weight", L),
        "mamba": {
            "in_proj": stack("mamba.in_proj.weight", M),
            "conv_w": stack("mamba.conv1d.weight", M, (cfg.mamba_conv_dim, K)),
            "conv_b": stack("mamba.conv1d.bias", M),
            "dt_bias": stack("mamba.dt_bias", M),
            "A_log": stack("mamba.A_log", M),
            "D": stack("mamba.D", M),
            "norm_w": stack("mamba.norm.weight", M),
            "out_proj": stack("mamba.out_proj.weight", M),
        },
        "attn": {
            "qkv": stack_fn([qkv(i) for i in A]),
            "o": stack("self_attn.o_proj.weight", A),
        },
    }


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def state_shapes(cfg: FlowLMConfig, batch: int) -> Tuple[tuple, tuple]:
    """(ssm, conv) state shapes of a cache of ``batch`` rows."""
    Lm = len(cfg.mamba_layers)
    return ((Lm, batch, cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_d_state),
            (Lm, batch, cfg.mamba_d_conv - 1, cfg.mamba_conv_dim))


def make_state(cfg: FlowLMConfig, batch: int, dtype: torch.dtype, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero SSM and conv states for ``batch`` rows; counts their bytes in
    ``ssm.state_bytes``."""
    ssm_shape, conv_shape = state_shapes(cfg, batch)
    ssm = torch.zeros(ssm_shape, dtype=dtype, device=device)
    conv = torch.zeros(conv_shape, dtype=dtype, device=device)
    timing.count("ssm.state_bytes", ssm.numel() * ssm.element_size()
                 + conv.numel() * conv.element_size())
    return ssm, conv


def write_state(cache, rows: Optional[torch.Tensor], state) -> None:
    """A prefill's final (ssm, conv) states into the cache's rows ``rows``
    (every row when None), in place: whatever the rows held before is
    overwritten whole. Counts the rows in ``ssm.state_resets``."""
    ssm, conv = state
    with timing.span("ptts.ssm_prefill", rows=int(ssm.shape[1])):
        if rows is None:
            cache.ssm.copy_(ssm)
            cache.conv.copy_(conv)
        else:
            cache.ssm.index_copy_(1, rows, ssm.to(cache.ssm.dtype))
            cache.conv.index_copy_(1, rows, conv.to(cache.conv.dtype))
    timing.count("ssm.state_resets", int(ssm.shape[1]))


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


def _split_in(cfg: FlowLMConfig, zxbcdt: torch.Tensor):
    di, C = cfg.mamba_inner, cfg.mamba_conv_dim
    return zxbcdt[..., :di], zxbcdt[..., di:di + C], zxbcdt[..., di + C:]


def _gate_norm(cfg: FlowLMConfig, y: torch.Tensor, z: torch.Tensor, norm_w, dtype):
    """RMSNorm(y * silu(z)) * w over all channels (one group), in float32."""
    return rmsnorm(y * silu(z.float()), norm_w.float(), cfg.ln_eps).to(dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 recurrence over whole sequences, in chunks, from a zero
    state: x [n, T, H, P], dt [n, T, H], A [H], B and C [n, T, N], all
    float32. Returns (y [n, T, H, P] without the D skip, the state after the
    last position [n, H, P, N])."""
    n, T, H, P = x.shape
    N = B.shape[-1]
    l = min(chunk, T)
    pad = -T % l
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    c = (T + pad) // l
    X = (x * dt[..., None]).reshape(n, c, l, H, P)
    a = (dt * A).reshape(n, c, l, H).permute(0, 3, 1, 2)          # [n, H, c, l]
    Bc, Cc = B.reshape(n, c, l, N), C.reshape(n, c, l, N)
    acum = a.cumsum(-1)
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    # within a chunk: y_t = sum_{s <= t} C_t.B_s exp(sum_{s < k <= t} a_k) X_s
    seg = (acum[..., :, None] - acum[..., None, :]).masked_fill(~causal, float("-inf"))
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = torch.einsum("bhcls,bcshp->bclhp", torch.exp(seg) * cb[:, None], X)
    # each chunk's end state from its own inputs, then carried across chunks
    decay = torch.exp(acum[..., -1:] - acum)                       # [n, H, c, l]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    ends = F.pad(acum[..., -1], (1, 0)).cumsum(-1)                 # [n, H, c + 1]
    cc = torch.ones(c + 1, c + 1, dtype=torch.bool, device=x.device).tril()
    carry = (ends[..., :, None] - ends[..., None, :]).masked_fill(~cc, float("-inf"))
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    states = torch.einsum("bhzc,bchpn->bzhpn", torch.exp(carry), states)
    final = states[:, -1]
    # the states entering each chunk, read out by C
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states[:, :-1], torch.exp(acum))
    return y.reshape(n, c * l, H, P)[:, :T], final


def mamba_prefill(mw, j: int, u: torch.Tensor, lengths: torch.Tensor, cfg: FlowLMConfig):
    """Mamba layer ``j`` over back-padded prompts u [n, T, d] with [n]
    lengths: (out [n, T, d], final SSM state [n, H, P, N] f32, conv state
    [n, d_conv - 1, conv channels], the last inputs before each end)."""
    n, T, _ = u.shape
    H, P, K = cfg.mamba_heads, cfg.mamba_head_dim, cfg.mamba_d_conv
    z, xbc, dt = _split_in(cfg, _linear(mw.in_proj[j], u))
    idx = lengths.long()[:, None] - (K - 1) + torch.arange(K - 1, device=u.device)
    conv_state = torch.take_along_dim(xbc, idx.clamp(min=0)[:, :, None], dim=1)
    conv_state = torch.where(idx[:, :, None] >= 0, conv_state, 0.0).to(u.dtype)
    xc = F.conv1d(F.pad(xbc.float().transpose(1, 2), (K - 1, 0)),
                  mw.conv_w[j].float()[:, None, :], mw.conv_b[j].float(), groups=xbc.shape[-1])
    xc = silu(xc.transpose(1, 2)).to(u.dtype)
    xs, Bm, Cm = xc.float().split([H * P, cfg.mamba_d_state, cfg.mamba_d_state], dim=-1)
    live = torch.arange(T, device=u.device)[None, :] < lengths[:, None]
    dt = torch.where(live[..., None], F.softplus(dt.float() + mw.dt_bias[j].float()), 0.0)
    A = -torch.exp(mw.A_log[j].float())
    xs = xs.reshape(n, T, H, P)
    y, state = ssd_scan(xs, dt, A, Bm, Cm, cfg.mamba_chunk)
    y = (y + mw.D[j].float()[:, None] * xs).reshape(n, T, H * P)
    y = _gate_norm(cfg, y, z, mw.norm_w[j], u.dtype)
    return _linear(mw.out_proj[j], y), state, conv_state


def mamba_step(mw, j: int, u: torch.Tensor, ssm: torch.Tensor, conv: torch.Tensor,
               cfg: FlowLMConfig, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One position of Mamba layer ``j`` for B streams u [B, d]: the conv
    window and the SSM state of each stream (``conv`` [B, d_conv - 1, C],
    ``ssm`` [B, H, P, N]) advanced IN PLACE. ``live`` (0-d bool): when False
    both states keep their values."""
    z, xbc, dt = _split_in(cfg, _linear(mw.in_proj[j], u))
    markers.device_mark(markers.SSM_IN, u)
    y = ssm_step(xbc, dt, ssm, conv, mw.conv_w[j], mw.conv_b[j], mw.dt_bias[j], mw.A_log[j],
                 mw.D[j], live)
    y = _gate_norm(cfg, y, z, mw.norm_w[j], u.dtype)
    markers.device_mark(markers.SSM_OUT, u)
    return _linear(mw.out_proj[j], y)


# ---------------------------------------------------------------------------
# Attention and MLP
# ---------------------------------------------------------------------------


def _split_qkv(aw, j: int, u: torch.Tensor, cfg: FlowLMConfig):
    Hq, Hk, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    qkv = _linear(aw.qkv[j], u)
    lead = u.shape[:-1]
    q = qkv[..., :Hq * D].reshape(*lead, Hq, D)
    k = qkv[..., Hq * D:(Hq + Hk) * D].reshape(*lead, Hk, D)
    v = qkv[..., (Hq + Hk) * D:].reshape(*lead, Hk, D)
    return q, k, v


def attention_prefill(aw, j: int, u: torch.Tensor, cfg: FlowLMConfig):
    """Attention layer ``j`` over prompts u [n, T, d] (causal; a back-padded
    row's padding is seen only by padding): (out, k [n, T, Hkv, D], v)."""
    n, T, _ = u.shape
    q, k, v = _split_qkv(aw, j, u, cfg)
    G = cfg.num_heads // cfg.kv_heads
    a = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(G, 2).transpose(1, 2),
        v.repeat_interleave(G, 2).transpose(1, 2), is_causal=True, scale=cfg.attn_scale)
    return _linear(aw.o[j], a.transpose(1, 2).reshape(n, T, -1)), k, v


def mlp(hw, l: int, h: torch.Tensor, cfg: FlowLMConfig) -> torch.Tensor:
    a, b = _linear(hw.mlp_in[l], h).split(cfg.hidden, dim=-1)
    return _linear(hw.mlp_out[l], silu(a) * b)


def _residual(x: torch.Tensor, y: torch.Tensor, cfg: FlowLMConfig) -> torch.Tensor:
    return x + y * cfg.residual_multiplier


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------


def prefill(w, x: torch.Tensor, lengths: torch.Tensor, cfg: FlowLMConfig):
    """The causal prompt pass over x [n, T, d] with [n] int32 lengths:
    (k [La, n, T, Hkv, D], v, last [n, d], (ssm [Lm, n, H, P, N], conv
    [Lm, n, d_conv - 1, C])), the states being each row's at its length."""
    hw = w.hybrid
    ks, vs, ssm, conv = [], [], [], []
    for l, kind in enumerate(cfg.layer_types):
        h = rmsnorm(x, hw.ln1[l], cfg.ln_eps)
        if kind == "mamba":
            j = len(ssm)
            with timing.span("ptts.ssm_prefill", layer=l):
                y, s, c = mamba_prefill(hw.mamba, j, h, lengths, cfg)
            ssm.append(s)
            conv.append(c)
        else:
            y, k, v = attention_prefill(hw.attn, len(ks), h, cfg)
            ks.append(k)
            vs.append(v)
        x = _residual(x, y, cfg)
        x = _residual(x, mlp(hw, l, rmsnorm(x, hw.ln2[l], cfg.ln_eps), cfg), cfg)
    last = x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1]
    return torch.stack(ks), torch.stack(vs), last, (torch.stack(ssm), torch.stack(conv))


def decode_step(w, cache, x: torch.Tensor, cfg: FlowLMConfig, attend,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cached position for B streams x [B, d]: each attention layer
    writes its k/v at the cache's write column and attends through
    ``attend(q, k_cache, v_cache, mask, scale)``; each Mamba layer advances
    its SSM and conv state in place. ``live``: see flowlm.decode_step. The
    caller advances the cursor. Returns the stack's output [B, d]."""
    B = x.shape[0]
    hw = w.hybrid
    col = cache.write_col.reshape(1).long()
    mask = cache.valid_mask(through_cursor=True)
    jm = ja = 0
    for l, kind in enumerate(cfg.layer_types):
        h = rmsnorm(x, hw.ln1[l], cfg.ln_eps)
        if kind == "mamba":
            y = mamba_step(hw.mamba, jm, h, cache.ssm[jm], cache.conv[jm], cfg, live)
            jm += 1
        else:
            q, k, v = _split_qkv(hw.attn, ja, h, cfg)
            k, v = k[:, None].to(cache.k.dtype), v[:, None].to(cache.v.dtype)
            if live is not None:
                k = torch.where(live, k, cache.k[ja].index_select(1, col))
                v = torch.where(live, v, cache.v[ja].index_select(1, col))
            cache.k[ja].index_copy_(1, col, k)
            cache.v[ja].index_copy_(1, col, v)
            a = attend(q.contiguous(), cache.k[ja], cache.v[ja], mask, cfg.attn_scale)
            y = _linear(hw.attn.o[ja], a.reshape(B, -1))
            ja += 1
        x = _residual(x, y, cfg)
        x = _residual(x, mlp(hw, l, rmsnorm(x, hw.ln2[l], cfg.ln_eps), cfg), cfg)
    return x
