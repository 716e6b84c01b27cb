"""FlowLM: text -> acoustic latents (port of ptts_tpu/models/flowlm.py).

Every function mirrors its JAX namesake and takes the weights first: ``w``
is the module from ptts_torch.convert.flowlm_weights, whose buffers carry
the JAX host dict's names (``w.in_proj`` is ``w["in_proj"]`` there). The
frame loops advance a FrameLoop, whose state lives on the device as the
JAX loops' carry does (the KV cursor included): generate_latents_while
stops once every stream is done, checking on the host once per chunk of
frames, generate_latents runs a fixed, resumable number of frames with no
host sync, and runtime/streaming runs one frame per call. Given a
runtime/graphs.GraphCache, each chunk is a CUDA graph replay.
The prompt prefill runs the fused RoPE + causal attention kernel
(ops/cuda/fused_attention.causal_attention_qkv) or, with
``attn_impl="plain"``, its plain version; the per-frame decode attention is
the masked einsum, as the JAX package leaves it to XLA, or with
``KernelFlags.decode_impl="blocked"`` the blocked online softmax
(ops/attention.decode_attention_blocked).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import convert
from ..config import FlowLMConfig, KernelFlags, resolve_kernel_impl
from ..ops.activations import gelu_erf, silu
from ..ops.attention import decode_attention_blocked, decode_attention_masked
from ..ops.cuda.fused_attention import causal_attention_qkv, causal_attention_qkv_plain
from ..ops.norms import kyutai_rmsnorm, layernorm
from ..ops.rope import rope_rotate_halves
from ..utils import timing

DEFAULT_FLAGS = KernelFlags()


def _decode_attention_dispatch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                               mask: torch.Tensor, scalars: tuple,
                               flags: KernelFlags) -> torch.Tensor:
    """The decode attention that ``flags.decode_impl`` chooses: "auto" ==
    "einsum" (decode_attention_masked), or "blocked"
    (decode_attention_blocked over ``scalars`` = (prefix_len, start, cursor)).
    With ``flags.validate`` and "blocked", runs both, prints
    ``[ptts] validate decode_attention maxdiff=...`` (beside the largest
    |output|) and returns the masked einsum's, as the JAX package does
    (the reference's PTTS_CUDA_VALIDATE pattern). The print reads both
    results back, so validate mode syncs the host once per layer."""
    if flags.decode_impl != "blocked":
        return decode_attention_masked(q, k_cache, v_cache, mask)
    b = decode_attention_blocked(q, k_cache, v_cache, *scalars)
    if not flags.validate:
        return b
    a = decode_attention_masked(q, k_cache, v_cache, mask)
    diff = (a.float() - b.float()).abs().max().item()
    top = a.float().abs().max().item()
    print(f"[ptts] validate decode_attention maxdiff={diff:.6e} max={top:.6e}")
    return a

# ---------------------------------------------------------------------------
# Weight loading (numpy; returns the same host dict as the JAX load_weights)
# ---------------------------------------------------------------------------


def _find(st, name: str):
    """exact -> 'flow_lm.' prefix -> suffix fallback."""
    t = st.find(name)
    if t is not None:
        return t
    t = st.find("flow_lm." + name)
    if t is not None:
        return t
    for cand in st.tensors:
        if cand.name.endswith(name):
            return cand
    return None


def _get(st, name: str, optional: bool = False, dtype: torch.dtype = torch.float32):
    t = _find(st, name)
    if t is None:
        if optional:
            return None
        raise KeyError(f"Missing tensor: {name}")
    return st.get_f32(t) if dtype == torch.float32 else st.get_bf16(t)


def load_weights(st, cfg: FlowLMConfig = FlowLMConfig(),
                 dtype: torch.dtype = torch.float32) -> dict:
    """The FlowLM host dict from a SafetensorsFile; leaf for leaf the dict
    ptts_tpu.models.flowlm.load_weights returns.

    ``dtype=torch.float32``: f32 numpy arrays. ``dtype=torch.bfloat16`` is
    the bf16 engine's cold start: torch.bfloat16 CPU tensors, BF16-stored
    ones zero-copy views of the checkpoint mmap (no host f32 round trip,
    half the upload bytes), others rounded to nearest even
    (SafetensorsFile.get_bf16), bit for bit the JAX package's bf16 load."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"load_weights: dtype {dtype} is not float32 or bfloat16")
    L, D = cfg.num_layers, cfg.flow_depth
    stack_fn = np.stack if dtype == torch.float32 else torch.stack

    def stack(fmt: str, n: int = L, optional: bool = False):
        vals = [_get(st, fmt.format(i), optional=optional, dtype=dtype) for i in range(n)]
        return None if any(v is None for v in vals) else stack_fn(vals)

    def get(name: str, optional: bool = False):
        return _get(st, name, optional=optional, dtype=dtype)

    tl = "transformer.layers.{}."
    te = "flow_net.time_embed.{}."
    rb = "flow_net.res_blocks.{}."
    return {
        "embed": get("conditioner.embed.weight"),
        "speaker_proj": get("speaker_proj_weight", optional=True),
        "emb_std": get("emb_std"),
        "emb_mean": get("emb_mean"),
        "bos_emb": get("bos_emb"),
        "input_linear": get("input_linear.weight"),
        "out_norm_w": get("out_norm.weight"),
        "out_norm_b": get("out_norm.bias"),
        "out_eos_w": get("out_eos.weight").reshape(-1),
        "out_eos_b": get("out_eos.bias").reshape(()),
        "in_proj": stack(tl + "self_attn.in_proj.weight"),
        "out_proj": stack(tl + "self_attn.out_proj.weight"),
        "norm1_w": stack(tl + "norm1.weight"),
        "norm1_b": stack(tl + "norm1.bias"),
        "norm2_w": stack(tl + "norm2.weight"),
        "norm2_b": stack(tl + "norm2.bias"),
        "linear1": stack(tl + "linear1.weight"),
        "linear2": stack(tl + "linear2.weight"),
        "flow": {
            "cond_w": get("flow_net.cond_embed.weight"),
            "cond_b": get("flow_net.cond_embed.bias"),
            "input_w": get("flow_net.input_proj.weight"),
            "input_b": get("flow_net.input_proj.bias"),
            "time": {
                "lin0_w": stack(te + "mlp.0.weight", 2),
                "lin0_b": stack(te + "mlp.0.bias", 2),
                "lin2_w": stack(te + "mlp.2.weight", 2),
                "lin2_b": stack(te + "mlp.2.bias", 2),
                "rms_alpha": stack(te + "mlp.3.alpha", 2),
                "freqs": stack(te + "freqs", 2, optional=True),
            },
            "res": {
                "in_ln_w": stack(rb + "in_ln.weight", D),
                "in_ln_b": stack(rb + "in_ln.bias", D),
                "mlp0_w": stack(rb + "mlp.0.weight", D),
                "mlp0_b": stack(rb + "mlp.0.bias", D),
                "mlp2_w": stack(rb + "mlp.2.weight", D),
                "mlp2_b": stack(rb + "mlp.2.bias", D),
                "ada_w": stack(rb + "adaLN_modulation.1.weight", D),
                "ada_b": stack(rb + "adaLN_modulation.1.bias", D),
            },
            "final_linear_w": get("flow_net.final_layer.linear.weight"),
            "final_linear_b": get("flow_net.final_layer.linear.bias"),
            "final_ada_w": get("flow_net.final_layer.adaLN_modulation.1.weight"),
            "final_ada_b": get("flow_net.final_layer.adaLN_modulation.1.bias"),
        },
    }


def to_device(w: dict, dtype: torch.dtype = torch.float32, cfg: FlowLMConfig = FlowLMConfig(),
              device="cpu", stats=None) -> convert.TensorTree:
    """The host dict as device weights in the compute dtype, in_proj's Q/K
    rows permuted to the halves RoPE layout, through one packed copy
    (convert.flowlm_weights, utils/packing). The model below rotates halves,
    so device weights must come through here. ``stats``: see
    utils/packing.tree_to_device."""
    return convert.flowlm_weights(w, cfg, dtype, device, stats)


# ---------------------------------------------------------------------------
# Model math
# ---------------------------------------------------------------------------


def _linear(w: torch.Tensor, b: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b in the wider of the two dtypes, returned in x's dtype
    (f32 time embeddings meet bf16 weights in bf16 mode)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = F.linear(x.to(dt), w.to(dt), None if b is None else b.to(dt))
    return y.to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """Batched per-layer KV cache, [L, B, Tmax, H, D].

    Cursor-aligned as in the JAX package: every stream's step-i key lands in
    the same column, and a stream's column t is valid iff t < prefix_len[b]
    or it holds a decode write at or after start[b]. Decode columns form a
    ring of R = Tmax - t0 columns after the prefix region; the offline path
    sizes the cache prefix + frames, so it never wraps. ``cursor`` is a 0-d
    int32 tensor on the cache's device, as in the JAX package, so a captured
    frame (runtime/graphs) reads and advances it in place; ``t0`` is fixed
    for the cache's life and stays a host int. ``cursor_host`` mirrors the
    cursor on the host where the eager path keeps it (None where a graph
    advances the cursor); only the blocked decode attention reads it.
    decode_step writes k and v IN PLACE and advances the cursor in place."""

    k: torch.Tensor
    v: torch.Tensor
    prefix_len: torch.Tensor  # [B] int32
    start: torch.Tensor       # [B] int32
    cursor: torch.Tensor      # 0-d int32: next decode write (monotonic)
    t0: int                   # first decode column
    cursor_host: Optional[int] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def ring(self) -> int:
        """R, the number of decode columns."""
        return max(self.max_len - self.t0, 1)

    @property
    def pos(self) -> torch.Tensor:
        """[B] token position of the next write."""
        return self.prefix_len + (self.cursor - self.start)

    @property
    def write_col(self) -> torch.Tensor:
        """0-d ring column of the next decode write."""
        return self.t0 + torch.remainder(self.cursor - self.t0, self.ring)

    def valid_mask(self, through_cursor: bool = True) -> torch.Tensor:
        """[B, Tmax] bool key validity (incl. the write at ``cursor`` when
        ``through_cursor``); ring column j holds the latest decode write m
        with m % R == j."""
        t = torch.arange(self.max_len, device=self.k.device)[None, :]
        hi = self.cursor + 1 if through_cursor else self.cursor
        R = self.ring
        M = hi - self.t0
        j = t - self.t0
        abs_idx = self.t0 + M - 1 - torch.remainder(M - 1 - j, R)
        dec_valid = ((j >= 0) & (j < torch.clamp(M, max=R))
                     & (abs_idx >= self.start[:, None]) & (abs_idx < hi))
        return (t < self.prefix_len[:, None]) | dec_valid


def seek(cache: KVCache, cursor: int, t0: int) -> KVCache:
    """The cache with its cursor set to ``cursor`` in place and its first
    decode column at ``t0`` (host mirror included)."""
    cache.cursor.fill_(cursor)
    return dataclasses.replace(cache, t0=t0, cursor_host=cursor)


def make_cache(cfg: FlowLMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32, device="cpu") -> KVCache:
    """An empty [L, batch, max_len, H, D] cache for ``prefill`` to fill."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   prefix_len=torch.zeros(batch, dtype=torch.int32, device=device),
                   start=torch.zeros(batch, dtype=torch.int32, device=device),
                   cursor=torch.zeros((), dtype=torch.int32, device=device), t0=0,
                   cursor_host=0)


def resolve_prefill_impl(choice: str = "auto", device="cpu") -> str:
    """The prefill attention for an engine on ``device``: "kernel" (B1,
    ops/cuda/fused_attention.causal_attention_qkv) or "plain" (its plain
    version). "auto" consults PTTS_PALLAS_PREFILL (0 -> plain, 1 -> kernel),
    then the device; "kernel" on a CPU device raises ValueError
    (config.resolve_kernel_impl)."""
    on_card = torch.device(device).type == "cuda"
    return resolve_kernel_impl(choice, "PTTS_PALLAS_PREFILL", on_card, "prefill_impl")


def prefill_kv(w, x: torch.Tensor, lengths: torch.Tensor, cfg: FlowLMConfig,
               attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched causal prompt pass over x [B, T, d] with [B] int32 valid
    lengths. Returns (k [L, B, T, H, D], v, last [B, d]). ``attn_impl``:
    "kernel" (B1; on a CPU tensor its wrapper computes the plain version),
    "plain" (the plain version on any device) or "auto" (from x's device:
    the kernel on CUDA)."""
    B, T, d = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    if attn_impl == "auto":
        attn_impl = "kernel" if x.device.type == "cuda" else "plain"
    if attn_impl not in ("kernel", "plain"):
        raise ValueError(f"attn_impl {attn_impl!r}: expected auto, kernel or plain")
    attention = causal_attention_qkv if attn_impl == "kernel" else causal_attention_qkv_plain
    ks, vs = [], []
    for l in range(cfg.num_layers):
        xn = layernorm(x, w.norm1_w[l], w.norm1_b[l], cfg.ln_eps)
        qkv = _linear(w.in_proj[l], None, xn)
        attn, k_rot = attention(qkv, lengths, num_heads=H, head_dim=D,
                                max_period=cfg.max_period)
        ks.append(k_rot.reshape(B, T, H, D))
        vs.append(qkv[..., 2 * d :].reshape(B, T, H, D))
        x = x + _linear(w.out_proj[l], None, attn)
        xn = layernorm(x, w.norm2_w[l], w.norm2_b[l], cfg.ln_eps)
        x = x + _linear(w.linear2[l], None, gelu_erf(_linear(w.linear1[l], None, xn)))
    last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    return torch.stack(ks), torch.stack(vs), last


def prefill_init(w, x: torch.Tensor, lengths: torch.Tensor, cfg: FlowLMConfig,
                 max_len: int, attn_impl: str = "auto",
                 graphs=None) -> Tuple[KVCache, torch.Tensor]:
    """Prompt pass that builds a [L, B, max_len, H, D] cache holding the
    prompt's K/V in its first T columns (``attn_impl``: see prefill_kv).
    With ``graphs`` (runtime/graphs.GraphCache) the cache is the one it
    keeps for this shape (static_cache), which the captured loop reads."""
    B = x.shape[0]
    cache = (make_cache(cfg, B, max_len, x.dtype, x.device) if graphs is None
             else static_cache(graphs, cfg, B, max_len, x.dtype, x.device))
    return prefill(w, cache, x, lengths, cfg, attn_impl)


def prefill(w, cache: KVCache, x: torch.Tensor, lengths: torch.Tensor,
            cfg: FlowLMConfig, attn_impl: str = "auto") -> Tuple[KVCache, torch.Tensor]:
    """Prompt pass into an existing cache: the prompt's K/V go to its first
    T columns in place, and start = t0 = cursor = T. Returns the cache and
    the transformer output at each stream's last valid position [B, d]."""
    T = x.shape[1]
    k_new, v_new, last = prefill_kv(w, x, lengths, cfg, attn_impl)
    cache.k[:, :, :T] = k_new.to(cache.k.dtype)
    cache.v[:, :, :T] = v_new.to(cache.v.dtype)
    cache.prefix_len.copy_(lengths)
    cache.start.fill_(T)
    return seek(cache, T, T), last


def _host_write_col(cache: KVCache) -> int:
    """The write column from the host mirror of the cursor: the blocked
    decode attention's trip count, which must not need a device read."""
    if cache.cursor_host is None:
        raise ValueError("the blocked decode attention needs the cursor's host mirror, which "
                         "only the eager frame loop keeps (graphs never run this path)")
    return cache.t0 + (cache.cursor_host - cache.t0) % cache.ring


def decode_step(w, cache: KVCache, x: torch.Tensor, cfg: FlowLMConfig,
                flags: KernelFlags = DEFAULT_FLAGS,
                live: Optional[torch.Tensor] = None) -> Tuple[KVCache, torch.Tensor]:
    """One KV-cached transformer step for B streams [B, d] at their own
    positions; writes each layer's k/v at the cursor column in place and
    advances the cursor in place (the returned cache shares every tensor
    with ``cache``). The decode attention is the one ``flags`` chooses
    (_decode_attention_dispatch). ``live`` (0-d bool, the chunked loop's
    gate): when False the column keeps its old k/v and the cursor stays."""
    B, d = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    pos = cache.pos
    col = cache.write_col.reshape(1).long()
    scalars = None
    if flags.decode_impl == "blocked":
        scalars = (cache.prefix_len, cache.start, _host_write_col(cache))
    mask = cache.valid_mask(through_cursor=True)
    for l in range(cfg.num_layers):
        xn = layernorm(x, w.norm1_w[l], w.norm1_b[l], cfg.ln_eps)
        qkv = _linear(w.in_proj[l], None, xn)
        q, k, v = (qkv[:, i * d : (i + 1) * d].reshape(B, 1, H, D) for i in range(3))
        q, k = rope_rotate_halves(q, k, pos[:, None], cfg.max_period)
        k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
        if live is not None:
            k = torch.where(live, k, cache.k[l].index_select(1, col))
            v = torch.where(live, v, cache.v[l].index_select(1, col))
        cache.k[l].index_copy_(1, col, k)
        cache.v[l].index_copy_(1, col, v)
        attn = _decode_attention_dispatch(q[:, 0], cache.k[l], cache.v[l], mask, scalars, flags)
        x = x + _linear(w.out_proj[l], None, attn.reshape(B, d))
        xn = layernorm(x, w.norm2_w[l], w.norm2_b[l], cfg.ln_eps)
        x = x + _linear(w.linear2[l], None, gelu_erf(_linear(w.linear1[l], None, xn)))
    cache.cursor.add_(1 if live is None else live.to(torch.int32))
    mirror = None if cache.cursor_host is None or live is not None else cache.cursor_host + 1
    return dataclasses.replace(cache, cursor_host=mirror), x


# ---------------------------------------------------------------------------
# Flow net + LSD sampler
# ---------------------------------------------------------------------------


def timestep_embed(w, idx: int, t: torch.Tensor, cfg: FlowLMConfig) -> torch.Tensor:
    """Sinusoidal timestep embedding + MLP + kyutai RMSNorm; t: [S] (f32)."""
    tw = w.flow.time
    if tw.freqs is not None:
        freqs = tw.freqs[idx]
    else:
        i = torch.arange(cfg.time_freqs, dtype=torch.float32, device=t.device)
        freqs = torch.exp(-math.log(cfg.max_period) * (i / cfg.time_freqs))
    angle = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(angle), torch.sin(angle)], dim=-1)
    h = silu(_linear(tw.lin0_w[idx], tw.lin0_b[idx], emb))
    out = _linear(tw.lin2_w[idx], tw.lin2_b[idx], h)
    return kyutai_rmsnorm(out, tw.rms_alpha[idx], cfg.rms_eps)


def lsd_time_embeds(w, num_steps: int, cfg: FlowLMConfig) -> torch.Tensor:
    """(ts + tt) / 2 per Euler step, [num_steps, flow_dim]: the step grid is
    static, so this is computed once per generate call, not per frame."""
    i = torch.arange(num_steps, dtype=torch.float32, device=w.flow.cond_w.device)
    ts = timestep_embed(w, 0, i / num_steps, cfg)
    tt = timestep_embed(w, 1, (i + 1) / num_steps, cfg)
    return (ts + tt) * 0.5


def flow_net(w, cond_emb: torch.Tensor, time_emb: torch.Tensor, x_in: torch.Tensor,
             cfg: FlowLMConfig) -> torch.Tensor:
    """adaLN-modulated residual MLP stack: cond_emb [B, fd], time_emb [fd],
    x_in [B, latent] -> flow [B, latent]."""
    fw = w.flow
    fd = cfg.flow_dim
    x = _linear(fw.input_w, fw.input_b, x_in)
    mod = silu(time_emb.to(cond_emb.dtype) + cond_emb)
    res = fw.res
    for b in range(cfg.flow_depth):
        h = layernorm(x, res.in_ln_w[b], res.in_ln_b[b], cfg.flow_ln_eps)
        ada = _linear(res.ada_w[b], res.ada_b[b], mod)
        shift, scale, gate = ada[..., :fd], ada[..., fd : 2 * fd], ada[..., 2 * fd :]
        h = h * (1.0 + scale) + shift
        h = _linear(res.mlp2_w[b], res.mlp2_b[b], silu(_linear(res.mlp0_w[b], res.mlp0_b[b], h)))
        x = x + gate * h
    h = layernorm(x, None, None, cfg.flow_ln_eps)
    ada2 = _linear(fw.final_ada_w, fw.final_ada_b, mod)
    h = h * (1.0 + ada2[..., fd:]) + ada2[..., :fd]
    return _linear(fw.final_linear_w, fw.final_linear_b, h)


def lsd_decode(w, cond: torch.Tensor, time_embs: torch.Tensor, x: torch.Tensor,
               cfg: FlowLMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler sampler from noise x [B, latent]. Returns (latent, first_flow)."""
    fw = w.flow
    cond_emb = _linear(fw.cond_w, fw.cond_b, cond)
    num_steps = time_embs.shape[0]
    first = None
    for i in range(num_steps):
        flow = flow_net(w, cond_emb, time_embs[i], x, cfg)
        if first is None:
            first = flow
        x = x + flow / num_steps
    return x, first


def lsd_decode_ragged(w, cond: torch.Tensor, time_embs: torch.Tensor,
                      num_steps: torch.Tensor, x: torch.Tensor, cfg: FlowLMConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler sampler with per-stream step counts: time_embs [B, S_max, fd]
    (stream b's own lsd_time_embeds padded to S_max), num_steps [B] int32.
    Every stream pays S_max flow_net calls; steps >= n_b are masked no-ops.
    Returns (latent, first_flow)."""
    fw = w.flow
    cond_emb = _linear(fw.cond_w, fw.cond_b, cond)
    n_b = torch.clamp(num_steps, min=1).float()[:, None]
    first = None
    for i in range(time_embs.shape[1]):
        flow = flow_net(w, cond_emb, time_embs[:, i], x, cfg)
        if first is None:
            first = flow
        active = (i < num_steps)[:, None]
        x = x + torch.where(active, flow / n_b.to(flow.dtype), 0.0)
    return x, first


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


class GenResult(NamedTuple):
    latents: torch.Tensor       # [B, F, latent_dim]
    frames_used: torch.Tensor   # [B] int32
    eos_logits: torch.Tensor    # [B, F] f32
    first_cond: torch.Tensor    # [B, d_model] parity tap
    first_flow: torch.Tensor    # [B, latent_dim] parity tap
    cache: Optional[KVCache] = None
    x: Optional[torch.Tensor] = None
    eos_step: Optional[torch.Tensor] = None
    done: Optional[torch.Tensor] = None


def eos_logit(w, normed: torch.Tensor) -> torch.Tensor:
    return normed @ w.out_eos_w + w.out_eos_b


def frame_step(w, cache: KVCache, x: torch.Tensor, noise: torch.Tensor,
               time_embs: torch.Tensor, i, eos_step: torch.Tensor, done: torch.Tensor,
               cfg: FlowLMConfig, *, eos_enabled: bool = True, eos_threshold=-4.0,
               eos_min_frames=1, eos_after=0, max_frames: Optional[torch.Tensor] = None,
               num_steps: Optional[torch.Tensor] = None, flags: KernelFlags = DEFAULT_FLAGS,
               live: Optional[torch.Tensor] = None):
    """One generation frame for B streams: out_norm -> EOS -> LSD ->
    input_linear -> KV decode step.

    ``i`` is the frame index (host int, 0-d or [B] tensor); the EOS
    threshold and min-frames are scalars, 0-d or [B] tensors; frame i is
    emitted, then a stream is done once i >= eos_step + eos_after or i + 1 >=
    max_frames[b]. A [B, S_max, fd] ``time_embs`` takes per-stream step
    counts ``num_steps`` [B] (lsd_decode_ragged). ``live``: see decode_step.
    Returns (cache, x, latent, eos, eos_step, done, normed, first_flow)."""
    normed = layernorm(x, w.out_norm_w, w.out_norm_b, cfg.ln_eps)
    eos = eos_logit(w, normed)
    if eos_enabled:
        hit = (eos >= eos_threshold) & ((i + 1) >= eos_min_frames)
        eos_step = torch.where((eos_step < 0) & hit, i, eos_step)
    if time_embs.dim() == 3:
        latent, flow0 = lsd_decode_ragged(w, normed, time_embs, num_steps, noise, cfg)
    else:
        latent, flow0 = lsd_decode(w, normed, time_embs, noise, cfg)
    done = done | ((eos_step >= 0) & (i >= eos_step + eos_after))
    if max_frames is not None:
        done = done | (i + 1 >= max_frames)
    cache, x = decode_step(w, cache, _linear(w.input_linear, None, latent), cfg, flags, live)
    return cache, x, latent, eos, eos_step, done, normed, flow0


# Frames per captured chunk of the offline loop (runtime/graphs): the host
# reads done.all() once per chunk instead of once per frame. 8 frames are
# 640 ms of audio: at most 7 frames past the last stream's end run (gated,
# changing nothing), and a 64-frame bucket takes 8 host checks, not 64.
GRAPH_CHUNK = 8

# done.all() reads of the offline frame loops in this process (the loop's
# host syncs; tests and chip_smoke read the difference across a call)
HOST_CHECKS = 0


@dataclasses.dataclass(eq=False)
class FrameLoop:
    """The offline frame loop's inputs and carry, all on the device: the
    state of the JAX package's lax.while_loop (generate_latents_while) and
    lax.scan (generate_latents). ``advance`` updates it in place, so a
    captured chunk of frames replays on the same tensors, and a loop kept
    for one shape is reloaded, not reallocated, by every call."""

    cache: KVCache
    x: torch.Tensor               # [B, d_model]
    noise: torch.Tensor           # [B, F, latent]
    time_embs: torch.Tensor       # [S, flow_dim]
    eos_threshold: torch.Tensor   # 0-d f32 (1e30: EOS never fires)
    eos_min_frames: torch.Tensor  # 0-d int32
    eos_after: torch.Tensor       # [B] int32
    max_frames: Optional[torch.Tensor]  # [B] int32 per-stream budgets
    i: torch.Tensor               # 0-d int32 frame index
    j: torch.Tensor               # 0-d int32 output column (i - frame0)
    eos_step: torch.Tensor        # [B] int32
    done: torch.Tensor            # [B] bool
    used: torch.Tensor            # [B] int32
    latents: torch.Tensor         # [B, F, latent]
    eos_logits: torch.Tensor      # [B, F] f32
    first_cond: torch.Tensor      # [B, d_model]
    first_flow: torch.Tensor      # [B, latent]

    @classmethod
    def alloc(cls, cache: KVCache, frames: int, num_steps: int, cfg: FlowLMConfig, dtype,
              budgets: bool) -> "FrameLoop":
        B, dev = cache.k.shape[1], cache.k.device

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        i32 = torch.int32
        return cls(cache=cache, x=zeros(B, cfg.d_model), noise=zeros(B, frames, cfg.latent_dim),
                   time_embs=zeros(num_steps, cfg.flow_dim, dt=torch.float32),
                   eos_threshold=zeros(dt=torch.float32), eos_min_frames=zeros(dt=i32),
                   eos_after=zeros(B, dt=i32), max_frames=zeros(B, dt=i32) if budgets else None,
                   i=zeros(dt=i32), j=zeros(dt=i32), eos_step=zeros(B, dt=i32),
                   done=zeros(B, dt=torch.bool), used=zeros(B, dt=i32),
                   latents=zeros(B, frames, cfg.latent_dim),
                   eos_logits=zeros(B, frames, dt=torch.float32),
                   first_cond=zeros(B, cfg.d_model), first_flow=zeros(B, cfg.latent_dim))

    def load(self, x0, noise, time_embs, eos_threshold, eos_min_frames, eos_after,
             max_frames_per_stream, frame0: int, eos_step0, done0, used0) -> None:
        """Refill every input and reset the carry (the cache is the caller's)."""
        self.x.copy_(x0)
        self.noise.copy_(noise)
        self.time_embs.copy_(time_embs)
        self.eos_threshold.fill_(eos_threshold)
        self.eos_min_frames.fill_(eos_min_frames)
        if np.ndim(eos_after) == 0:
            self.eos_after.fill_(int(eos_after))
        else:
            self.eos_after.copy_(torch.as_tensor(eos_after))
        if self.max_frames is not None:
            self.max_frames.copy_(max_frames_per_stream)
        self.i.fill_(frame0)
        self.j.zero_()
        for buf, init, empty in ((self.eos_step, eos_step0, -1), (self.done, done0, False),
                                 (self.used, used0, 0)):
            if init is None:
                buf.fill_(empty)
            else:
                buf.copy_(init)
        for buf in (self.latents, self.eos_logits, self.first_cond, self.first_flow):
            buf.zero_()

    def advance(self, w, n: int, cfg: FlowLMConfig, *, eos_enabled: bool, gate: bool,
                flags: KernelFlags = DEFAULT_FLAGS) -> None:
        """``n`` frames through frame_step, in place: JAX's loop body. With
        ``gate`` a frame that starts with every stream done changes nothing
        (JAX's while_loop condition), so a chunk may run past the end."""
        cache, x, i, j = self.cache, self.x, self.i, self.j
        eos_step, done, used = self.eos_step, self.done, self.used
        first_cond, first_flow = self.first_cond, self.first_flow
        for _ in range(n):
            live = ~done.all() if gate else None
            col = j.reshape(1).long()
            was_done = done
            cache, x_new, latent, eos, eos_step_new, done_new, normed, flow0 = frame_step(
                w, cache, x, self.noise.index_select(1, col)[:, 0], self.time_embs, i,
                eos_step, done, cfg, eos_enabled=eos_enabled, eos_threshold=self.eos_threshold,
                eos_min_frames=self.eos_min_frames, eos_after=self.eos_after,
                max_frames=self.max_frames, flags=flags, live=live)
            first = i == 0 if live is None else (i == 0) & live
            first_cond = torch.where(first, normed, first_cond)
            first_flow = torch.where(first, flow0, first_flow)
            used_new = torch.where(was_done, used, i + 1)
            lat = latent.to(self.latents.dtype)[:, None]
            eos = eos.float()[:, None]
            if live is not None:
                x_new, eos_step_new, done_new, used_new = (
                    torch.where(live, new, old) for new, old in
                    ((x_new, x), (eos_step_new, eos_step), (done_new, done), (used_new, used)))
                lat = torch.where(live, lat, self.latents.index_select(1, col))
                eos = torch.where(live, eos, self.eos_logits.index_select(1, col))
            self.latents.index_copy_(1, col, lat)
            self.eos_logits.index_copy_(1, col, eos)
            step = 1 if live is None else live.to(torch.int32)
            i, j = i + step, j + step
            x, eos_step, done, used = x_new, eos_step_new, done_new, used_new
        self.cache = cache
        for dst, src in ((self.x, x), (self.i, i), (self.j, j), (self.eos_step, eos_step),
                         (self.done, done), (self.used, used), (self.first_cond, first_cond),
                         (self.first_flow, first_flow)):
            if src is not dst:
                dst.copy_(src)

    def result(self, frame0: int, frames: int) -> GenResult:
        return GenResult(latents=self.latents,
                         frames_used=torch.where(self.done, self.used, frame0 + frames),
                         eos_logits=self.eos_logits, first_cond=self.first_cond,
                         first_flow=self.first_flow, cache=self.cache, x=self.x,
                         eos_step=self.eos_step, done=self.done)


def run_chunks(done: torch.Tensor, frames: int, chunk: int, stop_when_done: bool,
               advance) -> None:
    """``frames`` frames as ``advance(n)`` calls of ``chunk`` frames (the
    last one shorter). With ``stop_when_done`` the host reads done.all()
    once before each chunk (HOST_CHECKS; the span ``ptts.loop.check``) and
    stops once every stream is done: at most ceil(frames / chunk) reads."""
    global HOST_CHECKS
    t = 0
    while t < frames:
        if stop_when_done:
            HOST_CHECKS += 1
            with timing.span("ptts.loop.check"):
                finished = bool(done.all())
            if finished:
                break
        n = min(chunk, frames - t)
        advance(n)
        t += n


def static_cache(graphs, cfg: FlowLMConfig, batch: int, max_len: int, dtype,
                 device) -> KVCache:
    """The KV cache that ``graphs`` (runtime/graphs.GraphCache) keeps for
    this shape: the captured frame loop reads it at a fixed address, so
    prefill_init writes the prompt straight into it."""
    return graphs.buffers(("kv", batch, max_len, dtype, str(device)),
                          lambda: make_cache(cfg, batch, max_len, dtype, device))


def _frame_loop(w, cache: KVCache, x: torch.Tensor, noise: torch.Tensor, cfg: FlowLMConfig,
                max_frames: int, num_steps: int, *, stop_when_done: bool, eos_enabled: bool,
                eos_threshold, eos_min_frames, eos_after, max_frames_per_stream=None,
                frame0: int = 0, eos_step0=None, done0=None, used0=None,
                flags: KernelFlags = DEFAULT_FLAGS, graphs=None) -> GenResult:
    """Frames frame0 .. frame0 + max_frames - 1 through frame_step, with the
    per-stream EOS state and the parity taps of frame 0. Without ``graphs``
    the frames run eagerly one by one (a host check before each) on a fresh
    FrameLoop around ``cache``; with ``graphs`` they run in GRAPH_CHUNK-frame
    chunks, each a graph replay on the loop that ``graphs`` keeps for this
    shape, over its kept cache (``cache`` must come from prefill_init with
    the same ``graphs``), and the returned tensors are copies, but for the
    kept cache."""
    B = x.shape[0]
    time_embs = lsd_time_embeds(w, num_steps, cfg)
    chunk = 1 if graphs is None else GRAPH_CHUNK
    gate = stop_when_done and chunk > 1
    load = (x, noise, time_embs, eos_threshold, eos_min_frames, eos_after,
            max_frames_per_stream, frame0, eos_step0, done0, used0)
    budgets = max_frames_per_stream is not None
    if graphs is None:
        lp = FrameLoop.alloc(cache, max_frames, num_steps, cfg, x.dtype, budgets)
        lp.load(*load)
        run_chunks(lp.done, max_frames, chunk, stop_when_done,
                   lambda n: lp.advance(w, n, cfg, eos_enabled=eos_enabled, gate=gate,
                                        flags=flags))
        return lp.result(frame0, max_frames)

    dev = cache.k.device
    kv = static_cache(graphs, cfg, B, cache.max_len, cache.k.dtype, dev)
    if kv.k.data_ptr() != cache.k.data_ptr():
        raise ValueError("with graphs, the cache must be the one prefill_init(..., graphs=) "
                         "filled: the captured loop reads it at its address")
    shape = (B, cache.max_len, max_frames, num_steps, x.dtype, budgets)
    lp = graphs.buffers(("frame_loop",) + shape, lambda: FrameLoop.alloc(
        kv, max_frames, num_steps, cfg, x.dtype, budgets))
    lp.cache = dataclasses.replace(kv, t0=cache.t0, cursor_host=None)
    lp.load(*load)
    body = ("frame_loop",) + shape + (cache.t0, eos_enabled, gate, flags)
    # one eager chunk warms up, so a call of two chunks or more captures
    run_chunks(lp.done, max_frames, chunk, stop_when_done,
               lambda n: graphs.run(body + (n,), dev, lambda: lp.advance(
                   w, n, cfg, eos_enabled=eos_enabled, gate=gate, flags=flags), warmup=1))
    res = lp.result(frame0, max_frames)
    return res._replace(**{f: getattr(res, f).clone() for f in res._fields
                           if f != "cache" and getattr(res, f) is not None})


def generate_latents(
    w,
    cache: KVCache,             # prefilled (prefill / prefill_init)
    x0: torch.Tensor,           # [B, d_model] transformer output at BOS
    noise: torch.Tensor,        # [B, max_frames, latent_dim]
    cfg: FlowLMConfig,
    max_frames: int,
    num_steps: int,
    eos_enabled: bool = True,
    eos_threshold: float = -4.0,
    eos_min_frames: int = 1,
    eos_after=0,                # int or [B]
    frame0: int = 0,
    eos_step0: Optional[torch.Tensor] = None,
    done0: Optional[torch.Tensor] = None,
    used0: Optional[torch.Tensor] = None,
    flags: KernelFlags = DEFAULT_FLAGS,
    graphs=None,
) -> GenResult:
    """Fixed-length frame loop: all max_frames frames run, with no host sync.
    Resumable: pass the returned cache and x as the next call's cache and
    x0, with frame0 advanced and the returned eos_step/done/frames_used as
    eos_step0/done0/used0; two calls then equal one call of both lengths.
    ``graphs`` (runtime/graphs.GraphCache): the frames run as replays of
    captured GRAPH_CHUNK-frame chunks (see _frame_loop)."""
    return _frame_loop(w, cache, x0, noise, cfg, max_frames, num_steps,
                       stop_when_done=False, eos_enabled=eos_enabled,
                       eos_threshold=eos_threshold, eos_min_frames=eos_min_frames,
                       eos_after=eos_after, frame0=frame0, eos_step0=eos_step0,
                       done0=done0, used0=used0, flags=flags, graphs=graphs)


def generate_latents_while(
    w,
    cache: KVCache,             # prefilled (prefill_init)
    x0: torch.Tensor,           # [B, d_model] transformer output at BOS
    noise: torch.Tensor,        # [B, max_frames, latent_dim]
    cfg: FlowLMConfig,
    max_frames: int,
    num_steps: int,
    eos_threshold: float = -4.0,
    eos_min_frames: int = 1,
    eos_after=0,                # int or [B]
    max_frames_per_stream: Optional[torch.Tensor] = None,  # [B]
    flags: KernelFlags = DEFAULT_FLAGS,
    graphs=None,
) -> GenResult:
    """The frame loop with per-stream EOS state, stopping once every stream
    is done, checked on the host before every frame, or with ``graphs``
    before every GRAPH_CHUNK frames. A frame that starts with every stream
    done changes nothing, as JAX's while_loop stops there: frames after the
    end stay zero in the output buffers. ``graphs``: see generate_latents."""
    return _frame_loop(w, cache, x0, noise, cfg, max_frames, num_steps,
                       stop_when_done=True, eos_enabled=True,
                       eos_threshold=eos_threshold, eos_min_frames=eos_min_frames,
                       eos_after=eos_after, max_frames_per_stream=max_frames_per_stream,
                       flags=flags, graphs=graphs)


def scale_latents(w, latents: torch.Tensor) -> torch.Tensor:
    """x * emb_std + emb_mean."""
    return latents * w.emb_std + w.emb_mean


def forward_next(w, seq: torch.Tensor, lengths: torch.Tensor, noise: torch.Tensor,
                 cfg: FlowLMConfig, num_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uncached O(T^2) forward over the whole sequence seq [B, T, d] (BOS and
    previous latents included): the next latent [B, latent] and EOS logit
    [B]. The cross-check of the KV-cached loop; tests use it."""
    _, _, last = prefill_kv(w, seq, lengths, cfg)
    normed = layernorm(last, w.out_norm_w, w.out_norm_b, cfg.ln_eps)
    eos = eos_logit(w, normed)
    latent, _ = lsd_decode(w, normed, lsd_time_embeds(w, num_steps, cfg), noise, cfg)
    return latent, eos


def embed_tokens(w, token_ids: torch.Tensor, cfg: FlowLMConfig) -> torch.Tensor:
    """Token ids -> embeddings; out-of-range ids clamp to row 0."""
    ids = torch.where((token_ids < 0) | (token_ids >= cfg.vocab + 1), 0, token_ids)
    return w.embed[ids.long()]
