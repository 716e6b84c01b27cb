"""FlowLM: text -> acoustic latents (port of ptts_tpu/models/flowlm.py).

Every function mirrors its JAX namesake and takes the weights first: ``w``
is the module from ptts_torch.convert.flowlm_weights, whose buffers carry
the JAX host dict's names (``w.in_proj`` is ``w["in_proj"]`` there). The
frame loops are Python loops over frame_step: generate_latents_while stops
once every stream is done, generate_latents runs a fixed, resumable number
of frames with no host sync, and runtime/streaming runs one frame per call.
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
    sizes the cache prefix + frames, so it never wraps. ``cursor`` and ``t0``
    are host integers (the frame loop runs on the host). decode_step writes
    k and v IN PLACE and returns the cache with the cursor advanced."""

    k: torch.Tensor
    v: torch.Tensor
    prefix_len: torch.Tensor  # [B] int32
    start: torch.Tensor       # [B] int32
    cursor: int               # next decode write (monotonic)
    t0: int                   # first decode column

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def pos(self) -> torch.Tensor:
        """[B] token position of the next write."""
        return self.prefix_len + (self.cursor - self.start)

    @property
    def write_col(self) -> int:
        """Ring column of the next decode write."""
        R = max(self.max_len - self.t0, 1)
        return self.t0 + (self.cursor - self.t0) % R

    def valid_mask(self, through_cursor: bool = True) -> torch.Tensor:
        """[B, Tmax] bool key validity (incl. the write at ``cursor`` when
        ``through_cursor``); ring column j holds the latest decode write m
        with m % R == j."""
        t = torch.arange(self.max_len, device=self.k.device)[None, :]
        hi = self.cursor + 1 if through_cursor else self.cursor
        R = max(self.max_len - self.t0, 1)
        M = hi - self.t0
        j = t - self.t0
        abs_idx = self.t0 + M - 1 - torch.remainder(M - 1 - j, R)
        dec_valid = ((j >= 0) & (j < min(M, R))
                     & (abs_idx >= self.start[:, None]) & (abs_idx < hi))
        return (t < self.prefix_len[:, None]) | dec_valid


def make_cache(cfg: FlowLMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32, device="cpu") -> KVCache:
    """An empty [L, batch, max_len, H, D] cache for ``prefill`` to fill."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   prefix_len=torch.zeros(batch, dtype=torch.int32, device=device),
                   start=torch.zeros(batch, dtype=torch.int32, device=device),
                   cursor=0, t0=0)


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
                 max_len: int, attn_impl: str = "auto") -> Tuple[KVCache, torch.Tensor]:
    """Prompt pass that builds a [L, B, max_len, H, D] cache holding the
    prompt's K/V in its first T columns (``attn_impl``: see prefill_kv)."""
    return prefill(w, make_cache(cfg, x.shape[0], max_len, x.dtype, x.device), x, lengths,
                   cfg, attn_impl)


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
    return dataclasses.replace(cache, cursor=T, t0=T), last


def decode_step(w, cache: KVCache, x: torch.Tensor, cfg: FlowLMConfig,
                flags: KernelFlags = DEFAULT_FLAGS) -> Tuple[KVCache, torch.Tensor]:
    """One KV-cached transformer step for B streams [B, d] at their own
    positions; writes each layer's k/v at the cursor column in place. The
    decode attention is the one ``flags`` chooses
    (_decode_attention_dispatch)."""
    B, d = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    pos = cache.pos
    col = cache.write_col
    mask = cache.valid_mask(through_cursor=True)
    for l in range(cfg.num_layers):
        xn = layernorm(x, w.norm1_w[l], w.norm1_b[l], cfg.ln_eps)
        qkv = _linear(w.in_proj[l], None, xn)
        q, k, v = (qkv[:, i * d : (i + 1) * d].reshape(B, 1, H, D) for i in range(3))
        q, k = rope_rotate_halves(q, k, pos[:, None], cfg.max_period)
        cache.k[l, :, col] = k[:, 0].to(cache.k.dtype)
        cache.v[l, :, col] = v[:, 0].to(cache.v.dtype)
        attn = _decode_attention_dispatch(q[:, 0], cache.k[l], cache.v[l], mask,
                                          (cache.prefix_len, cache.start, col), flags)
        x = x + _linear(w.out_proj[l], None, attn.reshape(B, d))
        xn = layernorm(x, w.norm2_w[l], w.norm2_b[l], cfg.ln_eps)
        x = x + _linear(w.linear2[l], None, gelu_erf(_linear(w.linear1[l], None, xn)))
    return dataclasses.replace(cache, cursor=cache.cursor + 1), x


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
               num_steps: Optional[torch.Tensor] = None, flags: KernelFlags = DEFAULT_FLAGS):
    """One generation frame for B streams: out_norm -> EOS -> LSD ->
    input_linear -> KV decode step.

    ``i`` is the frame index (host int or [B]); the EOS threshold and
    min-frames are scalars or [B]; frame i is emitted, then a stream is done
    once i >= eos_step + eos_after or i + 1 >= max_frames[b]. A [B, S_max, fd]
    ``time_embs`` takes per-stream step counts ``num_steps`` [B]
    (lsd_decode_ragged). Returns (cache, x, latent, eos, eos_step, done,
    normed, first_flow)."""
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
    cache, x = decode_step(w, cache, _linear(w.input_linear, None, latent), cfg, flags)
    return cache, x, latent, eos, eos_step, done, normed, flow0


def _frame_loop(w, cache: KVCache, x: torch.Tensor, noise: torch.Tensor, cfg: FlowLMConfig,
                max_frames: int, num_steps: int, *, stop_when_done: bool, eos_enabled: bool,
                eos_threshold, eos_min_frames, eos_after, max_frames_per_stream=None,
                frame0: int = 0, eos_step0=None, done0=None, used0=None,
                flags: KernelFlags = DEFAULT_FLAGS) -> GenResult:
    """Frames frame0 .. frame0 + max_frames - 1 through frame_step, with the
    per-stream EOS state and the parity taps of frame 0."""
    B = x.shape[0]
    dev = x.device
    time_embs = lsd_time_embeds(w, num_steps, cfg)
    eos_after = torch.as_tensor(eos_after, dtype=torch.int32, device=dev).expand(B)
    eos_step = (torch.full((B,), -1, dtype=torch.int32, device=dev)
                if eos_step0 is None else eos_step0)
    done = torch.zeros(B, dtype=torch.bool, device=dev) if done0 is None else done0
    used = torch.zeros(B, dtype=torch.int32, device=dev) if used0 is None else used0
    latents = x.new_zeros(B, max_frames, cfg.latent_dim)
    eos_logits = torch.zeros(B, max_frames, dtype=torch.float32, device=dev)
    first_cond = torch.zeros_like(x)
    first_flow = x.new_zeros(B, cfg.latent_dim)
    for j in range(max_frames):
        if stop_when_done and bool(done.all()):
            break
        i = frame0 + j
        was_done = done
        cache, x, latent, eos, eos_step, done, normed, flow0 = frame_step(
            w, cache, x, noise[:, j], time_embs, i, eos_step, done, cfg,
            eos_enabled=eos_enabled, eos_threshold=eos_threshold,
            eos_min_frames=eos_min_frames, eos_after=eos_after,
            max_frames=max_frames_per_stream, flags=flags)
        if i == 0:
            first_cond, first_flow = normed, flow0
        used = torch.where(was_done, used, i + 1)
        latents[:, j] = latent.to(latents.dtype)
        eos_logits[:, j] = eos.float()

    frames_used = torch.where(done, used, frame0 + max_frames)
    return GenResult(latents=latents, frames_used=frames_used, eos_logits=eos_logits,
                     first_cond=first_cond, first_flow=first_flow, cache=cache, x=x,
                     eos_step=eos_step, done=done)


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
) -> GenResult:
    """Fixed-length frame loop: all max_frames frames run, with no host sync.
    Resumable: pass the returned cache and x as the next call's cache and
    x0, with frame0 advanced and the returned eos_step/done/frames_used as
    eos_step0/done0/used0; two calls then equal one call of both lengths."""
    return _frame_loop(w, cache, x0, noise, cfg, max_frames, num_steps,
                       stop_when_done=False, eos_enabled=eos_enabled,
                       eos_threshold=eos_threshold, eos_min_frames=eos_min_frames,
                       eos_after=eos_after, frame0=frame0, eos_step0=eos_step0,
                       done0=done0, used0=used0, flags=flags)


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
) -> GenResult:
    """The frame loop with per-stream EOS state, stopping once every stream
    is done (one host sync per frame). Frames after that stay zero in the
    output buffers."""
    return _frame_loop(w, cache, x0, noise, cfg, max_frames, num_steps,
                       stop_when_done=True, eos_enabled=True,
                       eos_threshold=eos_threshold, eos_min_frames=eos_min_frames,
                       eos_after=eos_after, max_frames_per_stream=max_frames_per_stream,
                       flags=flags)


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
