"""The hybrid configuration (configs/pocket-tts-granite4h-bf16.json):
Granite 4.0-H's Mamba-2/GQA stack as FlowLM's backbone, with Pocket-TTS's
latent input, flow net, EOS head and Mimi. Everything the harness needs of
it beside the shared serving drive: the configuration made whole, the
weights by the backbone's schema, the system, the reference, and the
operations and bytes of its frames.

The configuration file holds Granite's published keys at its top level,
with ``num_hidden_layers`` cut and ``layer_types`` kept whole (the stack is
its first ``num_hidden_layers`` layers), and Pocket's head and Mimi widths
in its "flowlm" and "mimi" groups. ``expand`` fills the "flowlm" group with
every key of the port's FlowLMConfig, so the shared harness code (request
ids, voices, the frame tap, the Mimi checks) reads it as it reads
Pocket's.
"""

from __future__ import annotations

import math
import types
from typing import Dict, List

import numpy as np
import torch

from . import roofline, system as S, weights as W
from .reference.hybrid import HybridReference

def expand(cfg: dict) -> dict:
    """The configuration with its "flowlm" group made whole: Pocket's head
    widths as given, the backbone's from Granite's keys."""
    g = cfg
    if g["mamba_n_groups"] != 1 or g["position_embedding_type"] != "nope":
        raise ValueError("the port's hybrid takes one Mamba group and no position encoding")
    L, d, heads = g["num_hidden_layers"], g["hidden_size"], g["num_attention_heads"]
    f = dict(cfg["flowlm"])
    if f["ln_eps"] != g["rms_norm_eps"]:
        raise ValueError("out_norm's eps and the backbone's RMSNorm eps differ")
    f.update(vocab=g["vocab_size"], text_dim=d, d_model=d, num_heads=heads, head_dim=d // heads,
             num_layers=L, hidden=g["shared_intermediate_size"],
             layer_types=list(g["layer_types"][:L]), num_kv_heads=g["num_key_value_heads"],
             embedding_multiplier=float(g["embedding_multiplier"]),
             residual_multiplier=float(g["residual_multiplier"]),
             attention_multiplier=float(g["attention_multiplier"]),
             mamba_heads=g["mamba_n_heads"], mamba_head_dim=g["mamba_d_head"],
             mamba_d_state=g["mamba_d_state"], mamba_d_conv=g["mamba_d_conv"],
             mamba_expand=g["mamba_expand"], mamba_chunk=g["mamba_chunk_size"])
    return dict(cfg, flowlm=f)


def model_configs(cfg: dict):
    """The port's (FlowLMConfig, MimiConfig) of an expanded configuration.
    A port without the hybrid backbone raises TypeError here, before any
    weight is made."""
    from ptts_torch.config import FlowLMConfig, MimiConfig
    f = dict(cfg["flowlm"], layer_types=tuple(cfg["flowlm"]["layer_types"]))
    m = dict(cfg["mimi"], ratios=tuple(cfg["mimi"]["ratios"]))
    return FlowLMConfig(**f), MimiConfig(**m)


# -- weights ------------------------------------------------------------------


def mamba_dims(f: dict):
    """(H, P, N, K, conv channels, inner width) of a Mamba layer."""
    H, P, N, K = f["mamba_heads"], f["mamba_head_dim"], f["mamba_d_state"], f["mamba_d_conv"]
    return H, P, N, K, H * P + 2 * N, H * P


def flowlm_spec(f: dict) -> List[W.Spec]:
    """Pocket's FlowLM entries without its transformer, then each layer of
    the hybrid stack in Granite's names. Inits beyond weights.py's: ("u",
    b) uniform on [-b, b] (the conv's published PyTorch default, b =
    1/sqrt(d_conv)); "A_log" log U[1, 16]; "dt_bias" the inverse softplus
    of a log-uniform dt on [1e-3, 1e-1]; "one" ones (D)."""
    s = W.flowlm_spec(dict(f, num_layers=0))
    d, I = f["d_model"], f["hidden"]
    H, P, N, K, C, di = mamba_dims(f)
    Hq, Hk, D = f["num_heads"], f["num_kv_heads"], f["head_dim"]
    ub = ("u", 1.0 / math.sqrt(K))
    for i, kind in enumerate(f["layer_types"]):
        b = f"transformer.layers.{i}."
        s += [(b + "input_layernorm.weight", (d,), "1+"),
              (b + "post_attention_layernorm.weight", (d,), "1+"),
              (b + "shared_mlp.input_linear.weight", (2 * I, d), "n"),
              (b + "shared_mlp.output_linear.weight", (d, I), "n")]
        if kind == "mamba":
            m = b + "mamba."
            s += [(m + "in_proj.weight", (2 * di + 2 * N + H, d), "n"),
                  (m + "conv1d.weight", (C, 1, K), ub), (m + "conv1d.bias", (C,), ub),
                  (m + "dt_bias", (H,), "dt_bias"), (m + "A_log", (H,), "A_log"),
                  (m + "D", (H,), "one"), (m + "norm.weight", (di,), "1+"),
                  (m + "out_proj.weight", (d, di), "n")]
        else:
            a = b + "self_attn."
            s += [(a + "q_proj.weight", (Hq * D, d), "n"), (a + "k_proj.weight", (Hk * D, d), "n"),
                  (a + "v_proj.weight", (Hk * D, d), "n"), (a + "o_proj.weight", (d, Hq * D), "n")]
    return s


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the checkpoint on ``device`` in the configuration's
    dtype: one N(0, 1) draw per tensor, in spec order, from one generator
    seeded with ``seed`` (a uniform init maps its draw through the normal
    CDF), scaled and cast."""
    f = cfg["flowlm"]
    scale = float(cfg["assumed"]["weight_scale"])
    dtype = S.DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFFFFFFFFFF)
    tf = f["time_freqs"]
    base = torch.exp(-np.log(np.float32(f["max_period"]))
                     * (torch.arange(tf, dtype=torch.float32, device=device) / tf))
    out = {}
    for name, shape, init in flowlm_spec(f) + W.mimi_spec(cfg["mimi"]):
        z = torch.randn(shape, generator=gen, device=device)
        u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0))) if init not in ("n", "1+", "|1+|") else None
        if isinstance(init, tuple) and init[0] == "freqs":
            t = base * np.float32(0.5 ** init[1])
        elif isinstance(init, tuple):
            t = init[1] * (2.0 * u - 1.0)
        elif init == "A_log":
            t = torch.log(1.0 + 15.0 * u)
        elif init == "dt_bias":
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))).clamp(min=1e-4)
            t = dt + torch.log(-torch.expm1(-dt))
        elif init == "one":
            t = torch.ones_like(z)
        elif init == "|1+|":
            t = 1.0 + (scale * z).abs()
        else:
            t = {"n": 0.0, "1+": 1.0, ".5+": 0.5}[init] + scale * z
        out[name] = t.to(dtype).contiguous()
    return out


def n_params(cfg: dict) -> int:
    return W.n_params(flowlm_spec(cfg["flowlm"]))


# -- the system and the reference ------------------------------------------


def build(cfg: dict, seed: int, device, n_voices: int) -> S.System:
    """system.build for the hybrid: the port's TTSEngine over this schema's
    weights, loaded through the engine's own loader."""
    from ptts_torch.runtime.engine import TTSEngine

    dev = torch.device(device)
    fcfg, mcfg = model_configs(cfg)
    w = make_weights(cfg, seed, dev)
    voices = W.make_voices(cfg, n_voices, seed, dev)
    ctx = types.SimpleNamespace(device=dev, weights=W.MemCheckpoint(w), flowlm_cfg=fcfg,
                                mimi_cfg=mcfg, model_dir=None, tokenize=None)
    engine = TTSEngine(ctx, dtype=S.DTYPES[cfg["dtype"]])
    ctx.weights.close()
    return S.System(engine=engine, weights=w, voices=voices, cfg=cfg, device=dev)


def references(system, cfg: dict, controls):
    """check.references for the hybrid: the reference, its bf16 yardstick
    and the controls over one float32 copy of the weights."""
    from . import check
    w32 = {k: v.float() for k, v in system.weights.items()}
    refs = {p: HybridReference(w32, cfg, p)
            for p in dict.fromkeys(("f32", "bf16") + tuple(controls))}
    out = {"program": check.Readings()}
    out.update({p: check.Readings() for p in controls})
    return refs, out


# -- operations and bytes -----------------------------------------------------


def backbone_position_flops(f: dict) -> int:
    """Matmul operations of one position through the stack, but attention's
    q.k and p.v: each layer's MLP, and its Mamba mixer (projections, conv,
    the state's outer-product update and its contraction with C) or its
    attention projections."""
    d, I = f["d_model"], f["hidden"]
    H, P, N, K, C, di = mamba_dims(f)
    Hq, Hk, D = f["num_heads"], f["num_kv_heads"], f["head_dim"]
    total = 0
    for kind in f["layer_types"]:
        total += 2 * d * 2 * I + 2 * I * d
        if kind == "mamba":
            total += 2 * d * (2 * di + 2 * N + H) + 2 * di * d + 2 * C * K + 4 * H * P * N
        else:
            total += 2 * d * (Hq + 2 * Hk) * D + 2 * Hq * D * d
    return total


def attention_flops_per_key(f: dict) -> int:
    """q.k and p.v of one query against one cached key, over the attention
    layers."""
    return 4 * f["head_dim"] * f["num_heads"] * f["layer_types"].count("attention")


def stream_flops(f: dict, m: dict, prompt_len: int, f0: int, f1: int) -> int:
    """roofline.stream_flops for the hybrid: frames f0 .. f1 - 1 of one
    stream, each its latent's projection, one position through the stack
    with the keys in view, the EOS head, the sampler and its Mimi decode."""
    n = f1 - f0
    if n <= 0:
        return 0
    keys = n * (prompt_len + 1) + (f0 + f1 - 1) * n // 2
    heads_and_mimi = roofline.stream_flops(dict(f, num_layers=0), m, prompt_len, f0, f1)
    return heads_and_mimi + n * backbone_position_flops(f) + attention_flops_per_key(f) * keys


def state_bytes(f: dict, rows: int, dtype: str) -> int:
    """Bytes of the SSM and conv state that a cache of ``rows`` rows holds,
    in the served dtype."""
    H, P, N, K, C, _ = mamba_dims(f)
    per = (H * P * N + (K - 1) * C) * roofline.ESIZE[dtype]
    return f["layer_types"].count("mamba") * rows * per


def ssm_bytes_per_frame(f: dict, rows: int, dtype: str) -> int:
    """The least bytes the Mamba mixers' cores move in one frame of a pool
    of ``rows`` rows: each layer's SSM and conv state read and written
    once, z, xBC and dt read, y written (the marker kernels'
    ptts_mark_ssm_in .. _out stretch)."""
    H, P, N, K, C, di = mamba_dims(f)
    e = roofline.ESIZE[dtype]
    io = (di + C + H) * e + di * e
    return 2 * state_bytes(f, rows, dtype) + f["layer_types"].count("mamba") * rows * io
