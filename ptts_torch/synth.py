"""A synthetic Pocket-TTS model directory, written with numpy only.

    python -m ptts_torch.synth OUT_DIR [--seed N] [--scale S]

Writes, at the widths of the given configs (full size by default):
  * tts_b6369a24.safetensors -- every tensor of the real checkpoint's schema
    under its reference name (the unused Mimi encoder as zeros, so
    ``Context.verify_weights`` passes), seeded random values;
  * tokenizer.model -- a SentencePiece ModelProto with unigram pieces for
    ASCII prose;
  * embeddings/alba.safetensors -- voice conditioning [1, N, d_model].

The values are not the JAX package's random_weights (that lives in a jax
module); tests that need one set of weights in both packages build it there.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

from .config import FlowLMConfig, MimiConfig
from .io.safetensors import save_safetensors

WEIGHTS_NAME = "tts_b6369a24.safetensors"


def flowlm_tensors(cfg: FlowLMConfig, r) -> dict:
    d, h, fd, lat, tf = cfg.d_model, cfg.hidden, cfg.flow_dim, cfg.latent_dim, cfg.time_freqs
    t = {
        "conditioner.embed.weight": r(cfg.vocab + 1, cfg.text_dim),
        "speaker_proj_weight": r(cfg.text_dim, 512),
        "emb_std": np.abs(r(lat)) + 1.0,
        "emb_mean": r(lat),
        "bos_emb": r(lat),
        "input_linear.weight": r(d, lat),
        "out_norm.weight": 1.0 + r(d),
        "out_norm.bias": r(d),
        "out_eos.weight": r(1, d),
        "out_eos.bias": r(1),
        "flow_net.cond_embed.weight": r(fd, d),
        "flow_net.cond_embed.bias": r(fd),
        "flow_net.input_proj.weight": r(fd, lat),
        "flow_net.input_proj.bias": r(fd),
        "flow_net.final_layer.linear.weight": r(lat, fd),
        "flow_net.final_layer.linear.bias": r(lat),
        "flow_net.final_layer.adaLN_modulation.1.weight": r(2 * fd, fd),
        "flow_net.final_layer.adaLN_modulation.1.bias": r(2 * fd),
    }
    for i in range(cfg.num_layers):
        base = f"transformer.layers.{i}"
        t[f"{base}.self_attn.in_proj.weight"] = r(3 * d, d)
        t[f"{base}.self_attn.out_proj.weight"] = r(d, d)
        t[f"{base}.norm1.weight"] = 1.0 + r(d)
        t[f"{base}.norm1.bias"] = r(d)
        t[f"{base}.norm2.weight"] = 1.0 + r(d)
        t[f"{base}.norm2.bias"] = r(d)
        t[f"{base}.linear1.weight"] = r(h, d)
        t[f"{base}.linear2.weight"] = r(d, h)
    freqs = np.exp(-np.log(np.float32(cfg.max_period))
                   * (np.arange(tf, dtype=np.float32) / np.float32(tf)))
    for k in range(2):
        base = f"flow_net.time_embed.{k}"
        t[f"{base}.mlp.0.weight"] = r(fd, 2 * tf)
        t[f"{base}.mlp.0.bias"] = r(fd)
        t[f"{base}.mlp.2.weight"] = r(fd, fd)
        t[f"{base}.mlp.2.bias"] = r(fd)
        t[f"{base}.mlp.3.alpha"] = 1.0 + r(fd)
        t[f"{base}.freqs"] = freqs * np.float32(0.5 ** k)
    for i in range(cfg.flow_depth):
        base = f"flow_net.res_blocks.{i}"
        t[f"{base}.in_ln.weight"] = 1.0 + r(fd)
        t[f"{base}.in_ln.bias"] = r(fd)
        t[f"{base}.mlp.0.weight"] = r(fd, fd)
        t[f"{base}.mlp.0.bias"] = r(fd)
        t[f"{base}.mlp.2.weight"] = r(fd, fd)
        t[f"{base}.mlp.2.bias"] = r(fd)
        t[f"{base}.adaLN_modulation.1.weight"] = r(3 * fd, fd)
        t[f"{base}.adaLN_modulation.1.bias"] = r(3 * fd)
    return t


def _transformer_tensors(prefix: str, cfg: MimiConfig, r) -> dict:
    d, h = cfg.d_model, cfg.hidden
    t = {}
    for i in range(cfg.num_layers):
        base = f"{prefix}.transformer.layers.{i}"
        t[f"{base}.self_attn.in_proj.weight"] = r(3 * d, d)
        t[f"{base}.self_attn.out_proj.weight"] = r(d, d)
        t[f"{base}.norm1.weight"] = 1.0 + r(d)
        t[f"{base}.norm1.bias"] = r(d)
        t[f"{base}.norm2.weight"] = 1.0 + r(d)
        t[f"{base}.norm2.bias"] = r(d)
        t[f"{base}.linear1.weight"] = r(h, d)
        t[f"{base}.linear2.weight"] = r(d, h)
        t[f"{base}.layer_scale_1.scale"] = 0.5 + r(d)
        t[f"{base}.layer_scale_2.scale"] = 0.5 + r(d)
    return t


def mimi_tensors(cfg: MimiConfig, r) -> dict:
    d, nf = cfg.d_model, cfg.n_filters
    mult = 2 ** len(cfg.ratios)
    t = {
        "quantizer.output_proj.weight": r(d, cfg.latent_dim, 1),
        "upsample.convtr.convtr.weight": r(d, 1, cfg.upsample_kernel),
        "decoder.model.0.conv.weight": r(mult * nf, d, cfg.kernel_size),
        "decoder.model.0.conv.bias": r(mult * nf),
    }
    idx = 2
    for ratio in cfg.ratios:
        in_ch, out_ch = mult * nf, mult * nf // 2
        hidden = out_ch // cfg.compress
        t[f"decoder.model.{idx}.convtr.weight"] = r(in_ch, out_ch, 2 * ratio)
        t[f"decoder.model.{idx}.convtr.bias"] = r(out_ch)
        t[f"decoder.model.{idx + 1}.block.1.conv.weight"] = r(hidden, out_ch, cfg.residual_kernel)
        t[f"decoder.model.{idx + 1}.block.1.conv.bias"] = r(hidden)
        t[f"decoder.model.{idx + 1}.block.3.conv.weight"] = r(out_ch, hidden, 1)
        t[f"decoder.model.{idx + 1}.block.3.conv.bias"] = r(out_ch)
        idx += 3
        mult //= 2
    t[f"decoder.model.{idx}.conv.weight"] = r(1, nf, cfg.last_kernel_size)
    t[f"decoder.model.{idx}.conv.bias"] = r(1)
    t.update(_transformer_tensors("decoder_transformer", cfg, r))
    t.update(_encoder_tensors(cfg))
    return t


def _encoder_tensors(cfg: MimiConfig) -> dict:
    """The Mimi encoder (present in real checkpoints, unused by decode), as zeros."""
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    dim, nf = cfg.d_model, cfg.n_filters
    t = {"downsample.conv.conv.weight": z(dim, dim, cfg.upsample_kernel),
         "encoder.model.0.conv.weight": z(nf, 1, cfg.kernel_size),
         "encoder.model.0.conv.bias": z(nf)}
    idx, mult = 1, 1
    for ratio in reversed(cfg.ratios):
        hidden = mult * nf // cfg.compress
        t[f"encoder.model.{idx}.block.1.conv.weight"] = z(hidden, mult * nf, cfg.residual_kernel)
        t[f"encoder.model.{idx}.block.1.conv.bias"] = z(hidden)
        t[f"encoder.model.{idx}.block.3.conv.weight"] = z(mult * nf, hidden, 1)
        t[f"encoder.model.{idx}.block.3.conv.bias"] = z(mult * nf)
        idx += 2
        t[f"encoder.model.{idx}.conv.weight"] = z(mult * nf * 2, mult * nf, ratio * 2)
        t[f"encoder.model.{idx}.conv.bias"] = z(mult * nf * 2)
        idx += 1
        mult *= 2
    idx += 1
    t[f"encoder.model.{idx}.conv.weight"] = z(dim, mult * nf, cfg.last_kernel_size)
    t[f"encoder.model.{idx}.conv.bias"] = z(dim)
    t.update(_transformer_tensors("encoder_transformer", cfg, z))
    return t


# -- SentencePiece ModelProto writer -----------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _key(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _key(num, 2) + _varint(len(payload)) + payload


def tokenizer_model() -> bytes:
    """Unigram pieces for ASCII prose; flags: dummy prefix, collapse
    whitespace, escape whitespace as U+2581."""
    ws = "▁"
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), (ws + "hello", -1.0, 1),
              (ws + "world", -1.5, 1), (ws, -6.0, 1)]
    pieces += [(chr(c), -25.0, 1) for c in range(ord("a"), ord("z") + 1)]
    pieces += [(chr(c), -25.0, 1) for c in range(ord("A"), ord("Z") + 1)]
    pieces += [(c, -3.0, 1) for c in ".!,?'"]
    buf = bytearray()
    for text, score, ptype in pieces:
        piece = (_len_field(1, text.encode("utf-8")) + _key(2, 5) + struct.pack("<f", score)
                 + _key(3, 0) + _varint(ptype))
        buf += _len_field(1, piece)
    buf += _len_field(2, _key(24, 0) + _varint(0))  # trainer: whitespace as prefix
    norm = _key(3, 0) + _varint(1) + _key(4, 0) + _varint(1) + _key(5, 0) + _varint(1)
    buf += _len_field(3, norm)
    return bytes(buf)


def write_model_dir(path: str, flowlm_cfg: FlowLMConfig = FlowLMConfig(),
                    mimi_cfg: MimiConfig = MimiConfig(), seed: int = 0,
                    scale: float = 0.05, voice_frames: int = 5) -> str:
    """Write the synthetic model dir at ``path``; returns ``path``."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    os.makedirs(os.path.join(path, "embeddings"), exist_ok=True)
    tensors = flowlm_tensors(flowlm_cfg, r)
    tensors.update(mimi_tensors(mimi_cfg, r))
    save_safetensors(os.path.join(path, WEIGHTS_NAME), tensors)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(tokenizer_model())
    cond = rng.standard_normal((1, voice_frames, flowlm_cfg.d_model), dtype=np.float32)
    save_safetensors(os.path.join(path, "embeddings", "alba.safetensors"),
                     {"audio_prompt": cond * np.float32(0.3)})
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=0.05, help="stddev of the random weights")
    args = ap.parse_args(argv)
    path = write_model_dir(args.out_dir, seed=args.seed, scale=args.scale)
    size = os.path.getsize(os.path.join(path, WEIGHTS_NAME))
    print(f"wrote synthetic full-size model dir: {path} ({size / 1e6:.1f} MB)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
