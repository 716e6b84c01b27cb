"""The benchmark's own inputs: seeded Pocket-TTS weights made on the device,
voice conditionings, and the small files a text-driven engine reads.

The weights follow the published checkpoint's schema (tensor names and
shapes of Kyutai's Pocket-TTS as transcribed in pocket-tts.c) at the
configuration's widths. Every random tensor is base + scale * N(0, 1), drawn
in ONE call of a torch.Generator on the run's device, then cut into
tensors and cast to the served dtype. The program reads them through
``MemCheckpoint`` (its loader's interface, from host copies), the reference
reads the device tensors themselves, so both see the same values.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

# (name, shape, init): init "n" = scale * N(0,1); "1+" = 1 + that;
# ".5+" = 0.5 + that; "|1+|" = 1 + |that|; ("freqs", k) a fixed table
Spec = Tuple[str, Tuple[int, ...], object]


def flowlm_spec(f: dict) -> List[Spec]:
    d, h, fd, lat, tf = f["d_model"], f["hidden"], f["flow_dim"], f["latent_dim"], f["time_freqs"]
    s: List[Spec] = [
        ("conditioner.embed.weight", (f["vocab"] + 1, f["text_dim"]), "n"),
        ("emb_std", (lat,), "|1+|"),
        ("emb_mean", (lat,), "n"),
        ("bos_emb", (lat,), "n"),
        ("input_linear.weight", (d, lat), "n"),
        ("out_norm.weight", (d,), "1+"),
        ("out_norm.bias", (d,), "n"),
        ("out_eos.weight", (1, d), "n"),
        ("out_eos.bias", (1,), "n"),
        ("flow_net.cond_embed.weight", (fd, d), "n"),
        ("flow_net.cond_embed.bias", (fd,), "n"),
        ("flow_net.input_proj.weight", (fd, lat), "n"),
        ("flow_net.input_proj.bias", (fd,), "n"),
        ("flow_net.final_layer.linear.weight", (lat, fd), "n"),
        ("flow_net.final_layer.linear.bias", (lat,), "n"),
        ("flow_net.final_layer.adaLN_modulation.1.weight", (2 * fd, fd), "n"),
        ("flow_net.final_layer.adaLN_modulation.1.bias", (2 * fd,), "n"),
    ]
    for i in range(f["num_layers"]):
        b = f"transformer.layers.{i}"
        s += [(f"{b}.self_attn.in_proj.weight", (3 * d, d), "n"),
              (f"{b}.self_attn.out_proj.weight", (d, d), "n"),
              (f"{b}.norm1.weight", (d,), "1+"), (f"{b}.norm1.bias", (d,), "n"),
              (f"{b}.norm2.weight", (d,), "1+"), (f"{b}.norm2.bias", (d,), "n"),
              (f"{b}.linear1.weight", (h, d), "n"), (f"{b}.linear2.weight", (d, h), "n")]
    for k in range(2):
        b = f"flow_net.time_embed.{k}"
        s += [(f"{b}.mlp.0.weight", (fd, 2 * tf), "n"), (f"{b}.mlp.0.bias", (fd,), "n"),
              (f"{b}.mlp.2.weight", (fd, fd), "n"), (f"{b}.mlp.2.bias", (fd,), "n"),
              (f"{b}.mlp.3.alpha", (fd,), "1+"), (f"{b}.freqs", (tf,), ("freqs", k))]
    for i in range(f["flow_depth"]):
        b = f"flow_net.res_blocks.{i}"
        s += [(f"{b}.in_ln.weight", (fd,), "1+"), (f"{b}.in_ln.bias", (fd,), "n"),
              (f"{b}.mlp.0.weight", (fd, fd), "n"), (f"{b}.mlp.0.bias", (fd,), "n"),
              (f"{b}.mlp.2.weight", (fd, fd), "n"), (f"{b}.mlp.2.bias", (fd,), "n"),
              (f"{b}.adaLN_modulation.1.weight", (3 * fd, fd), "n"),
              (f"{b}.adaLN_modulation.1.bias", (3 * fd,), "n")]
    return s


def mimi_spec(m: dict) -> List[Spec]:
    d, nf = m["d_model"], m["n_filters"]
    mult = 2 ** len(m["ratios"])
    s: List[Spec] = [
        ("quantizer.output_proj.weight", (d, m["latent_dim"], 1), "n"),
        ("upsample.convtr.convtr.weight", (d, 1, m["upsample_kernel"]), "n"),
        ("decoder.model.0.conv.weight", (mult * nf, d, m["kernel_size"]), "n"),
        ("decoder.model.0.conv.bias", (mult * nf,), "n"),
    ]
    idx = 2
    for ratio in m["ratios"]:
        cin, cout = mult * nf, mult * nf // 2
        hid = cout // m["compress"]
        s += [(f"decoder.model.{idx}.convtr.weight", (cin, cout, 2 * ratio), "n"),
              (f"decoder.model.{idx}.convtr.bias", (cout,), "n"),
              (f"decoder.model.{idx + 1}.block.1.conv.weight",
               (hid, cout, m["residual_kernel"]), "n"),
              (f"decoder.model.{idx + 1}.block.1.conv.bias", (hid,), "n"),
              (f"decoder.model.{idx + 1}.block.3.conv.weight", (cout, hid, 1), "n"),
              (f"decoder.model.{idx + 1}.block.3.conv.bias", (cout,), "n")]
        idx += 3
        mult //= 2
    s += [(f"decoder.model.{idx}.conv.weight", (1, nf, m["last_kernel_size"]), "n"),
          (f"decoder.model.{idx}.conv.bias", (1,), "n")]
    dm, hm = d, m["hidden"]
    for i in range(m["num_layers"]):
        b = f"decoder_transformer.transformer.layers.{i}"
        s += [(f"{b}.self_attn.in_proj.weight", (3 * dm, dm), "n"),
              (f"{b}.self_attn.out_proj.weight", (dm, dm), "n"),
              (f"{b}.norm1.weight", (dm,), "1+"), (f"{b}.norm1.bias", (dm,), "n"),
              (f"{b}.norm2.weight", (dm,), "1+"), (f"{b}.norm2.bias", (dm,), "n"),
              (f"{b}.linear1.weight", (hm, dm), "n"), (f"{b}.linear2.weight", (dm, hm), "n"),
              (f"{b}.layer_scale_1.scale", (dm,), ".5+"),
              (f"{b}.layer_scale_2.scale", (dm,), ".5+")]
    return s


def n_params(spec: List[Spec]) -> int:
    return sum(int(np.prod(shape)) for _, shape, _ in spec)


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the checkpoint, on ``device`` in the configuration's
    dtype: one randn call of a generator seeded with ``seed``, sliced."""
    spec = flowlm_spec(cfg["flowlm"]) + mimi_spec(cfg["mimi"])
    scale = float(cfg["assumed"]["weight_scale"])
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFFFFFFFFFF)
    flat = torch.randn(n_params(spec), generator=gen, device=device) * scale
    out, off = {}, 0
    tf = cfg["flowlm"]["time_freqs"]
    base = torch.exp(-np.log(np.float32(cfg["flowlm"]["max_period"]))
                     * (torch.arange(tf, dtype=torch.float32, device=device) / tf))
    for name, shape, init in spec:
        n = int(np.prod(shape))
        t = flat[off:off + n].view(shape)
        off += n
        if isinstance(init, tuple):
            t = base * np.float32(0.5 ** init[1])
        elif init == "1+":
            t = 1.0 + t
        elif init == ".5+":
            t = 0.5 + t
        elif init == "|1+|":
            t = 1.0 + t.abs()
        out[name] = t.to(dtype).contiguous()
    return out


def make_voices(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """[n, voice_frames, d_model] voice conditionings in the served dtype."""
    a = cfg["assumed"]
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed((seed ^ 0x5EED) & 0xFFFFFFFFFFFF)
    v = torch.randn(n, int(a["voice_frames"]), cfg["flowlm"]["d_model"], generator=gen,
                    device=device) * float(a["voice_scale"])
    return v.to(dtype)


class _Entry:
    def __init__(self, name: str, shape):
        self.name, self.shape = name, tuple(shape)


class MemCheckpoint:
    """The checkpoint in host memory behind the reader interface the
    program's weight loader uses (find / tensors / get_f32 / get_bf16), so
    the engine loads it as it loads a file, without a file."""

    def __init__(self, weights: Dict[str, torch.Tensor]):
        self._host = {k: v.cpu() for k, v in weights.items()}
        self.tensors = [_Entry(k, v.shape) for k, v in self._host.items()]
        self._by_name = {e.name: e for e in self.tensors}

    def find(self, name: str):
        return self._by_name.get(name)

    def get_f32(self, t) -> np.ndarray:
        return self._host[t.name].float().numpy()

    def get_bf16(self, t) -> torch.Tensor:
        return self._host[t.name].to(torch.bfloat16)

    def close(self) -> None:
        self._host = {}


# -- the text path's files: tokenizer and one voice -------------------------

WS = "▁"


def tokenizer_pieces() -> List[Tuple[str, float]]:
    """The unigram vocabulary the offline cell's texts are tokenized with:
    ASCII letters and a few marks, id = position."""
    pieces = [("<unk>", 0.0), ("<s>", 0.0), (WS + "hello", -1.0), (WS + "world", -1.5),
              (WS, -6.0)]
    pieces += [(chr(c), -25.0) for c in range(ord("a"), ord("z") + 1)]
    pieces += [(chr(c), -25.0) for c in range(ord("A"), ord("Z") + 1)]
    pieces += [(c, -3.0) for c in ".!,?'"]
    return pieces


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _field(num: int, wire: int, payload: bytes = b"") -> bytes:
    key = _varint((num << 3) | wire)
    return key + (_varint(len(payload)) + payload if wire == 2 else payload)


def tokenizer_model_bytes() -> bytes:
    """A SentencePiece ModelProto of tokenizer_pieces(): unigram, dummy
    prefix, whitespace collapsed and escaped as U+2581."""
    buf = bytearray()
    for i, (text, score) in enumerate(tokenizer_pieces()):
        ptype = 2 if i == 0 else 3 if i == 1 else 1
        piece = (_field(1, 2, text.encode("utf-8")) + _field(2, 5, struct.pack("<f", score))
                 + _field(3, 0, _varint(ptype)))
        buf += _field(1, 2, piece)
    buf += _field(2, 2, _field(24, 0, _varint(0)))
    buf += _field(3, 2, _field(3, 0, _varint(1)) + _field(4, 0, _varint(1))
                  + _field(5, 0, _varint(1)))
    return bytes(buf)


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """A minimal safetensors writer (F32 only)."""
    header, blobs, off = {}, [], 0
    for name, a in tensors.items():
        raw = np.ascontiguousarray(a, np.float32).tobytes()
        header[name] = {"dtype": "F32", "shape": list(a.shape), "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for b in blobs:
            f.write(b)


def write_text_dir(path: str, voice: np.ndarray) -> str:
    """tokenizer.model and embeddings/alba.safetensors (``voice`` [N, d])
    under ``path``: what the engine's text path reads besides the weights."""
    os.makedirs(os.path.join(path, "embeddings"), exist_ok=True)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(tokenizer_model_bytes())
    write_safetensors(os.path.join(path, "embeddings", "alba.safetensors"),
                      {"audio_prompt": voice[None].astype(np.float32)})
    return path
