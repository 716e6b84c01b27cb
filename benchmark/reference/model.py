"""Plain PyTorch reference of Pocket-TTS (FlowLM + Mimi decoder), written
from the published algorithms (pocket-tts.c, whose NumPy transcription is
the repository's test oracle) over the checkpoint's own tensor names.

It imports nothing of the program. Every matmul and convolution runs in
float32 with TF32 off; ``precision`` says how values are rounded around
them, which is how the lower-precision controls are computed:

  * "f32"  -- no rounding: the reference;
  * "tf32" -- a matmul's or convolution's operands rounded to TF32 (10-bit
    mantissa, nearest even), results kept in float32, as TF32 math does;
  * "bf16" -- every operand and every stored activation (each matmul,
    convolution, attention, norm and residual result) rounded to bfloat16,
    as a bf16 program stores them: the yardstick of check.py's
    pcm_gap_bf16;
  * "fp8"  -- the same as "bf16" in float8 e4m3, each tensor scaled by its
    own largest magnitude.

FlowLM runs teacher-forced: given a prompt, the frame noise and the latents
a program produced, it gives at every frame the latent and EOS logit that
the model computes from the program's own history, in one causal pass. The
Mimi decoder runs offline over a whole utterance (windowed attention in
query blocks), which equals the streaming decode mathematically.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0x0FFF
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class Reference:
    """The model over ``weights`` (checkpoint name -> tensor, any float
    dtype; read as float32 on ``device``), sized by the configuration's
    ``flowlm`` and ``mimi`` groups."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: dict, precision: str = "f32",
                 device=None):
        if precision not in ("f32", "tf32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.f, self.m = cfg["flowlm"], cfg["mimi"]
        self.precision = precision
        dev = device or next(iter(weights.values())).device
        self.w = {k: v.to(dev, torch.float32) for k, v in weights.items()}
        qw = self.w["quantizer.output_proj.weight"]
        self.w["quantizer.output_proj.weight_2d"] = qw.reshape(qw.shape[0], qw.shape[1])
        self.device = dev

    # -- primitives -----------------------------------------------------------

    def q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.precision == "tf32":
            return _round_tf32(x)
        if self.precision == "bf16":
            return _round_bf16(x)
        if self.precision == "fp8":
            return _round_fp8(x)
        return x

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """A stored activation: rounded in the bf16 and fp8 modes."""
        return self.q(x) if self.precision in ("bf16", "fp8") else x

    def linear(self, x, name: str, bias: Optional[str] = None):
        y = self.q(x) @ self.q(self.w[name]).T
        return self.r(y + self.w[bias] if bias else y)

    def norm(self, x, w, b, eps):
        return self.r(F.layer_norm(x, (x.shape[-1],), w, b, eps))

    @staticmethod
    def rope(x: torch.Tensor, pos: torch.Tensor, max_period: float) -> torch.Tensor:
        """Interleaved-pair rotation of x [T, H, D] at positions pos [T]."""
        T, H, D = x.shape
        i = torch.arange(D // 2, device=x.device, dtype=torch.float32)
        freqs = torch.exp(-math.log(max_period) * (2.0 * i / D))
        ang = pos.float()[:, None] * freqs
        c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x2 = x.reshape(T, H, D // 2, 2)
        r0 = x2[..., 0] * c - x2[..., 1] * s
        r1 = x2[..., 0] * s + x2[..., 1] * c
        return torch.stack([r0, r1], -1).reshape(T, H, D)

    def attention(self, q, k, v, context: int = 0, block: int = 512):
        """Causal softmax attention of q, k, v [T, H, D], keys within
        ``context`` of the query when > 0, in blocks of queries."""
        T, H, D = q.shape
        out = torch.empty_like(q)
        scale = 1.0 / math.sqrt(D)
        for q0 in range(0, T, block):
            q1 = min(T, q0 + block)
            k0 = max(0, q0 - context + 1) if context > 0 else 0
            qi = torch.arange(q0, q1, device=q.device)[:, None]
            ki = torch.arange(k0, q1, device=q.device)[None, :]
            ok = ki <= qi
            if context > 0:
                ok = ok & (qi - ki < context)
            s = torch.einsum("qhd,khd->hqk", self.q(q[q0:q1]), self.q(k[k0:q1])) * scale
            p = torch.softmax(s.masked_fill(~ok[None], float("-inf")), dim=-1)
            out[q0:q1] = torch.einsum("hqk,khd->qhd", self.q(p), self.q(v[k0:q1]))
        return self.r(out)

    def _block(self, x, pre: str, H: int, D: int, eps: float, max_period: float,
               context: int, mimi: bool):
        T, d = x.shape
        pos = torch.arange(T, device=x.device)
        h = self.norm(x, self.w[pre + "norm1.weight"], self.w[pre + "norm1.bias"], eps)
        qkv = self.linear(h, pre + "self_attn.in_proj.weight")
        q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(T, H, D) for i in range(3))
        a = self.attention(self.rope(q, pos, max_period), self.rope(k, pos, max_period), v,
                           context)
        add = self.linear(a.reshape(T, d), pre + "self_attn.out_proj.weight")
        if mimi:
            add = add * self.w[pre + "layer_scale_1.scale"]
        x = self.r(x + add)
        h = self.norm(x, self.w[pre + "norm2.weight"], self.w[pre + "norm2.bias"], eps)
        h = self.linear(h, pre + "linear1.weight")
        h = F.gelu(h, approximate="tanh") if mimi else F.gelu(h)
        add = self.linear(h, pre + "linear2.weight")
        if mimi:
            add = add * self.w[pre + "layer_scale_2.scale"]
        return self.r(x + add)

    # -- FlowLM ---------------------------------------------------------------

    def prompt(self, ids: Sequence[int], cond: Optional[torch.Tensor]) -> torch.Tensor:
        """[T0, d]: voice conditioning frames, token embeddings (ids outside
        the table read row 0), the projected BOS."""
        f = self.f
        idx = torch.tensor([i if 0 <= i <= f["vocab"] else 0 for i in ids], dtype=torch.long,
                           device=self.device)
        parts = [] if cond is None else [cond.to(self.device, torch.float32)]
        parts.append(self.w["conditioner.embed.weight"][idx])
        parts.append(self.linear(self.w["bos_emb"][None], "input_linear.weight"))
        return torch.cat(parts)

    def _time_embed(self, k: int, t: float) -> torch.Tensor:
        pre = f"flow_net.time_embed.{k}."
        ang = self.w[pre + "freqs"] * t
        e = torch.cat([torch.cos(ang), torch.sin(ang)])[None]
        h = F.silu(self.linear(e, pre + "mlp.0.weight", pre + "mlp.0.bias"))
        y = self.linear(h, pre + "mlp.2.weight", pre + "mlp.2.bias")
        d = y.shape[-1]
        var = ((y - y.mean(-1, keepdim=True)) ** 2).sum(-1, keepdim=True) / (d - 1)
        return y / torch.sqrt(var + self.f["rms_eps"]) * self.w[pre + "mlp.3.alpha"]

    def flow(self, cond: torch.Tensor, s: float, t: float, x_in: torch.Tensor) -> torch.Tensor:
        """The flow net's velocity for cond [N, d] and x_in [N, latent]."""
        fd, eps = self.f["flow_dim"], self.f["flow_ln_eps"]
        x = self.linear(x_in, "flow_net.input_proj.weight", "flow_net.input_proj.bias")
        c = (self._time_embed(0, s) + self._time_embed(1, t)) * 0.5 + self.linear(
            cond, "flow_net.cond_embed.weight", "flow_net.cond_embed.bias")
        sc = F.silu(c)
        for i in range(self.f["flow_depth"]):
            pre = f"flow_net.res_blocks.{i}."
            h = self.norm(x, self.w[pre + "in_ln.weight"], self.w[pre + "in_ln.bias"], eps)
            ada = self.linear(sc, pre + "adaLN_modulation.1.weight",
                              pre + "adaLN_modulation.1.bias")
            shift, scale, gate = ada[:, :fd], ada[:, fd:2 * fd], ada[:, 2 * fd:]
            h = h * (1.0 + scale) + shift
            h = self.linear(F.silu(self.linear(h, pre + "mlp.0.weight", pre + "mlp.0.bias")),
                            pre + "mlp.2.weight", pre + "mlp.2.bias")
            x = self.r(x + gate * h)
        h = self.norm(x, None, None, eps)
        ada = self.linear(sc, "flow_net.final_layer.adaLN_modulation.1.weight",
                          "flow_net.final_layer.adaLN_modulation.1.bias")
        h = h * (1.0 + ada[:, fd:]) + ada[:, :fd]
        return self.linear(h, "flow_net.final_layer.linear.weight",
                           "flow_net.final_layer.linear.bias")

    def unscale(self, scaled: torch.Tensor) -> torch.Tensor:
        return (scaled.float() - self.w["emb_mean"]) / self.w["emb_std"]

    def scale(self, latents: torch.Tensor) -> torch.Tensor:
        return latents * self.w["emb_std"] + self.w["emb_mean"]

    @torch.no_grad()
    def teacher_forced(self, prompt: torch.Tensor, noise: torch.Tensor,
                       history: torch.Tensor, num_steps: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latents [F, latent], EOS logits [F]) of frames 0..F-1, frame i
        computed from the prompt [T0, d] and the given raw latents
        history[:i] [F, latent], with noise [F, latent]."""
        with exact_f32():
            f = self.f
            Fr = noise.shape[0]
            T0 = prompt.shape[0]
            x = torch.cat([prompt.float(),
                           self.linear(history[:Fr - 1].float(), "input_linear.weight")])
            for i in range(f["num_layers"]):
                x = self._block(x, f"transformer.layers.{i}.", f["num_heads"], f["head_dim"],
                                f["ln_eps"], f["max_period"], 0, False)
            d = f["d_model"]
            normed = self.norm(x[T0 - 1:T0 - 1 + Fr], self.w["out_norm.weight"],
                               self.w["out_norm.bias"], f["ln_eps"])
            eos = (self.linear(normed, "out_eos.weight") + self.w["out_eos.bias"])[:, 0]
            lat = noise.to(self.device, torch.float32)
            for k in range(num_steps):
                lat = self.r(lat + self.flow(normed, k / num_steps, (k + 1) / num_steps, lat)
                             / num_steps)
            return lat, eos

    # -- Mimi -----------------------------------------------------------------

    def _conv(self, x, w: str, b: Optional[str]):
        k = self.w[w].shape[-1]
        y = F.conv1d(F.pad(self.q(x), (k - 1, 0)), self.q(self.w[w]))
        return self.r(y + self.w[b][None, :, None] if b else y)

    def _convtr(self, x, w: str, b: Optional[str], stride: int, groups: int = 1):
        T = x.shape[-1]
        y = F.conv_transpose1d(self.q(x), self.q(self.w[w]), stride=stride, groups=groups)
        y = y[..., :T * stride]
        return self.r(y + self.w[b][None, :, None] if b else y)

    @torch.no_grad()
    def decode(self, scaled: torch.Tensor) -> torch.Tensor:
        """Scaled latents [F, latent] -> PCM [F * frame_samples] (float32)."""
        with exact_f32():
            m = self.m
            d = m["d_model"]
            qz = self.linear(scaled.to(self.device, torch.float32),
                             "quantizer.output_proj.weight_2d")  # [F, d]
            x = self._convtr(qz.T[None], "upsample.convtr.convtr.weight", None,
                             m["upsample_stride"], groups=d)[0].T
            for i in range(m["num_layers"]):
                x = self._block(x, f"decoder_transformer.transformer.layers.{i}.",
                                m["num_heads"], m["head_dim"], m["ln_eps"], m["max_period"],
                                m["context"], True)
            x = self._conv(x.T[None], "decoder.model.0.conv.weight", "decoder.model.0.conv.bias")
            idx = 2
            for ratio in m["ratios"]:
                x = self._convtr(F.elu(x), f"decoder.model.{idx}.convtr.weight",
                                 f"decoder.model.{idx}.convtr.bias", ratio)
                r = f"decoder.model.{idx + 1}.block."
                h = self._conv(F.elu(x), r + "1.conv.weight", r + "1.conv.bias")
                h = self._conv(F.elu(h), r + "3.conv.weight", r + "3.conv.bias")
                x = self.r(x + h)
                idx += 3
            x = self._conv(F.elu(x), f"decoder.model.{idx}.conv.weight",
                           f"decoder.model.{idx}.conv.bias")
            return x[0, 0]


def quantize_i16(pcm: torch.Tensor) -> torch.Tensor:
    """Clamp to [-1, 1], times 32767, truncated toward zero."""
    return torch.trunc(torch.clamp(pcm.float(), -1.0, 1.0) * 32767.0).to(torch.int16)

