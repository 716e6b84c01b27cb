"""Plain PyTorch reference of Pocket-TTS with Granite 4.0-H's hybrid stack as
FlowLM's backbone (configs/pocket-tts-granite4h-bf16.json), written from the
published layer equations over Granite's tensor names, under FlowLM's
``transformer.layers.{i}.`` prefix.

Only the backbone and the prompt's embedding scale differ from
reference/model.Reference, whose primitives, precisions (``q``, ``r``), flow
net, EOS head and Mimi decoder this class keeps. Each layer, with r the
residual multiplier and RMSNorms that carry a weight:

    h  = x + r * Mixer(RMSNorm1(x))
    x' = h + r * W_out(silu(a) * b),   [a, b] = split(W_in RMSNorm2(h))

  * attention: grouped-query, no position encoding; q [Hq, D], k and v
    [Hkv, D], KV head j serving query heads j*G .. j*G + G-1, causal
    softmax of q.k times the attention multiplier;
  * Mamba-2, run as its recurrence, one position after another (the
    program's prompt pass takes the chunked form; this is what it is held
    to): [z, xBC, dt] = W_in u; xBC = silu(causal depthwise conv + bias);
    [x, B, C] = split(xBC); dt = softplus(dt + dt_bias); A = -exp(A_log);
    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T per head; y_t = S_t C_t +
    D x_t; out = W_out(RMSNorm(y * silu(z)) * w) over all channels. The
    state is float32 in every precision; the products that touch it take
    rounded operands, as a matmul does.

Departures from the published model: no LM head and no final norm (Pocket's
out_norm, EOS head and flow net read the stack's output, at Pocket's
widths); the text-embedding rows are scaled by the embedding multiplier, as
Granite scales its token embeddings, while the voice frames and the
projected BOS are not; ``num_hidden_layers`` cuts ``layer_types`` to its
first layers. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Sequence, Optional, Tuple

import torch
import torch.nn.functional as F

from .model import Reference, exact_f32


class HybridReference(Reference):
    """Reference over the hybrid configuration's weights; ``cfg`` is the
    configuration file as benchmark/hybrid.expand gives it (Granite's keys
    at the top, Pocket's heads and Mimi in "flowlm" and "mimi")."""

    def __init__(self, weights, cfg: dict, precision: str = "f32", device=None):
        super().__init__(weights, cfg, precision, device)
        self.g = cfg
        self.layers = list(cfg["layer_types"][:cfg["num_hidden_layers"]])

    def rmsnorm(self, x, w):
        return self.r(x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.g["rms_norm_eps"])
                      * w)

    def prompt(self, ids: Sequence[int], cond: Optional[torch.Tensor]) -> torch.Tensor:
        f = self.f
        idx = torch.tensor([i if 0 <= i <= f["vocab"] else 0 for i in ids], dtype=torch.long,
                           device=self.device)
        parts = [] if cond is None else [cond.to(self.device, torch.float32)]
        parts.append(self.w["conditioner.embed.weight"][idx] * self.g["embedding_multiplier"])
        parts.append(self.linear(self.w["bos_emb"][None], "input_linear.weight"))
        return torch.cat(parts)

    # -- mixers ---------------------------------------------------------------

    def gqa(self, u, pre: str):
        g = self.g
        T = u.shape[0]
        Hq, Hk = g["num_attention_heads"], g["num_key_value_heads"]
        D = g["hidden_size"] // Hq
        q = self.linear(u, pre + "q_proj.weight").reshape(T, Hq, D)
        k = self.linear(u, pre + "k_proj.weight").reshape(T, Hk, D)
        v = self.linear(u, pre + "v_proj.weight").reshape(T, Hk, D)
        k, v = (t.repeat_interleave(Hq // Hk, dim=1) for t in (k, v))
        s = torch.einsum("qhd,khd->hqk", self.q(q), self.q(k)) * g["attention_multiplier"]
        ok = torch.ones(T, T, dtype=torch.bool, device=u.device).tril()
        p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
        a = self.r(torch.einsum("hqk,khd->qhd", self.q(p), self.q(v)))
        return self.linear(a.reshape(T, Hq * D), pre + "o_proj.weight")

    def mamba(self, u, pre: str):
        g = self.g
        T = u.shape[0]
        H, P, N, K = g["mamba_n_heads"], g["mamba_d_head"], g["mamba_d_state"], g["mamba_d_conv"]
        di = H * P
        zxbcdt = self.linear(u, pre + "in_proj.weight")
        z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * N], zxbcdt[:, 2 * di + 2 * N:]
        w = self.w[pre + "conv1d.weight"]                          # [C, 1, K]
        xc = F.conv1d(F.pad(self.q(xbc.T[None]), (K - 1, 0)), self.q(w), groups=w.shape[0])
        xc = self.r(F.silu(self.r(xc[0].T + self.w[pre + "conv1d.bias"])))
        x, B, C = xc[:, :di].reshape(T, H, P), xc[:, di:di + N], xc[:, di + N:]
        dt = F.softplus(dt + self.w[pre + "dt_bias"])              # [T, H]
        A = -torch.exp(self.w[pre + "A_log"])
        S = torch.zeros(H, P, N, device=u.device)
        ys = []
        for t in range(T):
            upd = self.q(dt[t][:, None] * x[t])[..., None] * self.q(B[t])
            S = torch.exp(dt[t] * A)[:, None, None] * S + upd
            ys.append(self.q(S) @ self.q(C[t]))
        y = torch.stack(ys) + self.w[pre + "D"][:, None] * x
        y = self.rmsnorm(y.reshape(T, di) * F.silu(z), self.w[pre + "norm.weight"])
        return self.linear(y, pre + "out_proj.weight")

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        rm = self.g["residual_multiplier"]
        for i, kind in enumerate(self.layers):
            pre = f"transformer.layers.{i}."
            h = self.rmsnorm(x, self.w[pre + "input_layernorm.weight"])
            y = self.mamba(h, pre + "mamba.") if kind == "mamba" else self.gqa(h, pre + "self_attn.")
            x = self.r(x + rm * y)
            h = self.rmsnorm(x, self.w[pre + "post_attention_layernorm.weight"])
            a, b = self.linear(h, pre + "shared_mlp.input_linear.weight").chunk(2, dim=-1)
            y = self.linear(self.r(F.silu(a) * b), pre + "shared_mlp.output_linear.weight")
            x = self.r(x + rm * y)
        return x

    @torch.no_grad()
    def teacher_forced(self, prompt: torch.Tensor, noise: torch.Tensor,
                       history: torch.Tensor, num_steps: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """reference/model.Reference.teacher_forced over the hybrid stack."""
        with exact_f32():
            f = self.f
            Fr = noise.shape[0]
            T0 = prompt.shape[0]
            x = torch.cat([prompt.float(),
                           self.linear(history[:Fr - 1].float(), "input_linear.weight")])
            x = self.backbone(x)
            normed = self.norm(x[T0 - 1:T0 - 1 + Fr], self.w["out_norm.weight"],
                               self.w["out_norm.bias"], f["ln_eps"])
            eos = (self.linear(normed, "out_eos.weight") + self.w["out_eos.bias"])[:, 0]
            lat = noise.to(self.device, torch.float32)
            for k in range(num_steps):
                lat = self.r(lat + self.flow(normed, k / num_steps, (k + 1) / num_steps, lat)
                             / num_steps)
            return lat, eos
