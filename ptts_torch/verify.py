"""Checkpoint structural verification.

Mirror of ptts_verify_weights (reference/ptts.c:586-991): checks every
expected tensor (FlowLM, flow net, Mimi decoder AND the unused Mimi encoder)
against a shape schema, with the same exact -> prefix -> unique-suffix name
resolution and ambiguity detection. Catches wrong/mismatched checkpoints
before any compute.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from .config import FlowLMConfig, MimiConfig


@dataclass
class VerifyReport:
    missing: List[str] = field(default_factory=list)
    mismatch: List[str] = field(default_factory=list)
    ambiguous: List[str] = field(default_factory=list)

    @property
    def errors(self) -> int:
        return len(self.missing) + len(self.mismatch) + len(self.ambiguous)

    def format(self) -> str:
        lines = []
        for name in self.missing:
            lines.append(f"Missing tensor: {name}")
        for msg in self.mismatch:
            lines.append(f"Shape mismatch: {msg}")
        for name in self.ambiguous:
            lines.append(f"Ambiguous tensor match for {name}")
        return "\n".join(lines)


def _find_with(st, name: str, prefixes: Tuple[str, ...]):
    t = st.find(name)
    if t is not None:
        return t, False
    for p in prefixes:
        t = st.find(p + name)
        if t is not None:
            return t, False
    match = None
    for cand in st.tensors:
        if cand.name.endswith(name):
            if match is not None:
                return None, True  # ambiguous
            match = cand
    return match, False


def _check(st, report: VerifyReport, name: str, shape: Tuple[int, ...],
           prefixes: Tuple[str, ...]) -> None:
    t, ambiguous = _find_with(st, name, prefixes)
    if ambiguous:
        report.ambiguous.append(name)
        return
    if t is None:
        report.missing.append(name)
        return
    if tuple(t.shape) != tuple(shape):
        report.mismatch.append(f"{name} ({t.name}): expected {list(shape)}, got {list(t.shape)}")


def verify_flowlm(st, cfg: FlowLMConfig = FlowLMConfig()) -> VerifyReport:
    r = VerifyReport()
    pre = ("flow_lm.",)
    d, fd, lat = cfg.d_model, cfg.flow_dim, cfg.latent_dim

    _check(st, r, "conditioner.embed.weight", (cfg.vocab + 1, cfg.text_dim), pre)
    _check(st, r, "speaker_proj_weight", (cfg.text_dim, 512), pre)

    _check(st, r, "flow_net.cond_embed.weight", (fd, d), pre)
    _check(st, r, "flow_net.cond_embed.bias", (fd,), pre)
    _check(st, r, "flow_net.input_proj.weight", (fd, lat), pre)
    _check(st, r, "flow_net.input_proj.bias", (fd,), pre)

    for t in range(2):
        _check(st, r, f"flow_net.time_embed.{t}.mlp.0.weight", (fd, 2 * cfg.time_freqs), pre)
        _check(st, r, f"flow_net.time_embed.{t}.mlp.0.bias", (fd,), pre)
        _check(st, r, f"flow_net.time_embed.{t}.mlp.2.weight", (fd, fd), pre)
        _check(st, r, f"flow_net.time_embed.{t}.mlp.2.bias", (fd,), pre)
        _check(st, r, f"flow_net.time_embed.{t}.mlp.3.alpha", (fd,), pre)

    for i in range(cfg.flow_depth):
        base = f"flow_net.res_blocks.{i}"
        _check(st, r, f"{base}.in_ln.weight", (fd,), pre)
        _check(st, r, f"{base}.in_ln.bias", (fd,), pre)
        _check(st, r, f"{base}.mlp.0.weight", (fd, fd), pre)
        _check(st, r, f"{base}.mlp.0.bias", (fd,), pre)
        _check(st, r, f"{base}.mlp.2.weight", (fd, fd), pre)
        _check(st, r, f"{base}.mlp.2.bias", (fd,), pre)
        _check(st, r, f"{base}.adaLN_modulation.1.weight", (3 * fd, fd), pre)
        _check(st, r, f"{base}.adaLN_modulation.1.bias", (3 * fd,), pre)

    _check(st, r, "flow_net.final_layer.linear.weight", (lat, fd), pre)
    _check(st, r, "flow_net.final_layer.linear.bias", (lat,), pre)
    _check(st, r, "flow_net.final_layer.adaLN_modulation.1.weight", (2 * fd, fd), pre)
    _check(st, r, "flow_net.final_layer.adaLN_modulation.1.bias", (2 * fd,), pre)

    _check(st, r, "emb_std", (lat,), pre)
    _check(st, r, "emb_mean", (lat,), pre)
    _check(st, r, "bos_emb", (lat,), pre)
    _check(st, r, "input_linear.weight", (d, lat), pre)
    _check(st, r, "out_norm.weight", (d,), pre)
    _check(st, r, "out_norm.bias", (d,), pre)
    _check(st, r, "out_eos.weight", (1, d), pre)
    _check(st, r, "out_eos.bias", (1,), pre)

    for i in range(cfg.num_layers):
        base = f"transformer.layers.{i}"
        _check(st, r, f"{base}.self_attn.in_proj.weight", (3 * d, d), pre)
        _check(st, r, f"{base}.self_attn.out_proj.weight", (d, d), pre)
        _check(st, r, f"{base}.norm1.weight", (d,), pre)
        _check(st, r, f"{base}.norm1.bias", (d,), pre)
        _check(st, r, f"{base}.norm2.weight", (d,), pre)
        _check(st, r, f"{base}.norm2.bias", (d,), pre)
        _check(st, r, f"{base}.linear1.weight", (cfg.hidden, d), pre)
        _check(st, r, f"{base}.linear2.weight", (d, cfg.hidden), pre)
    return r


def verify_mimi(st, cfg: MimiConfig = MimiConfig()) -> VerifyReport:
    """Schema per verify_mimi (ptts.c:896-983), incl. the unused encoder."""
    r = VerifyReport()
    pre = ("mimi.", "model.")
    dim = cfg.d_model
    nf = cfg.n_filters
    ratios = cfg.ratios
    ks, lks, rk, comp = cfg.kernel_size, cfg.last_kernel_size, cfg.residual_kernel, cfg.compress

    def conv(base: str, out_ch: int, in_ch: int, k: int, bias: bool) -> None:
        _check(st, r, f"{base}.conv.weight", (out_ch, in_ch, k), pre)
        if bias:
            _check(st, r, f"{base}.conv.bias", (out_ch,), pre)

    def convtr(base: str, in_ch: int, out_ch: int, k: int, bias: bool) -> None:
        _check(st, r, f"{base}.convtr.weight", (in_ch, out_ch, k), pre)
        if bias:
            _check(st, r, f"{base}.convtr.bias", (out_ch,), pre)

    def resblock(base: str, d: int) -> None:
        hidden = d // comp
        conv(f"{base}.block.1", hidden, d, rk, True)
        conv(f"{base}.block.3", d, hidden, 1, True)

    # down/upsample between 200 Hz and 12.5 Hz. The real checkpoint doubles
    # the module name ("upsample.convtr.convtr.weight"); the reference's
    # schema does too (ptts.c:914-917 via expect_conv1d/expect_convtr1d).
    conv("downsample.conv", dim, dim, cfg.upsample_kernel, False)
    convtr("upsample.convtr", dim, 1, cfg.upsample_kernel, False)
    # (expect helpers append .conv/.convtr below)

    # encoder (present in checkpoints, unused by decode)
    conv("encoder.model.0", nf, 1, ks, True)
    idx = 1
    mult = 1
    for ratio in reversed(ratios):
        resblock(f"encoder.model.{idx}", mult * nf)
        idx += 2  # resblock + ELU
        conv(f"encoder.model.{idx}", mult * nf * 2, mult * nf, ratio * 2, True)
        idx += 1
        mult *= 2
    idx += 1  # ELU
    conv(f"encoder.model.{idx}", dim, mult * nf, lks, True)

    # decoder
    mult = 2 ** len(ratios)
    conv("decoder.model.0", mult * nf, dim, ks, True)
    idx = 1
    for ratio in ratios:
        idx += 1  # ELU
        convtr(f"decoder.model.{idx}", mult * nf, mult * nf // 2, ratio * 2, True)
        idx += 1
        resblock(f"decoder.model.{idx}", mult * nf // 2)
        idx += 1
        mult //= 2
    idx += 1  # ELU
    conv(f"decoder.model.{idx}", 1, nf, lks, True)

    # transformers (encoder + decoder)
    for prefix in ("encoder_transformer", "decoder_transformer"):
        for i in range(cfg.num_layers):
            base = f"{prefix}.transformer.layers.{i}"
            _check(st, r, f"{base}.self_attn.in_proj.weight", (3 * dim, dim), pre)
            _check(st, r, f"{base}.self_attn.out_proj.weight", (dim, dim), pre)
            _check(st, r, f"{base}.norm1.weight", (dim,), pre)
            _check(st, r, f"{base}.norm1.bias", (dim,), pre)
            _check(st, r, f"{base}.norm2.weight", (dim,), pre)
            _check(st, r, f"{base}.norm2.bias", (dim,), pre)
            _check(st, r, f"{base}.linear1.weight", (cfg.hidden, dim), pre)
            _check(st, r, f"{base}.linear2.weight", (dim, cfg.hidden), pre)
            _check(st, r, f"{base}.layer_scale_1.scale", (dim,), pre)
            _check(st, r, f"{base}.layer_scale_2.scale", (dim,), pre)
    return r


def verify_weights(st, flowlm_cfg: FlowLMConfig = FlowLMConfig(),
                   mimi_cfg: MimiConfig = MimiConfig()) -> VerifyReport:
    a = verify_flowlm(st, flowlm_cfg)
    b = verify_mimi(st, mimi_cfg)
    return VerifyReport(
        missing=a.missing + b.missing,
        mismatch=a.mismatch + b.mismatch,
        ambiguous=a.ambiguous + b.ambiguous,
    )
