"""Model configuration and kernel switches (the port's copy of
ptts_tpu/config.py).

The reference hardcodes hyperparameters as #defines
(reference/ptts_flowlm.c:20-30, reference/ptts_mimi.c:12-17).
Here they are typed, frozen dataclasses so alternative checkpoints can be
described without recompiling, and so tests can shrink the models.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FlowLMConfig:
    """FlowLM: text -> acoustic-latent autoregressive flow-matching model.

    Mirrors reference/ptts_flowlm.c:20-30.
    """

    vocab: int = 4000          # text vocab (embed table has vocab+1 rows)
    text_dim: int = 1024
    d_model: int = 1024
    num_heads: int = 16
    head_dim: int = 64
    num_layers: int = 6
    hidden: int = 4096         # FFN width
    latent_dim: int = 32
    flow_dim: int = 512
    flow_depth: int = 6
    time_freqs: int = 128      # timestep embedding frequency count
    max_period: float = 10000.0
    ln_eps: float = 1e-5
    flow_ln_eps: float = 1e-6  # flow-net resblock / final-layer LayerNorm eps
    rms_eps: float = 1e-5      # time-embed RMSNorm eps

    @property
    def qkv_dim(self) -> int:
        return 3 * self.d_model


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    """Mimi decoder: latent -> 24 kHz waveform.

    Mirrors reference/ptts_mimi.c:12-17 and the SEANet geometry at
    reference/ptts_mimi.c:384-487.
    """

    latent_dim: int = 32
    d_model: int = 512
    num_heads: int = 8
    head_dim: int = 64
    num_layers: int = 2
    hidden: int = 2048
    context: int = 250          # sliding attention window
    max_period: float = 10000.0
    ln_eps: float = 1e-5
    # Depthwise upsample: 12.5 Hz -> 200 Hz.
    upsample_kernel: int = 32
    upsample_stride: int = 16
    # SEANet decoder: conv k7 512->512, then per-stage (convtr, resblock).
    n_filters: int = 64
    ratios: Tuple[int, ...] = (6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel: int = 3
    compress: int = 2

    @property
    def frame_samples(self) -> int:
        """PCM samples per 80 ms FlowLM frame (16*6*5*4 = 1920)."""
        n = self.upsample_stride
        for r in self.ratios:
            n *= r
        return n

    @property
    def frame_rate(self) -> float:
        return 12.5

    @property
    def sample_rate(self) -> int:
        return int(self.frame_samples * self.frame_rate)


_CHOICES = {
    "prefill_impl": ("auto", "kernel", "plain"),
    "window_impl": ("auto", "kernel", "plain"),
    "decode_impl": ("auto", "einsum", "blocked"),
    "layer_impl": ("auto", "scan", "unroll"),
}


@dataclasses.dataclass(frozen=True)
class KernelFlags:
    """Per-op dispatch switches, the port's counterpart of the JAX package's
    KernelFlags (the reference's PTTS_CUDA_* switches, ptts_kernels.c:42-67).
    runtime/engine.flags_from_env reads them from the environment.

    The kernel switches choose, on the card, between a hand-written kernel
    and its plain PyTorch version, for A/B measurements; neither is a
    fallback for the other. An unknown value raises ValueError.
    """

    # AR decode attention: "auto" (== "einsum", the masked einsum over
    # KVCache.valid_mask) or "blocked" (ops/attention.decode_attention_blocked:
    # online softmax over cache blocks up to the cursor; it assumes a cache
    # that does not wrap, so the continuous batcher refuses it)
    decode_impl: str = "auto"
    # Mimi windowed attention: "auto" (the kernel on a CUDA device, the plain
    # version on the CPU), "kernel" (B2, ops/cuda/fused_attention.
    # window_attention_qkv; refused on the CPU) or "plain" (its plain version
    # on any device). Resolved once at engine construction
    # (models/mimi.resolve_window_impl).
    window_impl: str = "auto"
    # FlowLM prefill attention: the same three values for B1
    # (causal_attention_qkv), resolved by models/flowlm.resolve_prefill_impl.
    prefill_impl: str = "auto"
    # Layer loops: "auto", "scan" or "unroll". The JAX package chooses
    # between lax.scan and an unrolled loop; PyTorch runs eagerly and the
    # port has one Python layer loop, which all three values run.
    layer_impl: str = "auto"
    # with decode_impl="blocked": run both decode attentions, print their
    # max difference, use the masked einsum's (PTTS_CUDA_VALIDATE analogue)
    validate: bool = False

    def __post_init__(self):
        for name, allowed in _CHOICES.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(f"KernelFlags.{name}={value!r}: expected one of {allowed}")


def resolve_kernel_impl(choice: str, env_var: str, on_card: bool, what: str) -> str:
    """A kernel switch ("auto", "kernel", "plain") resolved for an engine:
    "auto" consults ``env_var`` (0 -> plain, 1 -> kernel), then the device
    (the kernel on CUDA, the plain version on the CPU). "kernel" off the
    card raises ValueError: there is no kernel to run there."""
    if choice not in _CHOICES["prefill_impl"]:
        raise ValueError(f"{what} {choice!r}: expected one of {_CHOICES['prefill_impl']}")
    if choice == "auto":
        choice = {"0": "plain", "1": "kernel"}.get(os.environ.get(env_var, ""), "auto")
    if choice == "auto":
        return "kernel" if on_card else "plain"
    if choice == "kernel" and not on_card:
        raise ValueError(f"{what} 'kernel' needs a CUDA device")
    return choice


DEFAULT_FLOWLM = FlowLMConfig()
DEFAULT_MIMI = MimiConfig()
