"""Model configuration (the port's copy of ptts_tpu/config.py, without its
KernelFlags: the port has one path per op).

The reference hardcodes hyperparameters as #defines
(reference/ptts_flowlm.c:20-30, reference/ptts_mimi.c:12-17).
Here they are typed, frozen dataclasses so alternative checkpoints can be
described without recompiling, and so tests can shrink the models.
"""

from __future__ import annotations

import dataclasses
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


DEFAULT_FLOWLM = FlowLMConfig()
DEFAULT_MIMI = MimiConfig()
