"""Normalization layers (port of ptts_tpu/ops/norms.py).

Same numerics as the JAX package: the variance uses the one-pass form
E[x^2] - E[x]^2 clamped at 0, statistics in f32, output in the input dtype.
  * layernorm: biased variance (/d), eps inside the sqrt
  * kyutai_rmsnorm: centred variance with the d/(d-1) correction, but the
    output is the UNcentred x scaled by alpha/sqrt(var + eps)
  * rmsnorm: the hybrid backbone's plain RMSNorm (models/hybrid.py; the
    JAX package has no such backbone)
"""

from __future__ import annotations

from typing import Optional

import torch


def layernorm(x: torch.Tensor, weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; weight/bias may be None (final flow layer)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    meansq = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(meansq - mean * mean, min=0.0)
    y = (xf - mean) * (1.0 / torch.sqrt(var + eps))
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def kyutai_rmsnorm(x: torch.Tensor, alpha: Optional[torch.Tensor],
                   eps: float = 1e-5) -> torch.Tensor:
    """Nonstandard RMSNorm: centred sample variance (d-1), uncentred output."""
    xf = x.float()
    d = x.shape[-1]
    mean = xf.mean(-1, keepdim=True)
    meansq = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(meansq - mean * mean, min=0.0) * (d / max(d - 1, 1))
    y = xf * (1.0 / torch.sqrt(var + eps))
    if alpha is not None:
        y = y * alpha
    return y.to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """Plain RMSNorm (the hybrid backbone's): x / sqrt(mean(x^2) + eps) * weight,
    statistics in f32, output in the input dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight
    return y.to(x.dtype)
