"""Activations with the reference's exact formulas (port of
ptts_tpu/ops/activations.py).

FlowLM uses erf-GELU, Mimi tanh-GELU; keeping both distinct matters for
parity. tanh-GELU goes through the sigmoid identity tanh(z) = 2*sigmoid(2z) - 1
exactly as the JAX package computes it, not F.gelu(approximate="tanh").
"""

from __future__ import annotations

import torch

_INV_SQRT2 = 0.7071067811865475
_SQRT_2_OVER_PI = 0.7978845608


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * _INV_SQRT2))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    z = _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)
    tanh_z = 2.0 * torch.sigmoid(2.0 * z) - 1.0
    return 0.5 * x * (1.0 + tanh_z)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
