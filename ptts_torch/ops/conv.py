"""Causal 1-D convolutions with the reference's padding semantics (port of
ptts_tpu/ops/conv.py).

  * conv1d: out_len = T // stride, zero left pad of (k - stride)
  * transposed conv with k == 2*stride: out_len = T * stride

The public functions keep the JAX package's layout: activations [B, T, C],
conv kernels in WIO order [k, in/g, out], transposed convs as the two
matmul halves of prepare_convtr_halves. Inside, the work goes to
F.conv1d (cuDNN on the card) on the [B, C, T] view, and the result is handed
back as a [B, T, C] view of that memory, so a chain of convs transposes no
data between them. The JAX package leaves all of this to XLA, outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def prepare_conv_kernel(w_torch: np.ndarray) -> np.ndarray:
    """torch Conv1d weight [out, in/g, k] -> WIO kernel [k, in/g, out]."""
    return np.ascontiguousarray(np.transpose(w_torch, (2, 1, 0)))


def prepare_convtr_kernel(w_torch: np.ndarray, groups: int) -> np.ndarray:
    """torch ConvTranspose1d weight [in, out/g, k] -> flipped WIO [k, in/g, out]:
    the transposed conv equals a regular conv over the stride-dilated input
    with the kernel reversed along k. Oracle variant (with convtr1d_causal),
    as in the JAX package."""
    in_ch, out_per_group, k = w_torch.shape
    in_per_group = in_ch // groups
    w = w_torch.reshape(groups, in_per_group, out_per_group, k)[..., ::-1]
    w = np.transpose(w, (3, 1, 0, 2))     # [k, in/g, g, out/g]
    return np.ascontiguousarray(w.reshape(k, in_per_group, groups * out_per_group))


def prepare_convtr_halves(w_torch: np.ndarray, groups: int):
    """Split a k == 2*stride ConvTranspose1d weight [in, out/g, k] into its
    two matmul tables. Output position p receives exactly two taps:
        y[p] = x[p//s] . W[:, :, p%s]  +  x[p//s - 1] . W[:, :, p%s + s]
    Returns (w1, w2): [Cin, s, Cout] for groups == 1, [s, C] for depthwise.
    """
    in_ch, out_per_group, k = w_torch.shape
    s = k // 2
    assert k == 2 * s
    if groups == 1:
        w1 = np.ascontiguousarray(np.transpose(w_torch[:, :, :s], (0, 2, 1)))
        w2 = np.ascontiguousarray(np.transpose(w_torch[:, :, s:], (0, 2, 1)))
        return w1, w2
    assert groups == in_ch and out_per_group == 1, "only depthwise supported"
    w1 = np.ascontiguousarray(w_torch[:, 0, :s].T)
    w2 = np.ascontiguousarray(w_torch[:, 0, s:].T)
    return w1, w2


def conv1d_causal(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                  *, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """x: [B, T, Cin]; kernel: WIO [k, in/g, out]. Returns [B, T//stride, Cout]."""
    k = kernel.shape[0]
    xt = F.pad(x.transpose(1, 2), (k - stride, 0))
    y = F.conv1d(xt, kernel.permute(2, 1, 0).to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, groups=groups)
    return y.transpose(1, 2)


def convtr1d_causal(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                    *, stride: int, groups: int = 1) -> torch.Tensor:
    """x: [B, T, Cin]; kernel: flipped WIO [k, in/g, out] (prepare_convtr_kernel).
    Returns [B, T*stride, Cout]: the full (T-1)*stride + k outputs, right-
    trimmed by k - stride. Oracle variant: the model's transposed convs go
    through convtr1d_2s; this input-dilated form is the independent
    formulation the tests hold it to."""
    B, T, Cin = x.shape
    k = kernel.shape[0]
    dilated = x.new_zeros(B, Cin, (T - 1) * stride + 1)
    dilated[:, :, ::stride] = x.transpose(1, 2)
    y = F.conv1d(F.pad(dilated, (k - 1, k - 1)), kernel.permute(2, 1, 0).to(x.dtype),
                 groups=groups)[:, :, : T * stride]
    if bias is not None:
        y = y + bias.to(x.dtype)[:, None]
    return y.transpose(1, 2)


def convtr1d_2s(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                bias: Optional[torch.Tensor], *, stride: int,
                depthwise: bool = False) -> torch.Tensor:
    """k == 2*stride transposed conv, right-trimmed to T*stride:
    y[b, t*s + j, o] = x[b, t] . W1[:, j, o] + x[b, t-1] . W2[:, j, o].
    Dense: one GEMM [B*T, 2Cin] x [2Cin, s*Cout] and a reshape.
    Depthwise: a broadcast multiply (the small 12.5 -> 200 Hz upsample)."""
    B, T, Cin = x.shape
    s = stride
    if depthwise:
        y1 = x[:, :, None, :] * w1[None, None].to(x.dtype)
        y2 = x[:, :, None, :] * w2[None, None].to(x.dtype)
        y2 = torch.cat([torch.zeros_like(y2[:, :1]), y2[:, :-1]], dim=1)
        y = (y1 + y2).reshape(B, T * s, Cin)
        if bias is not None:
            y = y + bias
        return y.to(x.dtype)

    Cout = w1.shape[-1]
    # rows [0, Cin) meet x[t-1] (second-half taps), rows [Cin, 2Cin) x[t]
    kernel = torch.cat([w2.reshape(Cin, s * Cout), w1.reshape(Cin, s * Cout)],
                       dim=0).to(x.dtype)
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :T]
    y = torch.cat([x_prev, x], dim=-1) @ kernel          # [B, T, s*Cout]
    y = y.reshape(B, T * s, Cout)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def elu(x: torch.Tensor) -> torch.Tensor:
    """ELU(alpha=1): x >= 0 ? x : exp(x) - 1."""
    return torch.where(x >= 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)
