"""The hybrid backbone's Mamba-2 frame step as hand-written CUDA kernels.

Wrapper of the kernels in ptts_torch/csrc/ssm_step.cu, with its plain
PyTorch version beside it:

  * ssm_step -- one position of one Mamba layer for every row: the conv
    window shifted, the depthwise conv and SiLU, dt's softplus and decay
    (a prologue kernel), then one pass over the SSM state that reads each
    row's [H, P, N] state once and writes it back once, in its own dtype,
    and reads y out of it. It replaces no Pallas kernel: the JAX package
    has no hybrid backbone.
  * ssm_step_plain -- the plain version.

Both take xbc [B, C] and dt [B, H] (C = H*P + 2N: the conv's channels x, B
and C; views of the input projection's output may be passed as they are),
ssm [B, H, P, N] and conv [B, d_conv - 1, C] (advanced IN PLACE), the
layer's conv_w [C, d_conv], conv_b [C], dt_bias, A_log and D [H], and
``live`` (an optional 0-d bool on the device: when False both states keep
their values, bit for bit). They return y [B, H*P] in float32, the D skip
included and the gate not yet applied. Per element, in float32:

    s' = exp(dt[h] A[h]) s + (dt[h] x[h, p]) B[n]    rounded once, to the state's dtype
    y[h, p] = sum_n C[n] s'[p, n] + D[h] x[h, p]     from s' as stored

Given a CPU tensor the wrapper computes the plain version; given a CUDA
tensor it launches the kernels or raises -- there is no fallback from one
to the other. The kernels are compiled for P = 64, N = 128 and d_conv = 4
(Granite 4.0-H's), every tensor in one dtype (float32 or bfloat16). The
wrapper counts its calls that reach the kernels in ``ssm_step.launches``
and, per (dtype, B, H), in the Counter ``ssm_step.shapes``; a CUDA graph
that captured a launch adds it again at each replay (runtime/graphs).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..activations import silu
from . import build

KERNEL_HEAD_DIM = 64    # P, the head dim the kernels are compiled for
KERNEL_D_STATE = 128    # N
KERNEL_D_CONV = 4       # the conv's taps


def ssm_step_plain(xbc: torch.Tensor, dt: torch.Tensor, ssm: torch.Tensor, conv: torch.Tensor,
                   conv_w: torch.Tensor, conv_b: torch.Tensor, dt_bias: torch.Tensor,
                   A_log: torch.Tensor, D: torch.Tensor,
                   live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ssm_step in plain PyTorch (see the module's docstring)."""
    B, H, P, N = ssm.shape
    window = torch.cat([conv, xbc[:, None].to(conv.dtype)], 1)    # [B, K, C]
    conv.copy_(window[:, 1:] if live is None else torch.where(live, window[:, 1:], conv))
    xc = (window.float() * conv_w.float().T).sum(1) + conv_b.float()
    xs, Bm, Cm = silu(xc).to(xbc.dtype).float().split([H * P, N, N], dim=-1)
    dt = F.softplus(dt.float() + dt_bias.float())                 # [B, H]
    dA = torch.exp(dt * -torch.exp(A_log.float()))
    xs = xs.reshape(B, H, P)
    new = (ssm.float() * dA[:, :, None, None]
           + (xs * dt[..., None])[..., None] * Bm[:, None, None, :]).to(ssm.dtype)
    ssm.copy_(new if live is None else torch.where(live, new, ssm))
    y = torch.bmm(ssm.float().view(B, H * P, N), Cm[:, :, None])[..., 0]
    return y + (D.float()[:, None] * xs).reshape(B, H * P)


def _check(xbc: torch.Tensor, dt: torch.Tensor, ssm: torch.Tensor, conv: torch.Tensor,
           params, live: Optional[torch.Tensor]) -> None:
    """Raise on anything the kernels do not take."""
    if ssm.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the state must be float32 or bfloat16, got {ssm.dtype}")
    tensors = (xbc, dt, conv) + tuple(params)
    if any(t.dtype != ssm.dtype for t in tensors):
        raise TypeError(f"xbc, dt, conv and the layer's weights must be in the state's dtype "
                        f"{ssm.dtype}, got {[t.dtype for t in tensors]}")
    if ssm.dim() != 4:
        raise ValueError(f"ssm must be [B, H, P, N], got {list(ssm.shape)}")
    B, H, P, N = ssm.shape
    if P != KERNEL_HEAD_DIM or N != KERNEL_D_STATE:
        raise ValueError(f"the kernels are built for P = {KERNEL_HEAD_DIM} and N = "
                         f"{KERNEL_D_STATE}, got P = {P}, N = {N}")
    C = H * P + 2 * N
    conv_w, conv_b, dt_bias, A_log, D = params
    if (tuple(xbc.shape) != (B, C) or tuple(dt.shape) != (B, H)
            or tuple(conv.shape) != (B, KERNEL_D_CONV - 1, C)
            or tuple(conv_w.shape) != (C, KERNEL_D_CONV) or tuple(conv_b.shape) != (C,)
            or any(tuple(t.shape) != (H,) for t in (dt_bias, A_log, D))):
        raise ValueError(f"shapes xbc {list(xbc.shape)}, dt {list(dt.shape)}, conv "
                         f"{list(conv.shape)}, conv_w {list(conv_w.shape)} do not fit ssm "
                         f"{list(ssm.shape)} with {KERNEL_D_CONV} conv taps")
    if xbc.stride(-1) != 1 or dt.stride(-1) != 1 or xbc.stride(0) != dt.stride(0):
        raise ValueError(f"xbc and dt must be rows of unit stride, equally far apart, got "
                         f"strides {xbc.stride()}, {dt.stride()}")
    if not all(t.is_contiguous() for t in (ssm, conv) + tuple(params)):
        raise ValueError("ssm, conv and the layer's weights must be contiguous")
    if ssm.data_ptr() % 16:
        raise ValueError("ssm must start 16-byte aligned")
    if live is not None and (live.dtype != torch.bool or live.numel() != 1):
        raise ValueError(f"live must be one bool, got {live.dtype} {list(live.shape)}")
    devices = tensors + (ssm,) + (() if live is None else (live,))
    if ssm.device.type != "cuda" or any(t.device != ssm.device for t in devices):
        raise ValueError(f"the tensors must lie on one CUDA device or on the CPU, got "
                         f"{sorted({str(t.device) for t in devices})}")


_P, _I = ctypes.c_void_p, ctypes.c_int


@build.kernel("ptts_ssm_step", [_P, _P, ctypes.c_longlong] + [_P] * 10 + [_I] * 3 + [_P])
def ssm_step(xbc: torch.Tensor, dt: torch.Tensor, ssm: torch.Tensor, conv: torch.Tensor,
             conv_w: torch.Tensor, conv_b: torch.Tensor, dt_bias: torch.Tensor,
             A_log: torch.Tensor, D: torch.Tensor,
             live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Mamba-2 position for every row, the states advanced in place;
    returns y [B, H*P] float32 (see the module's docstring)."""
    params = (conv_w, conv_b, dt_bias, A_log, D)
    if ssm.device.type == "cpu":
        return ssm_step_plain(xbc, dt, ssm, conv, *params, live)
    _check(xbc, dt, ssm, conv, params, live)
    B, H, P, _ = ssm.shape
    work = torch.empty(B, conv.shape[-1] + 2 * H, dtype=torch.float32, device=ssm.device)
    y = torch.empty(B, H * P, dtype=torch.float32, device=ssm.device)
    build.launch(ssm_step, (B, H), ssm, xbc.data_ptr(), dt.data_ptr(), xbc.stride(0),
                 ssm.data_ptr(), conv.data_ptr(), *(t.data_ptr() for t in params),
                 None if live is None else live.data_ptr(), work.data_ptr(), y.data_ptr(), B, H)
    return y
