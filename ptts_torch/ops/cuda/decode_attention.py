"""FlowLM's per-frame decode attention as a hand-written CUDA kernel.

Wrapper of the kernel in ptts_torch/csrc/decode_attention.cu, with its plain
PyTorch version beside it:

  * decode_attention -- one query per stream over the KV cache, keys and
    values read only at the columns the mask lets through. It replaces no
    Pallas kernel: the JAX package leaves this attention to XLA
    (ptts_tpu/ops/attention.py, decode_attention_masked).
  * decode_attention_masked (ops/attention.py) -- the plain version.

The signature and the semantics are the plain version's: q [B, H, D],
k_cache and v_cache [B, Tmax, Hkv, D] (the cache's own tensors, in its
dtype; Hkv = H for FlowLM, H / G for grouped-query attention with G = 2, 4
or 8 query heads per KV head, which reads each KV head once for its G),
mask [B, Tmax] bool (KVCache.valid_mask), an optional softmax ``scale``
(1/sqrt(D) by default); returns [B, H, D] in q's dtype.
Given a CPU tensor the wrapper computes the plain version; given a CUDA
tensor it launches the kernel or raises -- there is no fallback from one
to the other. It counts its calls that reach the kernel in
``decode_attention.launches`` and, per (dtype, B, Tmax), in the Counter
``decode_attention.shapes`` (grouped launches under (dtype, B, Tmax, H, Hkv));
a CUDA graph that captured a launch adds it
again at each replay (runtime/graphs).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..attention import _scale, decode_attention_masked
from . import build

KERNEL_HEAD_DIM = 64      # the head dim the kernel is compiled for
GROUPS = (1, 2, 4, 8)     # query heads per KV head the kernel is compiled for
THREADS = 256             # threads per block; a row of H * D * size bytes must divide 16 * THREADS
MAX_SPLIT_COLS = 1024     # columns one block can list: ceil(Tmax / splits) may not exceed it
MIN_SPLIT_COLS = 32       # no split narrower than this many cache columns
BLOCKS_PER_SM = 4         # the split count aims at this many blocks per SM


def splits_for(batch: int, tmax: int, sms: int) -> int:
    """How many blocks share one stream's valid columns: enough that
    ``batch`` streams give BLOCKS_PER_SM blocks per SM, none narrower than
    MIN_SPLIT_COLS columns of the cache, and enough that a share fits the
    kernel's list of MAX_SPLIT_COLS."""
    want = -(-BLOCKS_PER_SM * sms // batch)
    return max(min(want, -(-tmax // MIN_SPLIT_COLS)), -(-tmax // MAX_SPLIT_COLS), 1)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           mask: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q, k_cache and v_cache must share a dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if k_cache.dim() != 4 or q.dim() != 3:
        raise ValueError(f"q must be [B, H, D] and the caches [B, Tmax, Hkv, D], got "
                         f"{list(q.shape)}, {list(k_cache.shape)}")
    B, Tmax, H, D = k_cache.shape
    if q.shape[1] % H or q.shape[1] // H not in GROUPS:
        raise ValueError(f"{q.shape[1]} query heads over {H} KV heads: the kernel takes "
                         f"{GROUPS} query heads per KV head")
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel is built for head_dim {KERNEL_HEAD_DIM}, got {D}")
    if (16 * THREADS) % (H * D * q.element_size()):
        raise ValueError(f"{H} heads of {D} in {q.dtype}: a cache row must divide "
                         f"{16 * THREADS} bytes")
    if (tuple(q.shape) != (B, q.shape[1], D) or tuple(v_cache.shape) != tuple(k_cache.shape)
            or tuple(mask.shape) != (B, Tmax)):
        raise ValueError(f"shapes q {list(q.shape)}, k_cache {list(k_cache.shape)}, v_cache "
                         f"{list(v_cache.shape)}, mask {list(mask.shape)} do not agree")
    tensors = (q, k_cache, v_cache, mask)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k_cache, v_cache and mask must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors[:3]):
        raise ValueError("q, k_cache and v_cache must start 16-byte aligned")
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"the tensors must lie on one CUDA device or on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")


_P, _I = ctypes.c_void_p, ctypes.c_int


@build.kernel("ptts_decode_attn", [_P] * 6 + [_I] * 5 + [ctypes.c_float, _I, _P])
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     mask: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Single-query attention over a KV cache with an explicit validity mask
    (ops/attention.decode_attention_masked's contract). q [B, H, D];
    k_cache/v_cache [B, Tmax, Hkv, D]; mask [B, Tmax] bool; ``scale``
    (default 1/sqrt(D)). Returns [B, H, D]."""
    if q.device.type == "cpu":
        return decode_attention_masked(q, k_cache, v_cache, mask, scale)
    _check(q, k_cache, v_cache, mask)
    B, Tmax, H, D = k_cache.shape
    Hq = q.shape[1]
    splits = splits_for(B, Tmax, _sm_count(q.device.index))
    out = torch.empty_like(q)
    part = torch.empty(B * splits * Hq * (2 + D) if splits > 1 else 1, dtype=torch.float32,
                       device=q.device)
    build.launch(decode_attention, (B, Tmax) if Hq == H else (B, Tmax, Hq, H), q, q.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), mask.data_ptr(), out.data_ptr(),
                 part.data_ptr(), B, Tmax, H, Hq // H, splits,
                 _scale(D) if scale is None else scale)
    return out
