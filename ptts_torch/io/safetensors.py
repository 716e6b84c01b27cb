"""Zero-copy safetensors reader (+ writer for tests/voice files).

Counterpart of reference/ptts_safetensors.c (the port's copy of
ptts_tpu/io/safetensors.py). The reference
mmaps the file and lazily copies each tensor to malloc'd f32 per model load
(per generate call!). Here the file is mmap'd once via ``numpy.memmap`` and
tensors are exposed as zero-copy views; conversion to f32 (or device arrays)
happens once at engine construction, not per call.

Dtype conversion semantics match the reference exactly:
  * F16 -> F32: IEEE widening (bit-exact; ptts_safetensors.c:297-324)
  * BF16 -> F32: left shift by 16 bits (ptts_safetensors.c:325-330)
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# dtype table mirrors ptts_safetensors.h (F32/F16/BF16/I32/I64/BOOL).
_DTYPE_SIZE = {
    "F32": 4,
    "F16": 2,
    "BF16": 2,
    "I32": 4,
    "I64": 8,
    "BOOL": 1,
}

_NUMPY_DTYPE = {
    "F32": np.float32,
    "F16": np.float16,
    "I32": np.int32,
    "I64": np.int64,
    "BOOL": np.bool_,
    # BF16 is handled via uint16 bit views (no numpy-native bfloat16).
    "BF16": np.uint16,
}


@dataclass
class TensorEntry:
    name: str
    dtype: str
    shape: Tuple[int, ...]
    data_offset: int  # relative to start of data section
    data_size: int

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """BF16 (as uint16 bits) -> float32 via <<16, matching the C conversion."""
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Truncating f32 -> bf16 bits (used only by the writer)."""
    return (np.ascontiguousarray(x, dtype=np.float32).view(np.uint32) >> np.uint32(16)).astype(
        np.uint16
    )


class SafetensorsFile:
    """An mmap'd .safetensors file with zero-copy tensor views."""

    def __init__(self, path: str):
        self.path = path
        f = open(path, "rb")
        try:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        finally:
            f.close()
        self._buf = memoryview(self._mm)
        if len(self._buf) < 8:
            raise ValueError(f"{path}: file too small for safetensors header")
        (header_size,) = struct.unpack("<Q", self._buf[:8])
        if header_size + 8 > len(self._buf):
            raise ValueError(f"{path}: header size {header_size} exceeds file size")
        self.header_size = header_size
        header_json = bytes(self._buf[8 : 8 + header_size]).decode("utf-8")
        header = json.loads(header_json)

        self.metadata: Dict[str, str] = header.pop("__metadata__", {}) or {}
        self.tensors: List[TensorEntry] = []
        self._by_name: Dict[str, TensorEntry] = {}
        for name, entry in header.items():
            dtype = entry["dtype"]
            if dtype not in _DTYPE_SIZE:
                dtype = "UNKNOWN"
            start, end = entry["data_offsets"]
            t = TensorEntry(
                name=name,
                dtype=dtype,
                shape=tuple(int(s) for s in entry["shape"]),
                data_offset=int(start),
                data_size=int(end) - int(start),
            )
            self.tensors.append(t)
            self._by_name[name] = t

        self._data_start = 8 + header_size

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._mm is not None:
            self._buf.release()
            self._mm.close()
            self._mm = None  # type: ignore[assignment]

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- lookup ------------------------------------------------------------

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def find(self, name: str) -> Optional[TensorEntry]:
        return self._by_name.get(name)

    def names(self) -> List[str]:
        return [t.name for t in self.tensors]

    # -- data access -------------------------------------------------------

    def raw(self, t: TensorEntry) -> memoryview:
        start = self._data_start + t.data_offset
        return self._buf[start : start + t.data_size]

    def view(self, t: TensorEntry) -> np.ndarray:
        """Zero-copy numpy view (BF16 appears as uint16 bits)."""
        if t.dtype == "UNKNOWN":
            raise ValueError(f"tensor {t.name}: unsupported dtype")
        arr = np.frombuffer(self.raw(t), dtype=_NUMPY_DTYPE[t.dtype])
        return arr.reshape(t.shape)

    def get_f32(self, t: TensorEntry) -> np.ndarray:
        """Tensor as float32, matching ptts_safetensors.c:279-337 conversions."""
        v = self.view(t)
        if t.dtype == "F32":
            return np.array(v, dtype=np.float32)  # copy: caller may mutate
        if t.dtype == "F16":
            return v.astype(np.float32)  # IEEE widening is exact
        if t.dtype == "BF16":
            return _bf16_bits_to_f32(v)
        raise ValueError(f"tensor {t.name}: cannot convert {t.dtype} to f32")

    def get_f32_by_name(self, name: str) -> np.ndarray:
        t = self.find(name)
        if t is None:
            raise KeyError(name)
        return self.get_f32(t)

    def get_bf16(self, t: TensorEntry) -> torch.Tensor:
        """Tensor as a torch.bfloat16 CPU tensor, for bf16 engines.

        BF16-stored tensors are zero-copy bit views of the mmap (no host
        conversion, half the upload bytes of the f32 route); F32/F16-stored
        tensors round to nearest even (torch's f32 -> bf16 cast, the rounding
        ml_dtypes applies in the JAX package's get_bf16). The mmap is
        read-only and so is the view: callers copy before they write.
        """
        v = self.view(t)
        if t.dtype == "BF16" and t.data_size == 0:
            return torch.empty(t.shape, dtype=torch.bfloat16)
        if t.dtype == "BF16":
            with warnings.catch_warnings():
                # frombuffer warns that the buffer is not writable; the view
                # is only ever read (the weights are packed from it)
                warnings.filterwarnings("ignore", message="The given buffer is not writable")
                bits = torch.frombuffer(self.raw(t), dtype=torch.int16)
            return bits.view(torch.bfloat16).reshape(t.shape)
        if t.dtype in ("F32", "F16"):
            return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        raise ValueError(f"tensor {t.name}: cannot convert {t.dtype} to bf16")

    # -- introspection ------------------------------------------------------

    def format_tensor(self, t: TensorEntry) -> str:
        shape = ", ".join(str(s) for s in t.shape)
        return f"{t.name}  [{shape}]  {t.dtype}"

    def format_all(self) -> str:
        lines = [f"Tensors: {self.num_tensors}"]
        lines.extend(self.format_tensor(t) for t in self.tensors)
        return "\n".join(lines)


def save_safetensors(path: str, tensors: Dict[str, np.ndarray], *, bf16: Sequence[str] = ()) -> None:
    """Minimal safetensors writer (tests, synthetic checkpoints, voice files).

    ``bf16`` lists tensor names to store as BF16 (truncated from f32).
    """
    header: Dict[str, dict] = {}
    blobs: List[bytes] = []
    offset = 0
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if name in bf16:
            bits = _f32_to_bf16_bits(arr)
            blob = bits.tobytes()
            dtype = "BF16"
        elif arr.dtype == np.float32:
            blob = np.ascontiguousarray(arr).tobytes()
            dtype = "F32"
        elif arr.dtype == np.float16:
            blob = np.ascontiguousarray(arr).tobytes()
            dtype = "F16"
        elif arr.dtype == np.int32:
            blob = np.ascontiguousarray(arr).tobytes()
            dtype = "I32"
        elif arr.dtype == np.int64:
            blob = np.ascontiguousarray(arr).tobytes()
            dtype = "I64"
        elif arr.dtype == np.bool_:
            blob = np.ascontiguousarray(arr).tobytes()
            dtype = "BOOL"
        else:
            blob = np.ascontiguousarray(arr, dtype=np.float32).tobytes()
            dtype = "F32"
        header[name] = {
            "dtype": dtype,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(blob)],
        }
        blobs.append(blob)
        offset += len(blob)

    header_bytes = json.dumps(header).encode("utf-8")
    # Pad header to 8-byte alignment (standard safetensors practice).
    pad = (-(len(header_bytes)) % 8)
    header_bytes += b" " * pad

    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)
