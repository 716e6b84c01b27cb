"""ctypes bindings for the C++ host library (ptts_torch/csrc/ptts_host.cpp,
the port's copy of the JAX package's csrc/ptts_host.cpp).

Builds the shared object on first use with g++ into the build directory of
utils/compile_cache (default ptts_torch/_build/), under a name keyed by a
hash of the source; every entry point has a
pure-Python fallback so the host layer works without a compiler. Use
``native.available()`` to check.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ..utils.compile_cache import build_dir

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "ptts_host.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """Build (or reuse) the shared object, named by a content hash of the
    source -- mtimes are unreliable after git checkouts, and the binary is
    never committed, so a changed source is always rebuilt and an unchanged
    one never is. The build lands under a temporary name and is renamed into
    place, so a concurrent build is never loaded half written."""
    if not os.path.isfile(_SRC):
        return None
    with open(_SRC, "rb") as f:
        src_hash = hashlib.sha256(f.read()).hexdigest()
    out_dir = str(build_dir())
    so = os.path.join(out_dir, f"libptts_host_{src_hash[:16]}.so")
    if os.path.isfile(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, OSError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.ptts_spm_load_buf.restype = ctypes.c_void_p
        lib.ptts_spm_load_buf.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.ptts_spm_free.argtypes = [ctypes.c_void_p]
        lib.ptts_spm_vocab_size.argtypes = [ctypes.c_void_p]
        lib.ptts_spm_vocab_size.restype = ctypes.c_int
        lib.ptts_spm_flags.argtypes = [ctypes.c_void_p]
        lib.ptts_spm_flags.restype = ctypes.c_int
        lib.ptts_spm_piece.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int]
        lib.ptts_spm_piece.restype = ctypes.c_int
        lib.ptts_spm_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.ptts_spm_encode.restype = ctypes.c_int
        lib.ptts_wav_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.ptts_wav_write.restype = ctypes.c_int
        lib.ptts_quantize_i16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
        ]
        lib.ptts_f16_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.ptts_bf16_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.ptts_frame_noise.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeTokenizer:
    """C++ SentencePiece tokenizer handle (same results as tokenizer/spm.py)."""

    def __init__(self, model_bytes: bytes):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.ptts_spm_load_buf(model_bytes, len(model_bytes))
        if not self._h:
            raise ValueError("failed to parse SentencePiece model (native)")

    @classmethod
    def load(cls, path: str) -> "NativeTokenizer":
        with open(path, "rb") as f:
            return cls(f.read())

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ptts_spm_free(h)
            self._h = None

    @property
    def vocab_size(self) -> int:
        return self._lib.ptts_spm_vocab_size(self._h)

    def piece(self, pid: int) -> Optional[bytes]:
        n = self._lib.ptts_spm_piece(self._h, pid, None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n)
        self._lib.ptts_spm_piece(self._h, pid, buf, n)
        return buf.raw[:n]

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        cap = max(4 * len(data) + 16, 64)
        out = (ctypes.c_int * cap)()
        n = self._lib.ptts_spm_encode(self._h, data, len(data), out, cap)
        if n < 0:
            if -n > cap:  # undersized buffer: retry exact
                cap = -n
                out = (ctypes.c_int * cap)()
                n = self._lib.ptts_spm_encode(self._h, data, len(data), out, cap)
            if n < 0:
                raise ValueError("tokenization failed (native)")
        return list(out[:n])


def quantize_i16(samples: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(samples, np.float32)
    out = np.empty(s.size, np.int16)
    lib.ptts_quantize_i16(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        s.size,
    )
    return out


def wav_write(path: str, samples: np.ndarray, sample_rate: int,
              channels: int) -> bool:
    lib = _load()
    if lib is None:
        return False
    s = np.ascontiguousarray(samples, np.float32)
    rc = lib.ptts_wav_write(
        path.encode(), s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.size, sample_rate, channels,
    )
    return rc == 0


def f16_to_f32(bits: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    b = np.ascontiguousarray(bits, np.uint16)
    out = np.empty(b.size, np.float32)
    lib.ptts_f16_to_f32(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b.size,
    )
    return out.reshape(bits.shape)


def frame_noise(seed: int, frames: int, latent_dim: int, temp: float,
                noise_clamp: float) -> Optional[np.ndarray]:
    """[frames, latent_dim] reference-compatible noise (ptts_frame_noise)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((frames, latent_dim), np.float32)
    lib.ptts_frame_noise(
        ctypes.c_int64(np.array(seed, np.int64).item()),
        frames, latent_dim, ctypes.c_float(temp), ctypes.c_float(noise_clamp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
