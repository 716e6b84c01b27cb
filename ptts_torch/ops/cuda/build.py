"""Build the hand-written CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles ``ptts_torch/csrc/*.cu`` (the attention kernels, the
decode attention, the Mamba-2 frame step and the trace markers) for sm_90a into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds). The library lands in the build directory of utils/compile_cache
(default ``ptts_torch/_build/``; ``PTTS_COMPILE_CACHE`` moves it) under a
name keyed by a hash of the sources and flags, so a changed source is always
rebuilt and an unchanged one never is; nvcc's report (registers, shared
memory and spills per kernel, from ``-Xptxas -v``) is kept beside it as
``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ...utils.compile_cache import build_dir

_PKG = Path(__file__).resolve().parents[2]
SOURCES = (_PKG / "csrc" / "fused_attention.cu", _PKG / "csrc" / "decode_attention.cu",
           _PKG / "csrc" / "ssm_step.cu", _PKG / "csrc" / "markers.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use "
                       "and need the CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


def library_path() -> Path:
    """Build the library if no build of the current sources exists; return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    so = build_dir() / f"libptts_torch_kernels_{h.hexdigest()[:16]}.so"
    if so.is_file():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    Path(str(so) + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in the process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.ptts_causal_attn_qkv.argtypes = [P] * 6 + [I] * 4 + [P]
            lib.ptts_causal_attn_qkv.restype = I
            lib.ptts_window_attn_qkv.argtypes = [P] * 4 + [I] * 5 + [P]
            lib.ptts_window_attn_qkv.restype = I
            lib.ptts_decode_attn.argtypes = [P] * 6 + [I] * 5 + [ctypes.c_float, I, P]
            lib.ptts_decode_attn.restype = I
            lib.ptts_ssm_step.argtypes = [P, P, ctypes.c_longlong] + [P] * 10 + [I] * 3 + [P]
            lib.ptts_ssm_step.restype = I
            lib.ptts_mark.argtypes = [I, P]
            lib.ptts_mark.restype = I
            lib.ptts_error_string.argtypes = [I]
            lib.ptts_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
