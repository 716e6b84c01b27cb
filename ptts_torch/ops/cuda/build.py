"""Build the hand-written CUDA kernels at first use, load them with ctypes,
and keep the registry of the port's kernel wrappers.

``nvcc`` compiles every ``ptts_torch/csrc/*.cu`` for sm_90a into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds). The library lands in the build directory of utils/compile_cache
(default ``ptts_torch/_build/``; ``PTTS_COMPILE_CACHE`` moves it) under a
name keyed by a hash of the sources and flags, so a changed source is always
rebuilt and an unchanged one never is; nvcc's report (registers, shared
memory and spills per kernel, from ``-Xptxas -v``) is kept beside it as
``<library>.log``.

Each C entry point is declared once, by the module that calls it
(``declare``, or ``kernel`` for a wrapper), and its signature is applied at
its first use (``entry``). ``@kernel(symbol, argtypes)`` registers a wrapper
in WRAPPERS under its name and gives it ``.launches`` (int) and ``.shapes``
(a Counter of shape keys); the wrapper's body launches through ``launch``,
which counts both. Everything that counts, resets or checks the kernels
(runtime/graphs, tools/sanitize, the bench, chip_smoke) iterates WRAPPERS,
so adding a kernel takes its ``csrc/<k>.cu`` and its ``ops/cuda/<k>.py``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import torch

from ...utils.compile_cache import build_dir

_PKG = Path(__file__).resolve().parents[2]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_entries: dict = {}

# C symbol -> (argtypes, restype), declared by the module that calls it
SIGNATURES: dict = {}
# wrapper name -> the registered kernel wrapper
WRAPPERS: dict = {}
# set by tools/sanitize only: CHECK(name, outputs) after each eager call of a wrapper
CHECK: Optional[Callable] = None


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
            _lib = ctypes.CDLL(str(library_path()))
        return _lib


def declare(symbol: str, argtypes: list, restype=ctypes.c_int) -> None:
    """Declare the C entry point ``symbol``'s signature (applied at its first use)."""
    if SIGNATURES.setdefault(symbol, (argtypes, restype)) != (argtypes, restype):
        raise ValueError(f"{symbol} is already declared with another signature")


def entry(symbol: str):
    """The library's C entry point ``symbol``, its declared signature applied."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(library(), symbol)
        fn.argtypes, fn.restype = SIGNATURES[symbol]
        _entries[symbol] = fn
    return fn


declare("ptts_error_string", [ctypes.c_int], ctypes.c_char_p)


def raise_on(rc: int, name: str) -> None:
    """Raise naming ``name`` when a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({entry('ptts_error_string')(rc).decode()})")


def kernel(symbol: str, argtypes: list):
    """Decorator: declare ``symbol`` (returning a cudaError_t) and register the
    wrapper that launches it, with ``.launches``, ``.shapes`` and ``.symbol``;
    CHECK, when set, sees the outputs of each call outside a graph capture."""
    declare(symbol, argtypes)

    def register(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            if CHECK is not None and not (torch.cuda.is_available()
                                          and torch.cuda.is_current_stream_capturing()):
                CHECK(fn.__name__, out)
            return out

        wrapper.symbol, wrapper.launches, wrapper.shapes = symbol, 0, collections.Counter()
        WRAPPERS[fn.__name__] = wrapper
        return wrapper
    return register


def launch(wrapper, shape: tuple, like: torch.Tensor, *args) -> None:
    """Call ``wrapper``'s C entry point, inside ``like``'s device, with
    ``args`` and then the two arguments every kernel entry point ends with:
    is_bf16 (``like``'s dtype) and the device's current stream. Raise on a
    CUDA error; count the launch on the wrapper, under the key (``like``'s
    dtype, *shape)."""
    bf16 = like.dtype == torch.bfloat16
    with torch.cuda.device(like.device):
        rc = entry(wrapper.symbol)(*args, int(bf16), torch.cuda.current_stream().cuda_stream)
    raise_on(rc, wrapper.__name__)
    wrapper.launches += 1
    wrapper.shapes[("bf16" if bf16 else "f32",) + shape] += 1


def shape_label(key: tuple) -> str:
    """The label of a shape key: "bf16 B=256 T=544" for (dtype, B, T), with
    " H=.. Hkv=.." after it for a grouped decode key (dtype, B, Tmax, H, Hkv)."""
    return " ".join([key[0]] + [f"{n}={v}" for n, v in zip(("B", "T", "H", "Hkv"), key[1:])])


def parse_shape_label(label: str) -> tuple:
    """The shape key of a shape_label()."""
    dtype, *fields = label.split()
    return (dtype, *(int(f.split("=")[1]) for f in fields))
