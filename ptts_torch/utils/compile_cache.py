"""Where the port's native builds land (port of
ptts_tpu/utils/compile_cache.py).

The JAX package compiles XLA executables and keeps them in a persistent
compilation cache. The port's compiled artefacts are its two shared
libraries, built at first use from the sources in the checkout: the CUDA
kernels (ops/cuda/build.py, nvcc) and the host library (native/, g++).
Both are named by a hash of their sources, so a directory that keeps them
is this port's compile cache: an unchanged source is never rebuilt.

  * default: ``ptts_torch/_build/`` inside the checkout (.gitignore lists it)
  * ``PTTS_COMPILE_CACHE=<dir>``: that directory, e.g. for a package
    directory without write access
  * ``PTTS_COMPILE_CACHE=0``: a temporary directory of this process,
    removed at exit (every process builds anew)
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Optional

DEFAULT_DIR = Path(__file__).resolve().parents[1] / "_build"

_lock = threading.Lock()
_dir: Optional[Path] = None
_persistent = True


def enable_persistent_cache(cache_dir: Optional[str] = None) -> bool:
    """Choose the build directory: ``cache_dir``, else $PTTS_COMPILE_CACHE,
    else the default. Idempotent once chosen, unless ``cache_dir`` names a
    new one. Returns True when builds persist across processes (False for
    PTTS_COMPILE_CACHE=0)."""
    global _dir, _persistent
    with _lock:
        if cache_dir is None and _dir is not None:
            return _persistent
        env = os.environ.get("PTTS_COMPILE_CACHE", "")
        if cache_dir is None and env == "0":
            tmp = tempfile.mkdtemp(prefix="ptts_build_")
            atexit.register(shutil.rmtree, tmp, True)
            _dir, _persistent = Path(tmp), False
        else:
            _dir, _persistent = Path(cache_dir or env or DEFAULT_DIR), True
        return _persistent


def build_dir() -> Path:
    """The directory the shared libraries build into (chosen on first use)."""
    enable_persistent_cache()
    return _dir  # type: ignore[return-value]
