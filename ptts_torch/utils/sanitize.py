"""Stage-boundary finite guards for the port (PTTS_SANITIZE=1), the
counterpart of ptts_tpu/utils/sanitize.py.

The port keeps its own switch and error: like the JAX package it reads
PTTS_SANITIZE once, and ``set_enabled`` overrides it for this package
alone. ``check_tree`` walks nested dicts, lists and tuples itself, and
``check_finite`` reads torch tensors on any device. When sanitize mode is
off both return at once; when it is on, each tensor is read back to the
host once.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch


class SanitizeError(RuntimeError):
    """A stage-boundary guard found a non-finite value."""


_enabled_cache: Optional[bool] = None


def enabled() -> bool:
    """True iff PTTS_SANITIZE=1. Cached after the first read so the guard
    call sites cost one probe on the serving path."""
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = os.environ.get("PTTS_SANITIZE", "0") == "1"
    return _enabled_cache


def set_enabled(on: Optional[bool]) -> None:
    """Override (or None to re-read the environment next time)."""
    global _enabled_cache
    _enabled_cache = on


def _find_nonfinite(x: np.ndarray):
    """Return (index-tuple, value) of the first non-finite element, or None."""
    if x.dtype.kind in "iub":  # integers/bools are always finite
        return None
    if x.dtype.kind != "f" or x.dtype.itemsize < 4:
        x = x.astype(np.float32)  # half precision: widen for a ufunc-safe isfinite
    bad = ~np.isfinite(x)
    if not bad.any():
        return None
    idx = tuple(int(i) for i in np.argwhere(bad)[0])
    return idx, float(x[idx]) if idx else float(x)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def check_finite(stage: str, *arrays, names: Optional[Iterable[str]] = None) -> None:
    """Raise SanitizeError if any array (torch tensor on any device, or
    numpy) holds NaN/Inf. No-op unless sanitize mode is on; None entries
    are skipped."""
    if not enabled():
        return
    labels = list(names) if names is not None else [str(i) for i in range(len(arrays))]
    for label, a in zip(labels, arrays):
        if a is None:
            continue
        found = _find_nonfinite(_host(a))
        if found is not None:
            idx, val = found
            raise SanitizeError(f"[sanitize] non-finite value at stage '{stage}', "
                                f"array '{label}', index {idx}: {val!r}")


def _leaves(tree, path: str = ""):
    """(path, leaf) for every non-None leaf of nested dicts, lists and
    tuples; the path reads like jax.tree_util.keystr (``['flow']['res']``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def check_tree(stage: str, tree) -> None:
    """Guard every leaf of a host weight dict (engine construction): a
    corrupt checkpoint fails with the tensor's path."""
    if not enabled():
        return
    for path, leaf in _leaves(tree):
        found = _find_nonfinite(_host(leaf))
        if found is not None:
            idx, val = found
            raise SanitizeError(f"[sanitize] non-finite weight at stage '{stage}', tensor "
                                f"'{path}', index {idx}: {val!r}")
