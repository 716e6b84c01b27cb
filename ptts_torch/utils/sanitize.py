"""Stage-boundary finite guards for the port (PTTS_SANITIZE=1), the
counterpart of ptts_tpu/utils/sanitize.py.

The switch and the error are ptts_tpu's own, so one ``set_enabled`` or one
PTTS_SANITIZE governs both packages. The two checks are rewritten here:
ptts_tpu's ``check_tree`` walks the tree with jax (which the GPU machine
does not have), and its ``check_finite`` reads arrays with ``np.asarray``,
which a CUDA tensor refuses. When sanitize mode is off both return at once;
when it is on, each tensor is read back to the host once.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ptts_tpu.utils.sanitize import SanitizeError, _find_nonfinite, enabled, set_enabled  # noqa: F401


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
