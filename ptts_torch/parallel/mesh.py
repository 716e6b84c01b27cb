"""Device mesh + batch sharding for data-parallel serving (port of
ptts_tpu/parallel/mesh.py).

Serving is pure data parallelism: every device holds the full weights,
streams never communicate, and there are no collectives. JAX says this with
one global array under a NamedSharding and lets GSPMD partition the
program; the port says it with explicit per-device pieces, one per mesh
position, and runs the same eager code on each piece. So the JAX module's
``replicated()`` and ``batch_sharding()`` (GSPMD shardings) have no
counterpart here.

A mesh is an [n_hosts, per_host] grid of devices: 1-D (``batch``) or the
hybrid 2-D (``dcn``, ``batch``) layout of the multi-host serving story,
whose slow axis groups the positions that admit together (one admission
queue per host group). Positions are numbered dcn-major. A device may
repeat: ``make_mesh(["cpu"] * 8)`` is the CPU rehearsal (JAX's 8 virtual
CPU devices), ``make_multihost_mesh(2, ["cuda:0"] * 4)`` the same layout on
one card. Only a flat device list is simulated; a multi-process launch (one
process per host) is not part of the port yet.

Usage:
    mesh = make_mesh()                              # 1-D, every visible GPU
    mesh = make_multihost_mesh(2)                   # 2-D (dcn, batch)
    fw = shard_weights(mesh, engine.fw)             # {device: weights}
    caches = shard_cache(mesh, cache)               # one KVCache per position
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.flowlm import KVCache

BATCH_AXIS = "batch"
DCN_AXIS = "dcn"


def normalize_device(device) -> torch.device:
    """torch.device with an explicit index for CUDA: a bare ``cuda`` means
    the current device, which is what torch.Generator and CUDA events would
    silently pick."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def on_device(device: torch.device):
    """Context that makes a CUDA ``device`` current (CUDA streams and events
    act on the current device); a no-op for a CPU device."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[Tuple[torch.device, ...], ...]   # [n_hosts][per_host]
    axis_names: Tuple[str, ...]                    # (batch,) or (dcn, batch)

    @property
    def device_list(self) -> List[torch.device]:
        """The devices in position order (dcn-major)."""
        return [d for row in self.devices for d in row]

    @property
    def size(self) -> int:
        return sum(len(row) for row in self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as jax.sharding.Mesh.shape."""
        sizes = (len(self.devices), len(self.devices[0]))
        return dict(zip(self.axis_names, sizes[-len(self.axis_names):]))


def _default_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible: pass the mesh's devices explicitly "
                           "(e.g. ['cpu'] * 8 to rehearse on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def _grid(devices: Optional[Sequence], num_hosts: int) -> Tuple[Tuple[torch.device, ...], ...]:
    devs = [normalize_device(d) for d in (_default_devices() if devices is None else devices)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"a mesh takes one device type, got {sorted({d.type for d in devs})}")
    if len(devs) % num_hosts:
        raise ValueError(f"{len(devs)} devices do not split into {num_hosts} host groups")
    per_host = len(devs) // num_hosts
    return tuple(tuple(devs[h * per_host:(h + 1) * per_host]) for h in range(num_hosts))


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible CUDA device; raises
    when there is none rather than building a CPU mesh)."""
    return Mesh(_grid(devices, 1), (BATCH_AXIS,))


def make_multihost_mesh(num_hosts: int, devices: Optional[Sequence] = None) -> Mesh:
    """2-D (dcn, batch) mesh: ``devices`` (default: every visible CUDA
    device) reshaped to [num_hosts, per_host], host groups along axis 0."""
    return Mesh(_grid(devices, num_hosts), (DCN_AXIS, BATCH_AXIS))


def _tree_to(x: Any, device: torch.device) -> Any:
    """A weight module (convert.TensorTree) with every buffer on ``device``;
    a buffer already there is shared, not copied (None stays None)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, nn.ModuleList):
        return nn.ModuleList(_tree_to(m, device) for m in x)
    if isinstance(x, nn.Module):
        out = copy.copy(x)
        out._buffers = {k: _tree_to(v, device) for k, v in x._buffers.items()}
        out._modules = {k: _tree_to(m, device) for k, m in x._modules.items()}
        return out
    return x


def shard_weights(mesh: Mesh, weights: Any) -> Dict[torch.device, Any]:
    """Replicate the weights: one copy per DISTINCT mesh device, keyed by
    device (a repeated device gets one copy; a device that already holds a
    tensor shares it)."""
    return {d: _tree_to(weights, d) for d in dict.fromkeys(mesh.device_list)}


def shard_batch_array(mesh: Mesh, x: torch.Tensor, batch_dim: int = 0) -> List[torch.Tensor]:
    """Split ``x`` on ``batch_dim`` into mesh.size equal contiguous pieces,
    piece i on position i's device (always a copy, never a view of x)."""
    n = mesh.size
    if x.shape[batch_dim] % n:
        raise ValueError(f"batch {x.shape[batch_dim]} does not divide over {n} mesh positions")
    pieces = torch.split(x, x.shape[batch_dim] // n, dim=batch_dim)
    return [p.to(d, copy=True, memory_format=torch.contiguous_format)
            for p, d in zip(pieces, mesh.device_list)]


def gather_batch(parts: Sequence[torch.Tensor], batch_dim: int = 0,
                 device=None) -> torch.Tensor:
    """Concatenate per-position pieces back into one tensor on ``device``
    (default: the first piece's)."""
    dev = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(dev) for p in parts], dim=batch_dim)


def shard_cache(mesh: Mesh, cache: KVCache) -> List[KVCache]:
    """One flowlm.KVCache per position: k/v [L, B, T, H, D] split at dim 1,
    prefix_len/start at dim 0; each position gets its own copy of the device
    cursor on its device (the host t0 and cursor mirror are shared)."""
    k = shard_batch_array(mesh, cache.k, 1)
    v = shard_batch_array(mesh, cache.v, 1)
    plen = shard_batch_array(mesh, cache.prefix_len)
    start = shard_batch_array(mesh, cache.start)
    return [KVCache(k=k[i], v=v[i], prefix_len=plen[i], start=start[i],
                    cursor=cache.cursor.to(d, copy=True), t0=cache.t0,
                    cursor_host=cache.cursor_host)
            for i, d in enumerate(mesh.device_list)]


def pad_batch_to_mesh(batch: int, mesh: Mesh) -> int:
    """Round a batch size up to a multiple of the mesh size, so that one
    batch held for the whole mesh splits with shard_batch_array (the
    batcher sizes its shards itself and does not need it)."""
    n = mesh.size
    return ((batch + n - 1) // n) * n


def num_host_groups(mesh: Mesh) -> int:
    """Host groups along the slow (dcn) axis; 1 for a 1-D mesh."""
    if DCN_AXIS in mesh.axis_names:
        return mesh.shape[DCN_AXIS]
    return 1


def shard_mimi_stream_state(mesh: Mesh, state) -> List[dict]:
    """One mimi_stream state per position. Layout (mimi_stream.init_state):
    every tensor is [B, ...] except the transformer ring K/V, [L, B, RING,
    H, D] (batch at dim 1); each position gets its own copy of the device
    ring cursor ``wc`` on its device.
    For a streaming state built for the whole mesh and then split; the
    batcher builds each shard's state on its device directly."""
    ring = state["ring"]
    up, dec_in, dec_out = (shard_batch_array(mesh, state[k]) for k in ("up", "dec_in", "dec_out"))
    rk, rv = shard_batch_array(mesh, ring["k"], 1), shard_batch_array(mesh, ring["v"], 1)
    pos, kpos = shard_batch_array(mesh, ring["pos"]), shard_batch_array(mesh, ring["kpos"])
    stages = [{k: shard_batch_array(mesh, v) for k, v in st.items()} for st in state["stages"]]
    return [{
        "up": up[i],
        "ring": {"k": rk[i], "v": rv[i], "pos": pos[i], "kpos": kpos[i],
                 "wc": ring["wc"].to(d, copy=True)},
        "dec_in": dec_in[i],
        "stages": [{k: parts[i] for k, parts in st.items()} for st in stages],
        "dec_out": dec_out[i],
    } for i, d in enumerate(mesh.device_list)]
