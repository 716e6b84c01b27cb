"""Continuous batching: admit new utterances into freed KV slots (port of
ptts_tpu/runtime/batching.py, on one device or a mesh of them).

The serving loop keeps a fixed pool of B device-resident stream slots
(FlowLM KV cache rows + streaming-Mimi state rows). Finished streams free
their slot; queued requests are prefilled in fixed-size admit groups (the
fused RoPE + causal attention kernel B1 at [admit_chunk, prefix_budget,
3*d]) and written into the freed rows without touching the other streams.

Cache geometry (models/flowlm.KVCache): columns [0, prefix_budget) hold each
slot's prompt K/V; decode columns form a RING of width max_len -
prefix_budget driven by the shared device cursor, so a slot admitted
mid-flight gets start = cursor and its gap is masked. A recycled ring column
always belongs to a finished stream, because per-request frames <=
noise_budget <= ring width, so the pool never compacts.

Shapes stay fixed and every frame step runs the whole pool with
done-masking. The pool is split into SHARDS, one per mesh position (one
shard on the engine's device without a mesh). A shard owns its device
tensors (KV cache, Mimi state, per-slot tables and params, voice bank) and
its own rows: u usable rows, then one trash row that absorbs the padded
entries of the shard's admit groups. Global rows number the shards' rows in
mesh position order (dcn-major), so host group h owns a contiguous block and
every host-side mirror (slot_req, _done_np, params, ...) is one global
row-indexed array; without a mesh the layout is the single-device one,
rows [0, slots) then the trash row. Host group h's slots/H rows are spread
as evenly as they go over its shards. JAX instead pads one block of rows
per host group (B1 = H * rows, one trash row per group): GSPMD may move an
admit group's padded entries to any row of the group, while here an admit
group prefills on ONE device and writes only that shard's rows, so each
shard needs its own trash row.

Where the port differs from the JAX module, and why:
  * No donation: admission writes the admitted rows IN PLACE on the pool
    tensors (index_copy_/index_fill_). Padded group entries all target the
    trash row, so duplicate indices land only there.
  * Host<->device traffic is asynchronous. An admit group's small arrays go
    up in one pinned buffer with one non-blocking copy (a pageable upload
    would wait for every frame in flight); each dispatch's readback (packed
    int16 PCM + flags, or the [k+1, B] flags) and each spec_admit receipt
    lands in its own pinned buffer behind a CUDA event. A pinned buffer is
    reused only after its copy's event completed.
  * The pool holds inference tensors, and inference mode is per thread:
    every method that touches device state enters it itself, so the
    server's serving thread and HTTP handler threads may call in.
  * Device noise (seed=-1) is drawn with a torch.Generator per request,
    seeded with its noise_seed: not the JAX threefry stream, same semantics.
  * A mesh is explicit (parallel/mesh.py): admission picks a shard and runs
    there; a step launches every shard in turn, each on its own device's
    current stream, starts every shard's readback, and only then waits.
  * On a CUDA engine with graphs (TTSEngine.graphs) each shard's k-frame
    step is one CUDA graph replay (runtime/graphs), as the JAX package jits
    it, for each k it dispatches (frames_per_step, and 1 and
    frames_per_step - 1 under split_admit). The step updates the shard's
    state in place, the cursors included, so admission (eager, with B1)
    writes where the graph reads; the readback stays outside the graph.

Tracing (utils/timing): ``enqueue`` stamps each request (event
``ptts.enqueue``, rid); a step's phases are the spans ``ptts.admit``,
``ptts.dispatch`` and ``ptts.collect`` (in it ``ptts.collect.wait``, the
readback wait), read from the same clock reads that ``phase_s`` sums; each
admit group is a ``ptts.admit_group`` span (its rids, each prompt's length,
the launched [admit_chunk, prefix_budget]) with the counters
``admit.positions`` and ``admit.launched_positions``; a stream's first
chunk on the host is the event ``ptts.first_chunk`` (rid), at the stamp of
``first_chunk_t``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import api
from ..config import FlowLMConfig
from ..models import flowlm, mimi_stream
from ..parallel import mesh as pmesh
from ..rng import frame_noise
from ..text import estimate_frames, prepare_text
from ..utils.timing import count, event, span
from .graphs import GraphCache
from .streaming import fused_stream_steps

# shared zero-length chunk: device-bound collection appends one as a
# "stream started" marker (PCM stays on the device; see _collect_counts)
_EMPTY_I16 = np.zeros(0, np.int16)
_EMPTY_I16.setflags(write=False)


def _combine_flags(wd: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """[k, B] was_done + [B] done -> one [k+1, B] bool buffer, so the
    device-bound loop reads back one tiny array per step instead of two."""
    return torch.cat([wd, done[None]])


class _PinnedPool:
    """Reusable host buffers for the batcher's copies to and from the
    device. On a CUDA device they are page-locked, so copy_(non_blocking=
    True) does not wait for the stream. A buffer handed back with the event
    of a copy that still reads it is taken again only once that event has
    completed. Used by the serving thread only."""

    def __init__(self, pin: bool):
        self.pin = pin
        self._free: Dict[tuple, List[tuple]] = {}

    def get(self, shape, dtype: torch.dtype) -> torch.Tensor:
        free = self._free.get((tuple(shape), dtype), [])
        for i, (buf, ready) in enumerate(free):
            if ready is None or ready.query():
                del free[i]
                return buf
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self.pin)

    def put(self, buf: torch.Tensor, ready: Optional[torch.cuda.Event] = None) -> None:
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append((buf, ready))


class _QueueView:
    """Deque-like view of the admission queues, one per host group; the
    server drains and clears them through this view as it does the JAX
    batcher's."""

    def __init__(self, qs: Sequence[deque]):
        self._qs = qs

    def __len__(self) -> int:
        return sum(len(q) for q in self._qs)

    def __iter__(self):
        for q in self._qs:
            yield from q

    def __bool__(self) -> bool:
        return any(self._qs)

    def popleft(self):
        for q in self._qs:
            if q:
                return q.popleft()
        raise IndexError("pop from empty queue")

    def clear(self) -> None:
        for q in self._qs:
            q.clear()

    def remove_rid(self, rid: int):
        """Remove and return the queued Request with this rid (or None).

        Tolerates concurrent mutation by the serving thread (whose _admit
        poplefts these deques without a lock): iteration raising
        RuntimeError is retried, and a remove() losing the race to a
        popleft (ValueError) reports not-found -- the caller's slot scan
        will see the request once admission lands it."""
        for q in self._qs:
            while True:
                try:
                    hit = next((r for r in q if r.rid == rid), None)
                    if hit is not None:
                        q.remove(hit)
                        return hit
                    break
                except RuntimeError:   # deque mutated during iteration
                    continue
                except ValueError:     # popped by _admit between find+remove
                    return None
        return None


class QueueFull(api.PttsError):
    """Admission queue is at max_queue; the client should back off (the
    serving front door maps this to HTTP 429)."""


@dataclasses.dataclass
class Request:
    rid: int
    prefix: Optional[np.ndarray]  # [T0, d_model] host-assembled prompt, or
    #                               None when (ids, voice_idx) carry the
    #                               prompt for device-side construction
    noise: Optional[np.ndarray]   # [max_frames, latent] host-drawn parity
    #                               noise (rng.frame_noise), or None
    #                               to draw the table on the device at admission
    max_frames: int
    eos_after: int
    # per-request generation params (every call's Params are honoured)
    num_steps: int = 1
    eos_threshold: float = 1e30   # +inf == EOS disabled for this stream
    eos_min_frames: int = 1
    # device-build admission path (admit_slots_ids): token ids + a row of
    # the batcher's voice-cond bank instead of a [T0, d] embedding matrix
    ids: Optional[np.ndarray] = None   # int32, already clamped to vocab
    voice_idx: int = -1
    # device-noise admission path (noise is None): per-request draw params;
    # same distribution as the host path (N(0, temp), clamped), another RNG,
    # so prepare() routes only seed=-1 requests here
    noise_seed: int = 0
    temp: float = 0.7
    noise_clamp: float = 0.0


@dataclasses.dataclass
class Result:
    rid: int
    pcm_i16: np.ndarray         # concatenated PCM, quantized to int16 on the device
    frames: int
    # time.perf_counter() when the stream's FIRST 80 ms chunk was collected
    # off the device (chunks are readable from batcher.chunks as each
    # collect lands them, not only at finish)
    first_chunk_t: float = -1.0

    @property
    def audio(self) -> np.ndarray:
        """f32 view (i16/32767) for numeric consumers."""
        return self.pcm_i16.astype(np.float32) / np.float32(32767.0)


def _device_noise_rows(noise_seed: Sequence[int], noise_meta: torch.Tensor,
                       frames: torch.Tensor, F: int, C: int, dtype) -> torch.Tensor:
    """Draw the per-slot noise tables on the device at admission.

    [n, F, C] rows ~ N(0, std^2) (noise_meta[0] = std, noise_meta[1] = clamp,
    clamped when > 0), rows at or past the request's frame count (``frames``
    [n]) zero; std = 0 (temp <= 0) gives all zeros, like the host path.
    Each request draws from its own generator seeded with its noise_seed, so
    its rows do not depend on the admit group it lands in."""
    dev = noise_meta.device
    z = []
    for s in noise_seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(s) & 0xFFFFFFFF)
        z.append(torch.randn(F, C, generator=gen, device=dev))
    z = torch.stack(z) * noise_meta[0][:, None, None]
    clamp = noise_meta[1][:, None, None]
    z = torch.where(clamp > 0, torch.clamp(z, -clamp, clamp), z)
    live = torch.arange(F, device=dev)[None, :, None] < frames.to(torch.int32)[:, None, None]
    return torch.where(live, z, 0.0).to(dtype)


def _select_free_rows(done: torch.Tensor, slot_mask: torch.Tensor, n_valid: int, n: int,
                      trash_row: int) -> torch.Tensor:
    """Choose up to ``n`` free pool rows ON THE DEVICE: the lowest-index rows
    where ``done & slot_mask`` (speculative admission: the host launches this
    without knowing which rows are free; the device's done flags are the
    truth, including EOS from steps whose flags the host has not read back).
    Entries past ``n_valid`` (group padding) and requests that found no free
    row map to the trash row; the host re-queues the latter when the row
    receipt arrives (ContinuousBatcher._resolve_receipt). A group wider than
    the pool (n > B1) gets its extra entries scored 0: trash."""
    B1 = done.shape[0]
    rank = (B1 - torch.arange(B1, device=done.device)).float()
    score = F.pad(torch.where(done & slot_mask, rank, 0.0), (0, max(n - B1, 0)))
    vals, rows = torch.topk(score, n)          # distinct lowest-index frees
    ok = (vals > 0) & (torch.arange(n, device=done.device) < n_valid)
    return torch.where(ok, rows, trash_row).to(torch.int32)


def _admit_core(w, cache: flowlm.KVCache, x_all, eos_step, done, frame_idx, mimi_state,
                time_embs, noise_tab, params, slot_ids, prefix, lengths, te_rows, noise_rows,
                new_params, cfg: FlowLMConfig, attn_impl: str = "auto") -> None:
    """Shared admission body: prefill n prompts (B1 kernel, or its plain
    version with ``attn_impl="plain"``), then write each one's state and
    params into pool row slot_ids[j], in place. The Mimi ring K/V and the
    shared ring cursor ``wc`` stay as they are: kpos = -1 masks every ring
    slot of a reused row until its own chunks land."""
    n, T0, _ = prefix.shape
    k_new, v_new, last, state = flowlm.prefill_state(w, prefix, lengths, cfg, attn_impl)
    rows = slot_ids.long()
    cache.k[:, :, :T0].index_copy_(1, rows, k_new.to(cache.k.dtype))
    cache.v[:, :, :T0].index_copy_(1, rows, v_new.to(cache.v.dtype))
    # a hybrid backbone's Mamba states: a reused row's state is overwritten whole
    flowlm.write_state(cache, rows, state)
    cache.prefix_len.index_copy_(0, rows, lengths.to(torch.int32))
    cache.start.index_copy_(0, rows, cache.cursor.expand(rows.shape[0]))

    x_all.index_copy_(0, rows, last.to(x_all.dtype))
    eos_step.index_fill_(0, rows, -1)
    done.index_fill_(0, rows, False)
    frame_idx.index_fill_(0, rows, 0)
    time_embs.index_copy_(0, rows, te_rows.to(time_embs.dtype))
    noise_tab.index_copy_(0, rows, noise_rows.to(noise_tab.dtype))
    # eos_threshold, eos_min_frames, eos_after, max_frames, num_steps
    for p, v in zip(params, new_params):
        p.index_copy_(0, rows, v.to(p.dtype))

    mimi_state["up"].index_fill_(0, rows, 0.0)
    mimi_state["ring"]["pos"].index_fill_(0, rows, 0)
    mimi_state["ring"]["kpos"].index_fill_(0, rows, -1)
    mimi_state["dec_in"].index_fill_(0, rows, 0.0)
    for st in mimi_state["stages"]:
        for carry in st.values():
            carry.index_fill_(0, rows, 0.0)
    mimi_state["dec_out"].index_fill_(0, rows, 0.0)


def admit_slots(w, cache: flowlm.KVCache, x_all, eos_step, done, frame_idx, mimi_state,
                time_embs, noise_tab, params,
                slot_ids: torch.Tensor,     # [n] int32 target rows (trash row for padding)
                prefix: torch.Tensor,       # [n, T0, d] back-padded prompts
                lengths: torch.Tensor,      # [n] int32
                te_rows: torch.Tensor,      # [n, S_max, flow_dim] new slots' Euler tables
                noise_rows: Optional[torch.Tensor],  # [n, F_max, latent] or None
                new_params: torch.Tensor,   # [5, n] f32 packed per-request params
                cfg: FlowLMConfig,
                noise_seed: Optional[Sequence[int]] = None,  # [n] device-noise seeds
                noise_meta: Optional[torch.Tensor] = None,   # [2, n] f32 (std, clamp)
                device_noise: bool = False, spec_select: bool = False,
                n_valid: int = 0, slot_mask: Optional[torch.Tensor] = None,
                trash_row: int = 0, attn_impl: str = "auto") -> torch.Tensor:
    """Prefill n new prompts and write their state into the pool rows.

    New prompts' K/V go to prefix columns [0, T0); their decode region
    begins at the current shared cursor (cache.start[slot] = cache.cursor).
    ``spec_select=True`` ignores ``slot_ids`` and chooses the rows on the
    device from the live ``done`` flags. Returns the rows written to."""
    if spec_select:
        slot_ids = _select_free_rows(done, slot_mask, n_valid, prefix.shape[0], trash_row)
    if device_noise:
        noise_rows = _device_noise_rows(noise_seed, noise_meta, new_params[3],
                                        noise_tab.shape[1], noise_tab.shape[2], noise_tab.dtype)
    _admit_core(w, cache, x_all, eos_step, done, frame_idx, mimi_state, time_embs, noise_tab,
                params, slot_ids, prefix, lengths, te_rows, noise_rows, new_params, cfg,
                attn_impl)
    return slot_ids


def admit_slots_ids(w, cache: flowlm.KVCache, x_all, eos_step, done, frame_idx, mimi_state,
                    time_embs, noise_tab, params,
                    slot_ids: torch.Tensor,   # [n]
                    ids: torch.Tensor,        # [n, Tt] int32 token ids (0-padded)
                    n_tokens: torch.Tensor,   # [n] int32
                    cond_idx: torch.Tensor,   # [n] int32 rows of the voice-cond bank
                    cond_bank: torch.Tensor,  # [Vcap, Tc, d] device-cached voice conds
                    cond_len: torch.Tensor,   # [Vcap] int32
                    te_rows: torch.Tensor,
                    noise_rows: Optional[torch.Tensor],
                    new_params: torch.Tensor,  # [5, n]
                    prefix_budget: int, cfg: FlowLMConfig,
                    noise_seed: Optional[Sequence[int]] = None,
                    noise_meta: Optional[torch.Tensor] = None,
                    device_noise: bool = False, spec_select: bool = False,
                    n_valid: int = 0, slot_mask: Optional[torch.Tensor] = None,
                    trash_row: int = 0, attn_impl: str = "auto") -> torch.Tensor:
    """Admission from TOKEN IDS: the prompt matrix is built on the device
    with engine._build_prefix's layout (voice-cond frames, text-embedding
    rows, projected BOS), so an admit group uploads ids and bank indices
    instead of [T0, d] prompts. ``spec_select``: see admit_slots."""
    if spec_select:
        slot_ids = _select_free_rows(done, slot_mask, n_valid, ids.shape[0], trash_row)
    n, Tt = ids.shape
    T0 = prefix_budget
    Tc = cond_bank.shape[1]
    dt = cond_bank.dtype
    cidx = cond_idx.long()

    c = cond_len[cidx]                                              # [n]
    p = torch.arange(T0, device=ids.device)[None, :]                # [1, T0]
    # cond occupies columns [0, c): bank rows are already column-aligned
    cond_part = F.pad(cond_bank[cidx], (0, 0, 0, T0 - Tc))
    # tokens occupy [c, c + t): column p reads ids[j, p - c]
    tok_col = torch.clamp(p - c[:, None], 0, Tt - 1)
    tok_part = w.embed[torch.take_along_dim(ids, tok_col, dim=1).long()].to(dt)
    # projected BOS at column c + t, accumulated in f32 like engine._build_prefix
    bos = torch.mv(w.input_linear.float(), w.bos_emb.float()).to(dt)

    col = p[:, :, None]
    ct = c[:, None, None]
    tt = (c + n_tokens)[:, None, None]
    prefix = torch.where(col < ct, cond_part,
                         torch.where(col < tt, tok_part,
                                     torch.where(col == tt, bos, torch.zeros((), dtype=dt,
                                                                             device=ids.device))))
    # B1 takes a contiguous [n] int32 lengths tensor on the device
    lengths = (c + n_tokens + 1).to(torch.int32).contiguous()

    if device_noise:
        noise_rows = _device_noise_rows(noise_seed, noise_meta, new_params[3],
                                        noise_tab.shape[1], noise_tab.shape[2], noise_tab.dtype)
    _admit_core(w, cache, x_all, eos_step, done, frame_idx, mimi_state, time_embs, noise_tab,
                params, slot_ids, prefix, lengths, te_rows, noise_rows, new_params, cfg,
                attn_impl)
    return slot_ids


@dataclasses.dataclass(eq=False)
class Shard:
    """One mesh position's part of the slot pool, all on ``device``: local
    row i is global row row0 + i; rows [0, n_slots) serve and local row
    n_slots is the shard's trash row."""

    index: int
    host: int                    # host group (dcn index)
    device: torch.device         # with an explicit index on CUDA
    fw: Any
    mw: Any
    row0: int
    n_slots: int
    cache: flowlm.KVCache
    x: torch.Tensor
    eos_step: torch.Tensor
    done: torch.Tensor
    frame_idx: torch.Tensor
    mimi_state: dict
    time_embs: torch.Tensor      # [rows, S_max, flow_dim] f32
    noise_tab: torch.Tensor      # [rows, F_max, latent]
    cond_bank: torch.Tensor      # voice bank, shared by the shards of one device
    cond_len: torch.Tensor
    params_dev: tuple = ()
    spec_mask: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.n_slots + 1

    @property
    def trash(self) -> int:
        """The trash row, local index."""
        return self.n_slots

    @property
    def slots(self) -> range:
        """The usable rows, global indices."""
        return range(self.row0, self.row0 + self.n_slots)


class ContinuousBatcher:
    """Fixed-slot continuous batching server for one device or a mesh.

    With ``mesh`` (parallel/mesh.make_mesh or make_multihost_mesh) the pool
    is split into one shard per mesh position (see the module docstring);
    the weights are replicated once per distinct device. Admission is PER
    HOST GROUP along the ``dcn`` axis: each group has its own queue and
    rows, ``submit(..., host=h)`` pins a request, and the default routes to
    the group with the least backlog. An admit group fills the free rows of
    one shard of its host group, the one with the most free rows.

    ``pipeline=True`` dispatches step N+1 before reading step N's chunks
    (the readback overlaps device work). Its outputs equal the serial
    loop's when every request is admitted at once. An admission into a
    freed slot comes one frame later than in the serial loop, so the
    stream's decode columns sit one ring column further on: frame counts
    stay equal, and the PCM may differ by the float summation order of the
    decode attention (within 1 LSB).
    Host mirrors of the done flags and per-slot params keep dispatch
    decisions sync-free; admissions landing while a frame is in flight are
    sequence-tracked so the stale frame cannot clobber a new slot's liveness.

    Admission prefills with the engine's resolved ``prefill_impl`` on every
    shard, and every step passes the engine's ``flags`` on. The decode ring
    wraps, so an engine whose flags choose the "blocked" decode attention
    (which reads [start, cursor] as one span) is refused at construction,
    as in the JAX batcher.

    On a CUDA engine with graphs on, each shard's step of each k runs
    eagerly at its first two dispatches, is captured at the third and
    replayed from then on (runtime/graphs), in capture_error_mode=
    "thread_local", so handler threads may register voices during a
    capture."""

    @torch.inference_mode()
    def __init__(self, engine, slots: int = 32, max_len: int = 512,
                 admit_chunk: int = 8, prefix_budget: int = 128,
                 max_num_steps: int = 8, pipeline: bool = False,
                 noise_budget: int = 0, mesh=None,
                 frames_per_step: int = 1, voice_cap: int = 8,
                 cond_budget: int = 0, collect_pcm: bool = True,
                 device_noise: bool = True,
                 split_admit: Optional[bool] = None,
                 max_queue: int = 0,
                 spec_admit: bool = False):
        # max_queue bounds the admission queue (0 = unbounded): enqueue()
        # raises QueueFull past it, which the server answers with HTTP 429
        self.max_queue = int(max_queue)
        # spec_admit: the admit step chooses its target rows on the device
        # from the live done flags, so the host can admit into rows it has
        # not yet learned are free; the host learns rid -> row from a tiny
        # async "receipt" readback resolved before the first step that
        # carries the new rows' flags. Requests that found no free row land
        # in the trash row and are re-queued at resolve time.
        self.spec_admit = bool(spec_admit)
        # split_admit: a step that admitted fresh requests with K > 1 runs
        # as k=1 then k=K-1 (the same frames), so fresh streams' first
        # chunks come back after one frame. Default: on when PCM is
        # collected and K > 1.
        self.split_admit = (collect_pcm and frames_per_step > 1
                            if split_admit is None else split_admit)
        # collect_pcm=False keeps the PCM on the device and reads back only
        # the done/was_done flags; Results carry frame counts, empty PCM
        self.collect_pcm = collect_pcm
        # device_noise: seed=-1 requests draw their noise tables on the
        # device at admission; explicit seeds take the host parity path so
        # fixed-seed results match the offline engine
        self.device_noise = device_noise
        self.engine = engine
        self.cfg = engine.flowlm_cfg
        self.device = engine.device
        self._on_card = self.device.type == "cuda"
        self.slots = slots
        self.n_hosts = pmesh.num_host_groups(mesh) if mesh is not None else 1
        if slots % self.n_hosts:
            raise ValueError(f"slots={slots} must divide evenly across {self.n_hosts} host groups")
        if mesh is not None and slots < mesh.size:
            # an empty shard would still run a full frame step every step
            raise ValueError(f"slots={slots} would leave shards of the {mesh.size}-position "
                             f"mesh without a slot")
        if mesh is not None and any(d.type != self.device.type for d in mesh.device_list):
            raise ValueError(f"the mesh's devices {mesh.device_list} are not of the engine's "
                             f"device type ({self.device.type})")
        self.max_len = max_len
        self.admit_chunk = admit_chunk
        # frames per dispatch: K > 1 amortizes the per-step host work over
        # K chunks per slot at up to K-1 frames (80 ms each) of extra chunk
        # latency; K=1 is the latency-optimal streaming default
        self.frames_per_step = int(frames_per_step)
        if self.frames_per_step < 1:
            raise ValueError(f"frames_per_step must be >= 1, got {frames_per_step}")
        self.prefix_budget = prefix_budget
        self.max_num_steps = max_num_steps  # pool-wide Euler table width
        # widest per-request frame count the pool accepts: sizes the
        # device-resident noise tables (each frame's row is gathered on the
        # device, so the steady-state step needs no host upload)
        self.noise_budget = noise_budget or (max_len - prefix_budget)
        if prefix_budget >= max_len:
            raise ValueError(f"prefix_budget {prefix_budget} must be < max_len {max_len}")
        # ring-safety invariant (flowlm.KVCache): a live stream's decode span
        # is bounded by its request's max_frames <= noise_budget, so no live
        # column is recycled as long as the budget fits the ring
        if self.noise_budget > max_len - prefix_budget:
            raise api.PttsError(
                f"noise_budget={self.noise_budget} exceeds the decode ring "
                f"({max_len - prefix_budget} columns): a request could "
                f"outlive its own KV columns; raise max_len")
        # the opt-in 'blocked' decode attention reads [start, cursor] as a
        # contiguous span: wrong once the ring wraps (flowlm.KVCache)
        if engine.flags.decode_impl == "blocked":
            raise api.PttsError(
                "PTTS_DECODE_IMPL=blocked assumes a non-wrapping KV cache "
                "and cannot serve the continuous batcher's decode ring; "
                "use 'auto' or 'einsum'")

        self._te_cache: Dict[int, np.ndarray] = {}  # num_steps -> padded row
        # each shard's k-frame step, captured per (shard, k) (engine.graphs)
        self._graphs = GraphCache() if engine.graphs else None
        self._pinned = _PinnedPool(self._on_card)
        # device voice-cond bank for the ids admission path: a voice's
        # conditioning frames upload ONCE per device; each request ships
        # token ids + a bank row index. Handler threads register voices
        # while the serving thread admits, hence the lock.
        self.voice_cap = voice_cap
        self.cond_budget = cond_budget or max(prefix_budget - 2, 1)
        if self.cond_budget >= prefix_budget:
            raise ValueError(f"cond_budget {self.cond_budget} must be < prefix_budget "
                             f"{prefix_budget}")
        self._voice_idx: Dict[str, int] = {}
        self._voice_frames = np.zeros(voice_cap, np.int64)   # host mirror of cond_len
        self._voice_lock = threading.Lock()
        self.shards = self._make_shards(mesh)
        B1 = self.B1 = sum(sh.rows for sh in self.shards)
        self._host_slots = [[r for sh in self.shards if sh.host == h for r in sh.slots]
                            for h in range(self.n_hosts)]
        self._host_trash = [[sh.row0 + sh.trash for sh in self.shards if sh.host == h]
                            for h in range(self.n_hosts)]
        self._trash_rows = np.array([r for rows in self._host_trash for r in rows], np.int64)
        self.slot_rows = np.array([r for rows in self._host_slots for r in rows], np.int64)

        # row-indexed; only rows in slot_rows ever hold a request
        self.slot_req: List[Optional[Request]] = [None] * B1
        self.queues: List[deque] = [deque() for _ in range(self.n_hosts)]
        self.queue = _QueueView(self.queues)
        self.chunks: Dict[int, List[np.ndarray]] = {}
        self.finished: Dict[int, Result] = {}
        # rid -> perf_counter stamp of the first collected chunk; moved onto
        # the Result at finish
        self.first_chunk_t: Dict[int, float] = {}
        self._next_rid = 0
        self._rid_lock = threading.Lock()  # prepare() runs on handler threads
        self._eos_after = np.zeros(B1, np.int32)
        self._max_frames = np.full(B1, 1, np.int32)
        self._num_steps = np.ones(B1, np.int32)
        self._eos_threshold = np.full(B1, 1e30, np.float32)
        self._eos_min_frames = np.ones(B1, np.int32)
        # device copies of the per-slot params: they change only at
        # admission, where admit_slots* write them on the device
        self._refresh_params_dev()
        # host wall time per serving phase (step() bookkeeping): "admit" is
        # admission WORK (group assembly + launches), "admit_wait" the rest
        # of the admission window (queue scans, thread hand-offs)
        self.phase_s = {"admit": 0.0, "admit_wait": 0.0, "dispatch": 0.0, "collect": 0.0}
        self._admit_work = 0.0
        self.n_admit_groups = 0
        self.n_steps = 0

        # Host MIRROR of the device done flags, lagging the device by the
        # frames in flight; everywhere it is consumed (admission, the
        # pipelined dispatch) a lagged "still running" view is safe.
        self._done_np = np.ones(B1, bool)
        self._pending: List[tuple] = []    # dispatched, not collected (FIFO)
        self._seq = 0                      # dispatch counter
        self._admit_seq = np.full(B1, -1, np.int64)
        self._slot_nframes = np.zeros(B1, np.int64)  # device-bound count
        self.pipeline = pipeline
        # spec_admit receipts, FIFO: ((host rows, event), [requests in group
        # order], tag, shard), tag = the seq of the first step dispatched
        # AFTER the admit; _collect resolves every receipt with tag <= the
        # step it collects, so the host mirrors install exactly between the
        # last pre-admit step and the first post-admit step
        if self.spec_admit and self.n_hosts > 1:
            raise api.PttsError(
                "spec_admit requires a single host group (device row "
                "selection has no per-group queue affinity)")
        self._receipts: List[tuple] = []
        self._spec_inflight = 0        # receipt requests not yet resolved
        self._spec_cancelled: set = set()
        self._finish_ema = 0.0         # finishes per collected step (EMA)

    # -- device placement ------------------------------------------------------

    def _make_shards(self, mesh) -> List[Shard]:
        """One Shard per mesh position (one on the engine's device without a
        mesh), each with its pool tensors on its own device."""
        engine, cfg, dt = self.engine, self.cfg, self.engine.dtype
        if mesh is None:
            dev = next(engine.fw.buffers()).device  # indexed, unlike engine.device
            devices, fws, mws = [dev], {dev: engine.fw}, {dev: engine.mw}
        else:
            devices = mesh.device_list
            fws, mws = pmesh.shard_weights(mesh, engine.fw), pmesh.shard_weights(mesh, engine.mw)
        per_host = len(devices) // self.n_hosts
        u = self.slots // self.n_hosts
        banks = {d: (torch.zeros(self.voice_cap, self.cond_budget, cfg.d_model, dtype=dt,
                                 device=d),
                     torch.zeros(self.voice_cap, dtype=torch.int32, device=d))
                 for d in dict.fromkeys(devices)}
        shards, row0 = [], 0
        for i, dev in enumerate(devices):
            host, p = divmod(i, per_host)
            n = u // per_host + (p < u % per_host)
            rows = n + 1
            # decode ring starts after the prefix region
            cache = flowlm.make_cache(cfg, rows, self.max_len, dt, dev)
            cache.start.fill_(self.prefix_budget)
            # the steps advance the device cursor in place; no host mirror
            cache = dataclasses.replace(
                flowlm.seek(cache, self.prefix_budget, self.prefix_budget), cursor_host=None)
            sh = Shard(
                index=i, host=host, device=dev, fw=fws[dev], mw=mws[dev], row0=row0, n_slots=n,
                cache=cache,
                x=torch.zeros(rows, cfg.d_model, dtype=dt, device=dev),
                eos_step=torch.full((rows,), -1, dtype=torch.int32, device=dev),
                done=torch.ones(rows, dtype=torch.bool, device=dev),  # all slots start free
                frame_idx=torch.zeros(rows, dtype=torch.int32, device=dev),
                mimi_state=mimi_stream.init_state(mws[dev], engine.mimi_cfg, rows, dt),
                # per-slot Euler tables: each slot carries its own num_steps grid
                time_embs=torch.zeros(rows, self.max_num_steps, cfg.flow_dim,
                                      dtype=torch.float32, device=dev),
                noise_tab=torch.zeros(rows, self.noise_budget, cfg.latent_dim, dtype=dt,
                                      device=dev),
                cond_bank=banks[dev][0], cond_len=banks[dev][1])
            if self.spec_admit:
                sh.spec_mask = torch.arange(rows, device=dev) < n
            shards.append(sh)
            row0 += rows
        return shards

    def _refresh_params_dev(self) -> None:
        """Full upload of the per-slot generation params (construction)."""
        for sh in self.shards:
            sl = slice(sh.row0, sh.row0 + sh.rows)
            sh.params_dev = tuple(
                torch.from_numpy(a[sl].copy()).to(sh.device)
                for a in (self._eos_threshold, self._eos_min_frames, self._eos_after,
                          self._max_frames, self._num_steps))

    def _upload(self, arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
        """An admit group's small host arrays (float32 or int32) -> device
        tensors of the same shapes, through ONE staging buffer and one
        non-blocking copy to ``device`` (the current device). On the card
        the buffer is pinned and goes back to the pool with the copy's
        event; a pageable upload would first wait for every frame in
        flight."""
        total = sum(a.size for a in arrays.values())
        host = (self._pinned.get((total,), torch.float32) if self._on_card
                else torch.empty(total, dtype=torch.float32))
        flat = host.numpy()
        off = 0
        for name, a in arrays.items():
            dst = flat[off : off + a.size]
            if a.dtype == np.float32:
                dst[:] = a.ravel()
            elif a.dtype == np.int32:
                dst.view(np.int32)[:] = a.ravel()
            else:
                raise TypeError(f"admission array {name!r} is {a.dtype}, not float32/int32")
            off += a.size
        if self._on_card:
            dev = host.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            self._pinned.put(host, ready)
        else:
            dev = host
        out, off = {}, 0
        for name, a in arrays.items():
            t = dev[off : off + a.size]
            out[name] = (t if a.dtype == np.float32 else t.view(torch.int32)).view(a.shape)
            off += a.size
        return out

    def _readback(self, *tensors: torch.Tensor) -> tuple:
        """Start device->host copies of ``tensors`` into pool buffers;
        returns (buffers, event). On the card the copies are non-blocking
        and the event marks their completion; on the CPU they are done."""
        bufs = []
        for t in tensors:
            buf = self._pinned.get(t.shape, t.dtype)
            buf.copy_(t, non_blocking=self._on_card)
            bufs.append(buf)
        ready = None
        if self._on_card:
            ready = torch.cuda.Event()
            ready.record()
        return bufs, ready

    def _read(self, bufs, ready) -> List[np.ndarray]:
        """Wait for a _readback's copies; numpy copies of its buffers, which
        go back to the pool."""
        if ready is not None:
            ready.synchronize()
        out = [b.numpy().copy() for b in bufs]
        for b in bufs:
            self._pinned.put(b)
        return out

    @torch.inference_mode()
    def register_voice(self, name: str, cond: Optional[np.ndarray]) -> int:
        """Cache a voice's conditioning frames in the device bank; returns the
        bank row, or -1 if the bank is full / the cond doesn't fit (callers
        fall back to the host-assembled prefix path). Thread-safe."""
        with self._voice_lock:
            idx = self._voice_idx.get(name)
            if idx is not None:
                return idx
            n = 0 if cond is None else len(cond)
            if len(self._voice_idx) >= self.voice_cap or n > self.cond_budget:
                return -1
            idx = len(self._voice_idx)
            if n:
                row = np.zeros((self.cond_budget, self.cfg.d_model), np.float32)
                row[:n] = cond
            for sh in {id(sh.cond_bank): sh for sh in self.shards}.values():  # one per device
                if n:
                    sh.cond_bank[idx].copy_(torch.from_numpy(row))
                sh.cond_len[idx] = n
            self._voice_frames[idx] = n
            self._voice_idx[name] = idx
            return idx

    # -- submission ----------------------------------------------------------

    def prepare(self, text: str, voice: Optional[str] = None,
                params: Optional[api.Params] = None) -> Request:
        """Tokenize + assemble a Request WITHOUT touching the serving queue.

        The host-heavy work (text prep, tokenization, prefix embedding,
        noise draw) happens here, so HTTP handler threads run it outside the
        serving lock (runtime/server.py); only enqueue() needs the lock. The
        rid is taken under its own lock (noise is seeded seed + rid, as the
        offline engine seeds stream i with seed + i)."""
        p = (params or api.Params()).normalized()
        if p.num_steps > self.max_num_steps:
            raise api.PttsError(
                f"num_steps {p.num_steps} > pool max_num_steps "
                f"{self.max_num_steps} (raise it at construction)")
        prepared, wc, eos_after_guess = prepare_text(text)
        ids = self.engine.ctx.tokenize(prepared)
        cond, _ = self.engine._voice_cond(voice)
        # ids admission path: token ids + a voice-bank row instead of a
        # host-assembled [T0, d] matrix (admit_slots_ids builds it on the
        # device); the host prefix when the bank is full
        vidx = self.register_voice(voice or "alba", cond)
        n_cond = 0 if cond is None else len(cond)
        prefix = None
        ids_np = None
        if vidx >= 0 and len(ids) <= self.prefix_budget:
            v = self.cfg.vocab + 1
            ids_np = np.asarray(ids, np.int64)
            ids_np = np.where((ids_np < 0) | (ids_np >= v), 0, ids_np).astype(np.int32)
            need = n_cond + len(ids_np) + 1
        else:
            prefix = self.engine._build_prefix(ids, cond)
            need = len(prefix)
        if need > self.prefix_budget:
            raise api.PttsError(
                f"prompt needs {need} prefix columns > budget {self.prefix_budget}")
        max_frames = p.num_frames if p.num_frames > 0 else estimate_frames(wc)
        if max_frames > self.noise_budget:
            raise api.PttsError(
                f"request needs {max_frames} frames > pool noise_budget "
                f"{self.noise_budget} (raise it at construction)")
        seed = p.seed if p.seed != -1 else int(time.time())
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        # explicit seed -> host parity noise (the offline engine's seed+rid
        # stream); seed=-1 + device_noise -> drawn on the device at admission
        if self.device_noise and p.seed == -1:
            noise = None
        else:
            noise = frame_noise(seed + rid, max_frames, self.cfg.latent_dim,
                                temp=p.temp, noise_clamp=p.noise_clamp)
        return Request(
            rid=rid,
            prefix=prefix,
            noise=noise,
            noise_seed=(seed + rid) & 0xFFFFFFFF,
            temp=p.temp,
            noise_clamp=p.noise_clamp,
            max_frames=max_frames,
            eos_after=p.eos_after if p.eos_after > 0 else eos_after_guess,
            num_steps=p.num_steps,
            eos_threshold=(p.eos_threshold if p.eos_enabled else np.float32(1e30)),
            eos_min_frames=p.eos_min_frames,
            ids=ids_np,
            voice_idx=vidx,
        )

    def _route_host(self) -> int:
        """The host group with the least backlog (queued minus free rows);
        ties go to the lowest index."""
        if self.n_hosts == 1:
            return 0

        def backlog(h: int) -> int:
            free = sum(1 for s in self._host_slots[h] if self.slot_req[s] is None)
            return len(self.queues[h]) - free

        return min(range(self.n_hosts), key=lambda h: (backlog(h), h))

    def enqueue(self, req: Request, host: Optional[int] = None) -> int:
        """Queue a prepared Request for admission (cheap; lock-holding ok).

        ``host`` pins the request to one host group's rows (multi-host
        mesh); the default routes it with _route_host.

        The ring-safety invariant is checked HERE too, not only in
        prepare(): a directly enqueued over-budget request would otherwise
        recycle live decode-ring columns mid-stream."""
        if host is not None and not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} is not one of the pool's {self.n_hosts} host groups")
        if req.max_frames > self.noise_budget:
            raise api.PttsError(
                f"request rid={req.rid} needs {req.max_frames} frames > pool "
                f"noise_budget {self.noise_budget} (raise it at construction)")
        if req.noise is not None and len(req.noise) < req.max_frames:
            raise api.PttsError(
                f"request rid={req.rid} carries {len(req.noise)} noise rows "
                f"< max_frames {req.max_frames}: the tail frames would "
                f"integrate zero noise")
        if req.num_steps > self.max_num_steps:
            raise api.PttsError(
                f"request rid={req.rid} num_steps {req.num_steps} > pool "
                f"max_num_steps {self.max_num_steps}")
        if self.max_queue and len(self.queue) >= self.max_queue:
            raise QueueFull(f"admission queue full ({self.max_queue} requests); retry later")
        self.queues[self._route_host() if host is None else host].append(req)
        self.chunks[req.rid] = []
        event("ptts.enqueue", rid=req.rid)
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Abandon a request wherever it is: queued (dequeued), in a slot
        (the slot is freed for the next admission), in an unresolved
        spec_admit receipt (marked), or finished-unclaimed (the Result is
        dropped). Returns False if the rid is unknown.

        Host bookkeeping only. A cancelled slot's row keeps computing in
        steps until its own max_frames, like an early-EOS row, but the slot
        is re-admittable at once: the next admission overwrites its state.
        Safe to call from another thread while the serving thread is inside
        step(): the writes are container/array-scalar updates, _collect
        re-reads chunks via .get, and the _admit_seq bump keeps frames
        dispatched before the cancel from reviving the host done mirror. A
        device EOS collected in the same step window may still publish a
        Result, which ages out through the server's result TTL."""
        deadline = time.perf_counter() + 0.05
        while True:
            req = self.queue.remove_rid(rid)
            if req is not None:
                self.chunks.pop(rid, None)
                self.first_chunk_t.pop(rid, None)
                return True
            for slot in self.slot_rows:
                r = self.slot_req[slot]
                if r is not None and r.rid == rid:
                    self.slot_req[slot] = None
                    self._done_np[slot] = True
                    # frames dispatched before now must not revive the mirror
                    self._admit_seq[slot] = self._seq
                    self._slot_nframes[slot] = 0
                    self.chunks.pop(rid, None)
                    self.first_chunk_t.pop(rid, None)
                    return True
            # in an unresolved receipt: resolution skips the install (the
            # device row, if one was chosen, runs to its own max_frames
            # unobserved and frees itself)
            for rec in list(self._receipts):
                if any(r.rid == rid for r in rec[1]):
                    if rid not in self._spec_cancelled:
                        self._spec_cancelled.add(rid)
                        self.chunks.pop(rid, None)
                        self.first_chunk_t.pop(rid, None)
                        return True
                    return False  # already cancelled
            if self.finished.pop(rid, None) is not None:
                self.chunks.pop(rid, None)
                self.first_chunk_t.pop(rid, None)
                return True
            # a chunks entry with no queue/slot/finished hit: the rid is
            # mid-admission on the serving thread (between its queue pop and
            # its slot_req write); spin briefly until it lands in a slot
            if rid not in self.chunks or time.perf_counter() > deadline:
                return False
            time.sleep(0.0005)

    def submit(self, text: str, voice: Optional[str] = None,
               params: Optional[api.Params] = None, host: Optional[int] = None) -> int:
        return self.enqueue(self.prepare(text, voice=voice, params=params), host=host)

    @torch.inference_mode()
    def _te_row(self, num_steps: int) -> np.ndarray:
        """[S_max, flow_dim] Euler table for num_steps, zero-padded (host,
        cached per step count)."""
        row = self._te_cache.get(num_steps)
        if row is None:
            te = flowlm.lsd_time_embeds(self.engine.fw, num_steps, self.cfg)
            row = np.zeros((self.max_num_steps, self.cfg.flow_dim), np.float32)
            row[:num_steps] = te.float().cpu().numpy()
            self._te_cache[num_steps] = row
        return row

    # -- serving loop ----------------------------------------------------------

    @torch.inference_mode()
    def _admit(self) -> int:
        """Admit queued requests into free slots, admit_chunk at a time, host
        group by host group; each group fills the free rows of the host
        group's shard with the most free rows (ties: the lowest index).
        Returns how many were admitted (step() splits the next dispatch
        when fresh streams are aboard -- see split_admit). No host wait:
        the frame step is ordered after the admission on the stream."""
        if self.spec_admit:
            return self._admit_spec()
        admitted = 0
        work = 0.0  # admission work, for phase_s
        for h, q in enumerate(self.queues):
            if not q:
                continue
            free = {sh.index: [s for s in sh.slots if self.slot_req[s] is None]
                    for sh in self.shards if sh.host == h}
            while q:
                sh = self.shards[max(free, key=lambda i: (len(free[i]), -i))]
                rows = free[sh.index]
                if not rows:
                    break
                group: List[Tuple[int, Request]] = []
                while rows and q and len(group) < self.admit_chunk:
                    group.append((rows.pop(0), q.popleft()))
                work += self._admit_group(group, sh)
                admitted += len(group)
        self._admit_work += work
        return admitted

    def _prompt_len(self, req: Request) -> int:
        """The prompt's positions as admission builds it: voice frames + ids
        + 1 (admit_slots_ids), or the host prefix's rows."""
        if req.ids is None:
            return len(req.prefix)
        return int(self._voice_frames[req.voice_idx]) + len(req.ids) + 1

    def _admit_group(self, group: List[Tuple[Optional[int], Request]], shard: Shard,
                     spec: bool = False) -> float:
        """Admit one group into ``shard``, on its device; returns the
        seconds of its span (ptts.admit_group), which phase_s sums. If the
        admission raises, the group's requests that it left in neither a
        slot nor a receipt go back to the front of their queue before the
        error propagates, so the caller (the server's _on_step_error) can
        fail them instead of losing them."""
        lengths = tuple(self._prompt_len(req) for _, req in group)
        try:
            with span("ptts.admit_group", rids=tuple(req.rid for _, req in group),
                      lengths=lengths, shape=(self.admit_chunk, self.prefix_budget)) as g, \
                    pmesh.on_device(shard.device):
                count("admit.positions", sum(lengths))
                self._admit_variants(group, shard, spec)
        except BaseException:
            held = {id(r) for r in self.slot_req if r is not None}
            held.update(id(r) for rec in self._receipts for r in rec[1])
            for _, req in reversed(group):
                if id(req) not in held:
                    self.queues[shard.host].appendleft(req)
            raise
        return g.t1 - g.t0

    def _admit_spec(self) -> int:
        """Speculative admission: launch admissions whose target rows are
        chosen on the device, budgeted past the host's lagged free count by
        the recent finish rate -- that overshoot lets rows freed in the
        still-uncollected window refill for the next window. Overshoot that
        finds no free row lands in the trash row and is re-queued when the
        receipt resolves. Each group goes to the shard with the most known
        free rows not yet claimed by an unresolved receipt."""
        q = self.queues[0]
        if not q:
            return 0
        free = {sh.index: sum(1 for s in sh.slots if self.slot_req[s] is None)
                for sh in self.shards}
        for rec in self._receipts:
            free[rec[3].index] -= len(rec[1])
        budget = sum(free.values()) + int(np.ceil(self._finish_ema * 1.5))
        budget = min(budget, len(q))
        admitted = 0
        work = 0.0
        while budget > 0 and q:
            take = min(self.admit_chunk, budget, len(q))
            sh = self.shards[max(free, key=lambda i: (free[i], -i))]
            group = [(None, q.popleft()) for _ in range(take)]
            work += self._admit_group(group, sh, spec=True)
            self._spec_inflight += take
            free[sh.index] -= take
            admitted += take
            budget -= take
        self._admit_work += work
        return admitted

    def _admit_variants(self, group: List[Tuple[Optional[int], Request]], shard: Shard,
                        spec: bool) -> None:
        # one admission per variant present: (prompt as ids vs host prefix)
        # x (noise drawn on the device vs host parity rows). Serving traffic
        # is uniform (seed=-1 ids requests); host-noise rows are for parity
        for by_ids in (True, False):
            for dev_noise in (True, False):
                sub = [g for g in group
                       if (g[1].ids is not None) == by_ids and (g[1].noise is None) == dev_noise]
                if not sub:
                    continue
                if by_ids:
                    self._admit_group_ids(sub, shard, dev_noise, spec)
                else:
                    self._admit_group_prefix(sub, shard, dev_noise, spec)

    def _admit_bookkeep(self, group, shard: Shard, dev_noise: bool):
        """Shared per-group host bookkeeping; returns the padded admission
        arrays every path uploads (the shard's local rows, Euler tables,
        noise, params) and the device-noise seeds (a host list; None on the
        host-noise path)."""
        n = self.admit_chunk
        slot_ids = np.full(n, shard.trash, np.int32)
        te_rows = np.zeros((n, self.max_num_steps, self.cfg.flow_dim), np.float32)
        seeds = None
        if dev_noise:
            seeds = [0] * n
            noise = {"noise_meta": np.zeros((2, n), np.float32)}
        else:
            noise = {"noise_rows": np.zeros((n, self.noise_budget, self.cfg.latent_dim),
                                            np.float32)}
        # packed [5, n] f32 (ints < 2^24 are exact): one array, one copy;
        # padding retires after one frame (max_frames = 1)
        new_params = np.zeros((5, n), np.float32)
        new_params[0] = 1e30
        new_params[1] = 1
        new_params[3] = 1
        new_params[4] = 1
        for j, (slot, req) in enumerate(group):
            te_rows[j] = self._te_row(req.num_steps)
            if dev_noise:
                seeds[j] = req.noise_seed & 0xFFFFFFFF
                noise["noise_meta"][0, j] = np.sqrt(np.float32(req.temp)) if req.temp > 0 else 0.0
                noise["noise_meta"][1, j] = req.noise_clamp
            else:
                noise["noise_rows"][j, : len(req.noise)] = req.noise
            new_params[:, j] = (req.eos_threshold, req.eos_min_frames, req.eos_after,
                                req.max_frames, req.num_steps)
            if slot is None:  # spec_admit: the device picks the row; host
                continue      # mirrors install at receipt-resolve time
            slot_ids[j] = slot - shard.row0
            self._install_slot(slot, req, self._seq)
        self.n_admit_groups += 1
        return dict(slot_ids=slot_ids, te_rows=te_rows, new_params=new_params, **noise), seeds

    def _install_slot(self, slot: int, req: Request, admit_seq: int) -> None:
        """Host mirrors for a newly admitted request: the slot becomes live
        for every dispatch with seq >= admit_seq."""
        self.slot_req[slot] = req
        self._eos_after[slot] = req.eos_after
        self._max_frames[slot] = req.max_frames
        self._num_steps[slot] = req.num_steps
        self._eos_threshold[slot] = req.eos_threshold
        self._eos_min_frames[slot] = req.eos_min_frames
        self._done_np[slot] = False
        self._admit_seq[slot] = admit_seq
        self._slot_nframes[slot] = 0

    def _admit_kwargs(self, up: Dict[str, torch.Tensor], seeds, n_valid: int, shard: Shard,
                      spec: bool) -> Dict[str, Any]:
        """The admit function's noise-variant and spec_select arguments."""
        if seeds is None:
            kw = {"noise_rows": up["noise_rows"], "device_noise": False}
        else:
            kw = {"noise_rows": None, "noise_seed": seeds, "noise_meta": up["noise_meta"],
                  "device_noise": True}
        if spec:
            kw.update(spec_select=True, n_valid=n_valid, slot_mask=shard.spec_mask,
                      trash_row=shard.trash)
        return kw

    def _push_receipt(self, rows_dev: torch.Tensor, group, shard: Shard) -> None:
        """Record a speculative admission's device-chosen rows (local to
        ``shard``) for later resolution (tag = the seq of the first step
        dispatched after it)."""
        self._receipts.append((self._readback(rows_dev), [req for _, req in group], self._seq,
                               shard))

    def _admit_group_prefix(self, group, shard: Shard, dev_noise: bool, spec: bool) -> None:
        n = self.admit_chunk
        count("admit.launched_positions", n * self.prefix_budget)
        arrays, seeds = self._admit_bookkeep(group, shard, dev_noise)
        prefix = np.zeros((n, self.prefix_budget, self.cfg.d_model), np.float32)
        lengths = np.ones(n, np.int32)
        for j, (_, req) in enumerate(group):
            prefix[j, : len(req.prefix)] = req.prefix
            lengths[j] = len(req.prefix)
        up = self._upload(dict(arrays, prefix=prefix, lengths=lengths), shard.device)
        rows = admit_slots(
            shard.fw, shard.cache, shard.x, shard.eos_step, shard.done, shard.frame_idx,
            shard.mimi_state, shard.time_embs, shard.noise_tab, shard.params_dev,
            up["slot_ids"], up["prefix"].to(self.engine.dtype), up["lengths"], up["te_rows"],
            new_params=up["new_params"], cfg=self.cfg, attn_impl=self.engine.prefill_impl,
            **self._admit_kwargs(up, seeds, len(group), shard, spec))
        if spec:
            self._push_receipt(rows, group, shard)

    def _admit_group_ids(self, group, shard: Shard, dev_noise: bool, spec: bool) -> None:
        n = self.admit_chunk
        count("admit.launched_positions", n * self.prefix_budget)
        arrays, seeds = self._admit_bookkeep(group, shard, dev_noise)
        ids = np.zeros((n, self.prefix_budget), np.int32)
        n_tokens = np.zeros(n, np.int32)
        cond_idx = np.zeros(n, np.int32)
        for j, (_, req) in enumerate(group):
            ids[j, : len(req.ids)] = req.ids
            n_tokens[j] = len(req.ids)
            cond_idx[j] = req.voice_idx
        up = self._upload(dict(arrays, ids=ids, n_tokens=n_tokens, cond_idx=cond_idx),
                          shard.device)
        rows = admit_slots_ids(
            shard.fw, shard.cache, shard.x, shard.eos_step, shard.done, shard.frame_idx,
            shard.mimi_state, shard.time_embs, shard.noise_tab, shard.params_dev,
            up["slot_ids"], up["ids"], up["n_tokens"], up["cond_idx"], shard.cond_bank,
            shard.cond_len, up["te_rows"], new_params=up["new_params"],
            prefix_budget=self.prefix_budget, cfg=self.cfg, attn_impl=self.engine.prefill_impl,
            **self._admit_kwargs(up, seeds, len(group), shard, spec))
        if spec:
            self._push_receipt(rows, group, shard)

    # -- double-buffered frame machinery --------------------------------------
    #
    # step() dispatches frame N+1 to the device BEFORE reading frame N's
    # chunks (pipeline=True), so the readback overlaps device work. The host
    # mirrors carry everything dispatch decisions need; admissions that land
    # between a frame's dispatch and its collection are sequence-tracked.

    @torch.inference_mode()
    def _dispatch(self, k: Optional[int] = None) -> None:
        """Launch one k-frame pool step on every shard, each on its own
        device's current stream, and start every shard's readback; nothing
        here waits. ``k`` defaults to the pool cadence (frames_per_step)."""
        if k is None:
            k = self.frames_per_step
        rbs = []
        for sh in self.shards:
            with pmesh.on_device(sh.device):
                rbs.append(self._dispatch_shard(sh, k))
        self._pending.append((rbs, self._seq))
        self._seq += 1

    def _dispatch_shard(self, sh: Shard, k: int) -> tuple:
        """One shard's k-frame step (a graph replay with graphs on) and its
        readback (buffers, event), which stays outside the graph and follows
        the replay on the stream."""
        if self._graphs is None:
            out = self._shard_step(sh, k)
        else:
            out = self._graphs.run((sh.index, k), sh.device, lambda: self._shard_step(sh, k))
        return self._readback(*out)

    def _shard_step(self, sh: Shard, k: int) -> tuple:
        """One shard's k-frame step, its state updated in place; returns the
        tensors to read back."""
        mcfg = self.engine.mimi_cfg
        # per-slot params written at admission; "EOS disabled" is 1e30
        eos_threshold, eos_min_frames, eos_after, max_frames, num_steps = sh.params_dev
        # pcm [k, B, S + 2]: int16 chunks with the flag columns; wd [k, B]
        # the per-frame pre-step done (a chunk is live iff not done pre-step)
        (_, _, x, pcm, _, eos_step, done, wd, frame_idx) = fused_stream_steps(
            sh.fw, sh.mw, sh.cache, sh.mimi_state, sh.x, sh.noise_tab, sh.time_embs,
            sh.frame_idx, sh.eos_step, sh.done, self.cfg, mcfg, True, eos_threshold,
            eos_min_frames, eos_after, max_frames, num_steps, k=k, flags=self.engine.flags)
        for dst, src in ((sh.x, x), (sh.eos_step, eos_step), (sh.done, done),
                         (sh.frame_idx, frame_idx)):
            dst.copy_(src)
        return (pcm,) if self.collect_pcm else (_combine_flags(wd, done),)

    def _read_step(self, rbs) -> List[np.ndarray]:
        """Wait for one step's readbacks, shard by shard; the host arrays
        with the shards' rows joined in global row order (rows are the last
        axis of a bool flag array, the second last of an int16 PCM one)."""
        parts = [self._read(bufs, ready) for bufs, ready in rbs]
        if len(parts) == 1:
            return parts[0]
        return [np.concatenate(xs, axis=-1 if xs[0].dtype == np.bool_ else -2)
                for xs in zip(*parts)]

    def _dispatch_step(self, fresh: int) -> None:
        """Dispatch one pool step of frames_per_step frames -- as one
        K-frame launch sequence, or (split_admit, when ``fresh`` requests
        were just admitted) as k=1 then k=K-1, so the fresh streams' first
        chunks come back after one frame instead of K. The same frame body
        runs in the same order either way."""
        k = self.frames_per_step
        if fresh and k > 1 and self.split_admit:
            self._dispatch(1)
            self._dispatch(k - 1)
        else:
            self._dispatch(k)

    def _resolve_receipt(self, rec) -> None:
        """Install a speculative admission's device-chosen rows into the host
        mirrors. Called in dispatch order: after collecting every step that
        ran before the admit, before collecting the first step after it.
        Requests the device put in the trash row (no free row when the
        admission ran) re-enter the FRONT of the queue."""
        (bufs, ready), reqs, tag, shard = rec
        rows = self._read(bufs, ready)[0]
        requeue = []
        for j, req in enumerate(reqs):
            self._spec_inflight -= 1
            if req.rid in self._spec_cancelled:
                # cancelled while in flight: an installed row burns to its
                # own max_frames unobserved (host keeps slot_req[row] None)
                self._spec_cancelled.discard(req.rid)
                continue
            row = int(rows[j])  # local to the shard
            if row == shard.trash:
                requeue.append(req)
            else:
                self._install_slot(shard.row0 + row, req, tag)
        q = self.queues[shard.host]
        for req in reversed(requeue):
            q.appendleft(req)

    def _collect(self, pend) -> int:
        """Read an in-flight step's chunk(s); finalize finished requests."""
        rbs, seq = pend
        # speculative admits dispatched before this step: their rows are
        # live in this step's flags -- install them first
        while self._receipts and self._receipts[0][2] <= seq:
            self._resolve_receipt(self._receipts.pop(0))
        with span("ptts.collect.wait") as wait:
            host = self._read_step(rbs)
        t0, t_pcm = wait.t0, wait.t1
        if not self.collect_pcm:
            # device-bound: one [k+1, B] flag readback; PCM stays on the device
            self.phase_s["c_wait"] = self.phase_s.get("c_wait", 0.0) + (t_pcm - t0)
            fl = host[0]
            was_done = fl[:-1]                             # [k, B]
            done_np = fl[-1]                               # [B] post-step
        else:
            self.phase_s["c_pcm"] = self.phase_s.get("c_pcm", 0.0) + (t_pcm - t0)
            raw = host[0]                                  # [k, B, S + 2]
            pcm_np = raw[:, :, :-2]
            was_done = raw[:, :, -2] != 0                  # [k, B]
            done_np = raw[-1, :, -1] != 0                  # [B] post-step
        # slots admitted AFTER this step was dispatched keep their mirror
        # (the step predates them); the trash row is never live on the host
        fresh = self._admit_seq > seq
        self._done_np = np.where(fresh, self._done_np, done_np)
        self._done_np[self._trash_rows] = True
        if not self.collect_pcm:
            return self._collect_counts(done_np, was_done, fresh)
        n_pub = 0
        for slot in self.slot_rows:
            req = self.slot_req[slot]
            if req is None or fresh[slot]:
                continue
            # .get: a concurrent cancel() may have popped the buffer between
            # the slot_req read above and here -- skip, the slot is gone
            parts = self.chunks.get(req.rid)
            if parts is None:
                continue
            had = bool(parts)
            for j in range(pcm_np.shape[0]):
                if not was_done[j, slot]:
                    parts.append(pcm_np[j, slot])
            if not had and parts:
                self.first_chunk_t[req.rid] = t_pcm
                event("ptts.first_chunk", t_pcm, rid=req.rid)
            if done_np[slot]:
                parts = self.chunks.pop(req.rid, parts)
                self.finished[req.rid] = Result(
                    rid=req.rid,
                    pcm_i16=np.concatenate(parts) if parts else np.zeros(0, np.int16),
                    frames=len(parts),
                    first_chunk_t=self.first_chunk_t.pop(req.rid, -1.0),
                )
                self.slot_req[slot] = None
                n_pub += 1
        self._finish_ema = 0.8 * self._finish_ema + 0.2 * n_pub
        return sum(1 for s in self.slot_req if s is not None)

    def _collect_counts(self, done_np, was_done, fresh) -> int:
        """Device-bound collect: the PCM never left the device, so per-slot
        chunk routing reduces to vectorized frame counting."""
        live = np.fromiter((r is not None for r in self.slot_req), bool, len(self.slot_req))
        act = live & ~fresh
        emit = np.where(act, (~was_done).sum(axis=0), 0)  # frames this step
        started = act & (self._slot_nframes == 0) & (emit > 0)
        self._slot_nframes += emit
        t_now = time.perf_counter()
        for slot in np.nonzero(started)[0]:
            # placeholder so first-chunk trackers see the stream start
            req = self.slot_req[slot]
            parts = None if req is None else self.chunks.get(req.rid)
            if parts is None:  # concurrently cancelled
                continue
            parts.append(_EMPTY_I16)
            self.first_chunk_t[req.rid] = t_now
            event("ptts.first_chunk", t_now, rid=req.rid)
        for slot in np.nonzero(act & done_np)[0]:
            req = self.slot_req[slot]
            if req is None:  # concurrently cancelled
                continue
            n = int(self._slot_nframes[slot])
            self._slot_nframes[slot] = 0
            self.chunks.pop(req.rid, None)
            self.finished[req.rid] = Result(
                rid=req.rid, pcm_i16=np.zeros(0, np.int16), frames=n,
                first_chunk_t=self.first_chunk_t.pop(req.rid, -1.0))
            self.slot_req[slot] = None
        self._finish_ema = 0.8 * self._finish_ema + 0.2 * int((act & done_np).sum())
        return int(live.sum() - (act & done_np).sum())

    @torch.inference_mode()
    def step(self) -> int:
        """Admit + collect one pool step. Returns #active streams. Its
        phases are the spans ptts.admit, ptts.dispatch and ptts.collect;
        phase_s sums the same clock reads."""
        self.n_steps += 1
        self._admit_work = 0.0
        if self._pending and not self._receipts and all(r is None for r in self.slot_req):
            pend, self._pending = self._pending, []
            for p in pend:
                self._collect(p)  # flush stale speculative frames
        with span("ptts.admit") as admit:
            fresh = self._admit()
            if (self._receipts and not self._pending
                    and not any(r is not None for r in self.slot_req)):
                # nothing in flight to carry the receipts forward: resolve them
                # now (waiting on the tiny rows copy) so their requests go live
                # or re-queue, then admit again
                while self._receipts:
                    self._resolve_receipt(self._receipts.pop(0))
                fresh += self._admit()
        t0, t1 = admit.t0, admit.t1
        if not self._pending and not any(r is not None for r in self.slot_req):
            self.phase_s["admit"] += self._admit_work
            self.phase_s["admit_wait"] += (t1 - t0) - self._admit_work
            return 0
        with span("ptts.dispatch") as dispatch:
            if not self._pending:
                self._dispatch_step(fresh)
                fresh = 0  # this dispatch already carries the fresh streams
            pend, self._pending = self._pending, []
            if self.pipeline and (self._spec_inflight > 0
                                  or not self._done_np[self.slot_rows].all()):
                # speculative next step: overlaps the readback in _collect()
                self._dispatch_step(fresh)
        t2 = dispatch.t1
        out = 0
        with span("ptts.collect") as collect:
            for p in pend:  # FIFO: _done_np mirrors stay in dispatch order
                out = self._collect(p)
        t3 = collect.t1
        self.phase_s["admit"] += self._admit_work
        self.phase_s["admit_wait"] += (t1 - t0) - self._admit_work
        self.phase_s["dispatch"] += t2 - t1
        self.phase_s["collect"] += t3 - t2
        return out

    def drain(self, max_steps: int = 100000) -> Dict[int, Result]:
        steps = 0
        while self.queue or self._receipts or any(r is not None for r in self.slot_req):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("continuous batcher failed to drain")
        if self._pending:
            pend, self._pending = self._pending, []
            for p in pend:
                self._collect(p)  # retire the trailing speculative frames
        return self.finished
