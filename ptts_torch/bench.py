"""Serving benchmark of the port: concurrent real-time 24 kHz streams per GPU
(port of the repository's root bench.py).

    python -m ptts_torch.bench        # on a machine with a CUDA card

Runs the full offline pipeline (prefill -> per-frame FlowLM loop -> latent
scaling -> Mimi vocoder) for B independent streams on one card and reports

    streams = B * generated_audio_seconds / wall_seconds

then the continuous batcher's closed-loop legs, the batcher fed through
``prepare()`` on four threads, and the HTTP front door
(ptts_torch.tools.bench_http, in a subprocess). Prints ONE JSON line:

    {"metric": "concurrent_realtime_streams", "value": N, "unit": "streams/chip",
     "detail": {..., "device": {"name", "power_limit_w", "count"}, "failed_legs": {}}}

A leg that raises is recorded under ``detail.failed_legs`` with its error;
the line is still printed and the process then exits non-zero. With no CUDA
card visible, main() prints no result and exits non-zero: there is no CPU
path. Each leg function takes ``device`` (default "cuda"), ``flowlm_cfg`` and
``mimi_cfg`` (default full width) keywords, so the tests run the same code at
tiny size on the CPU.

Env knobs (defaults): PTTS_BENCH_BATCH (256), PTTS_BENCH_FRAMES (50),
PTTS_BENCH_DTYPE (f32|bf16, bf16), PTTS_BENCH_REPEATS (3),
PTTS_BENCH_BATCHER_SLOTS (the offline batch), PTTS_BENCH_BATCHER_REQS (1200),
PTTS_BENCH_FPS (8), PTTS_BENCH_DEVICE_SLOTS (384), PTTS_BENCH_PREPARED (1),
PTTS_BENCH_HTTP (1), PTTS_BENCH_MODEL_DIR (the synthetic checkpoint; default
a directory in the temp directory keyed by the configs),
PTTS_BENCH_WARMUP_STEPS (12: the batcher legs' untimed steps). PTTS_DTYPE
(default bf16) sets the engine dtype of the prepared and HTTP legs, as in
bench.py. ``detail.leg_s`` holds each leg's wall seconds, set-up included.
On the card every frame loop replays CUDA graphs (runtime/graphs) and
``detail.graphs`` says so; their capture falls inside each leg's first pass
(the offline leg's ``compile_s``, the batcher legs' warm-up steps).

Weights: a seeded synthetic checkpoint (ptts_torch.synth, scale 0.02),
written once into PTTS_BENCH_MODEL_DIR and loaded through the engine's path
(flowlm/mimi.load_weights, then the packed upload of to_device).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
from typing import Optional

import numpy as np
import torch

from . import api, synth
from .config import FlowLMConfig, KernelFlags, MimiConfig
from .io.safetensors import SafetensorsFile
from .models import flowlm, mimi
from .ops.cuda import build
from .ops.cuda import fused_attention as fa
from .runtime.graphs import GraphCache

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
T0 = 64             # prompt columns: voice cond (~30) + tokens (~30) + BOS
SYNTH_SCALE = 0.02  # the scale of the JAX package's flowlm.random_weights
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configs(flowlm_cfg: Optional[FlowLMConfig] = None,
            mimi_cfg: Optional[MimiConfig] = None):
    """The given configs, full width where None."""
    return flowlm_cfg or FlowLMConfig(), mimi_cfg or MimiConfig()


def bench_model_dir(flowlm_cfg: FlowLMConfig, mimi_cfg: MimiConfig) -> str:
    """PTTS_BENCH_MODEL_DIR, or a directory in the temp directory named after
    the configs; a synthetic checkpoint at these widths is written there
    first if it holds none (into a sibling, then renamed, so a reader never
    sees half a file)."""
    path = os.environ.get("PTTS_BENCH_MODEL_DIR")
    if not path:
        key = hashlib.sha1(repr((flowlm_cfg, mimi_cfg, SYNTH_SCALE)).encode()).hexdigest()[:12]
        path = os.path.join(tempfile.gettempdir(), f"ptts_torch_bench_{key}")
    weights = os.path.join(path, synth.WEIGHTS_NAME)
    if not os.path.isfile(weights):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".ptts_bench_", dir=parent)
        synth.write_model_dir(tmp, flowlm_cfg, mimi_cfg, seed=0, scale=SYNTH_SCALE)
        try:
            os.rename(tmp, path)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # another process wrote it first
        if not os.path.isfile(weights):
            raise api.PttsError(f"{path} holds no {synth.WEIGHTS_NAME} and could not be written")
    return path


@contextlib.contextmanager
def host_weights(dtype: torch.dtype, flowlm_cfg: FlowLMConfig, mimi_cfg: MimiConfig):
    """Yields the host weight dicts (fw, mw) of the bench checkpoint, read as
    the engine reads them (FlowLM straight to bf16 for a bf16 run). Upload
    them inside the ``with``: bf16 leaves may be views of the mmap."""
    path = os.path.join(bench_model_dir(flowlm_cfg, mimi_cfg), synth.WEIGHTS_NAME)
    with SafetensorsFile(path) as st:
        yield (flowlm.load_weights(st, flowlm_cfg, dtype=dtype),
               mimi.load_weights(st, mimi_cfg))


def no_tf32(dtype: torch.dtype) -> None:
    """In f32, turn TF32 off as the engine does (the SEANet convs and the
    GEMMs then run in f32)."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def device_weights(dtype: torch.dtype, device, flowlm_cfg: FlowLMConfig, mimi_cfg: MimiConfig):
    """(fw, mw) on ``device`` through the packed upload (no_tf32 in f32)."""
    no_tf32(dtype)
    with host_weights(dtype, flowlm_cfg, mimi_cfg) as (fw_h, mw_h):
        return (flowlm.to_device(fw_h, dtype, flowlm_cfg, device),
                mimi.to_device(mw_h, dtype, mimi_cfg, device))


def fence(tap: torch.Tensor) -> float:
    """Wait for the device, then read the scalar ``tap`` back."""
    if tap.device.type == "cuda":
        torch.cuda.synchronize(tap.device)
    return float(tap)


def bench_inputs(batch: int, frames: int, cfg: FlowLMConfig, dtype: torch.dtype,
                 device) -> dict:
    """The offline bench's inputs, drawn as bench.py:95-107 draws them and
    put on ``device``: prefix [B, 64, d_model] and noise [B, frame_bucket,
    latent] in ``dtype``, lengths [B] and ragged_after [B] int32 (stream
    b's EOS budget, spreading the stop over [10, frames])."""
    frame_bucket = ((frames + 63) // 64) * 64
    rng = np.random.default_rng(0)
    prefix = rng.standard_normal((batch, T0, cfg.d_model)) * 0.02
    noise = rng.standard_normal((batch, frame_bucket, cfg.latent_dim)) * 0.8
    ragged_after = 9 + (np.arange(batch) * (frames - 10) // max(batch - 1, 1))
    return dict(prefix=torch.from_numpy(prefix).to(dtype).to(device),
                noise=torch.from_numpy(noise).to(dtype).to(device),
                lengths=torch.full((batch,), T0, dtype=torch.int32, device=device),
                ragged_after=torch.from_numpy(ragged_after.astype(np.int32)).to(device))


def length_groups(ragged_after: np.ndarray, frames: int) -> list:
    """bench.py:164-168: the streams sorted by EOS budget into 4 equal
    groups, each with its vocoder width (its longest stream, rounded up to
    16 frames, at most ``frames``). Returns [(indices, width)]."""
    groups = np.array_split(np.argsort(ragged_after, kind="stable"), 4)
    return [(g, min(frames, (int(ragged_after[g].max()) + 1 + 15) // 16 * 16)) for g in groups]


def audio_seconds(frames_used: np.ndarray, frames: int, frame_rate: float) -> float:
    """Emitted audio (bench.py:222-223): each stream's frames, capped at the
    requested ``frames``, at ``frame_rate`` frames per second."""
    return float(np.minimum(frames_used, frames).sum()) / frame_rate


class OfflineBench:
    """run_bench's offline pipeline at one (batch, frames, dtype) over device
    weights ``fw``/``mw``: the inputs of bench_inputs on ``fw``'s device and
    the four modes of bench.py:

      * "on": generate_latents_while with an EOS threshold that never fires
        (the serving path's per-frame EOS bookkeeping, no early exit);
      * "off": generate_latents over the whole frame bucket, no EOS;
      * "ragged": EOS fires at frame 0, stream b stops after ragged_after[b]
        more frames;
      * "ragged_bucketed": the streams in 4 groups by length_groups, each
        group's loop and vocoder at its own width. As in bench.py:178-186 the
        groups' EOS threshold (1e9) never fires, so each group runs
        ``frames`` frames and counts them, while its vocoder decodes its
        width.

    Prefill and the Mimi transformer run the kernels the device resolves
    (B1 and B2 on CUDA, their plain versions on the CPU). ``graphs``
    (default: on a CUDA device) runs the frame loops as CUDA graph replays
    (runtime/graphs), as TTSEngine does; the first pass captures them."""

    MODES = ("on", "off", "ragged", "ragged_bucketed")

    def __init__(self, fw, mw, batch: int, frames: int, dtype: torch.dtype,
                 cfg: FlowLMConfig, mcfg: MimiConfig, graphs: Optional[bool] = None):
        dev = fw.in_proj.device
        if graphs is None:
            graphs = dev.type == "cuda"
        self.graphs = GraphCache() if graphs else None
        self.fw, self.mw, self.cfg, self.mcfg = fw, mw, cfg, mcfg
        self.batch, self.frames, self.dtype = batch, frames, dtype
        self.frame_bucket = ((frames + 63) // 64) * 64
        self.max_len = T0 + self.frame_bucket
        inp = bench_inputs(batch, frames, cfg, dtype, dev)
        self.prefix, self.noise = inp["prefix"], inp["noise"]
        self.lengths, self.ragged_after = inp["lengths"], inp["ragged_after"]
        self.budget = torch.full((batch,), frames, dtype=torch.int32, device=dev)
        self.groups = [(torch.from_numpy(g).to(dev), w)
                       for g, w in length_groups(self.ragged_after.cpu().numpy(), frames)]
        self.prefill_impl = flowlm.resolve_prefill_impl("auto", dev)
        self.window_impl = mimi.resolve_window_impl("auto", dev)
        self.last_used = None

    def decode(self, latents: torch.Tensor, width: int) -> torch.Tensor:
        """scale_latents + mimi.decode of the first ``width`` frames."""
        return mimi.decode(self.mw, flowlm.scale_latents(self.fw, latents[:, :width]),
                           self.mcfg, self.window_impl)

    def _generate(self, px, take, eos_mode: str) -> flowlm.GenResult:
        cfg = self.cfg
        cache, x0 = flowlm.prefill_init(self.fw, px[take], self.lengths[take], cfg,
                                        self.max_len, self.prefill_impl, graphs=self.graphs)
        if eos_mode == "off":
            return flowlm.generate_latents(self.fw, cache, x0, self.noise[take], cfg,
                                           max_frames=self.frame_bucket, num_steps=1,
                                           eos_enabled=False, graphs=self.graphs)
        return flowlm.generate_latents_while(
            self.fw, cache, x0, self.noise[take], cfg, max_frames=self.frame_bucket,
            num_steps=1, eos_threshold=-1e9 if eos_mode == "ragged" else 1e9,
            eos_min_frames=1,
            eos_after=0 if eos_mode == "on" else self.ragged_after[take],
            max_frames_per_stream=self.budget[take], graphs=self.graphs)

    @torch.inference_mode()
    def run(self, mode: str, px: Optional[torch.Tensor] = None):
        """One pass of ``mode`` from prefix ``px`` (default the bench's).
        Returns ([PCM [b, width * frame_samples] per group], frames_used [B]
        on the device); one group but for "ragged_bucketed"."""
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r}: expected one of {self.MODES}")
        px = self.prefix if px is None else px
        if mode != "ragged_bucketed":
            res = self._generate(px, slice(None), mode)
            return [self.decode(res.latents, self.frames)], res.frames_used
        pcms, used = [], torch.zeros_like(self.budget)
        for take, width in self.groups:
            res = self._generate(px, take, "bucketed")
            pcms.append(self.decode(res.latents, width))
            used[take] = res.frames_used   # stays on the device until the fence
        return pcms, used

    @torch.inference_mode()
    def chained(self, n: int, mode: str) -> float:
        """Wall seconds of ``n`` passes back to back, each fed from the last
        through a data tap, ended by fence() (bench.py:141-157, 192-204);
        the slope of two counts cancels the fixed cost of the fence."""
        t0 = time.perf_counter()
        tap = torch.zeros((), dtype=torch.float32, device=self.prefix.device)
        used = None
        for _ in range(n):
            pcms, used = self.run(mode, self.prefix + tap.to(self.dtype) * 0)
            tap = sum(p[:1, :8].float().sum() for p in pcms)
        fence(tap)
        wall = time.perf_counter() - t0
        self.last_used = used.cpu().numpy()
        return wall

    def measure(self, mode: str, repeats: int, verbose: bool = True):
        """(streams, wall, compile_s) of ``mode``: compile_s is the first
        pass (on a fresh machine it builds the kernels; with graphs, two
        passes, which capture them), wall the least of
        ``repeats`` chained slopes (t3 - t1) / 2, streams the emitted audio
        seconds over wall."""
        t_compile = time.perf_counter()
        self.chained(1, mode)
        if self.graphs is not None:
            # a pass of one chunk per loop only warms its graph up: the next
            # captures it, and the timed passes replay
            self.chained(1, mode)
        compile_s = time.perf_counter() - t_compile
        walls = []
        for _ in range(repeats):
            t1 = self.chained(1, mode)
            t3 = self.chained(3, mode)
            walls.append((t3 - t1) / 2)
        wall = min(walls)
        streams = audio_seconds(self.last_used, self.frames, self.mcfg.frame_rate) / wall
        if verbose:
            tag = " (length-bucketed)" if mode == "ragged_bucketed" else ""
            dt = "bf16" if self.dtype == torch.bfloat16 else "f32"
            print(f"[bench] eos={mode}{tag}: B={self.batch} frames={self.frames} dtype={dt} "
                  f"wall={wall:.4f}s compile={compile_s:.2f}s -> {streams:.1f} streams/chip",
                  file=sys.stderr)
        return streams, wall, compile_s


def run_bench(batch: int, frames: int, dtype_name: str, repeats: int,
              verbose: bool = True, modes=OfflineBench.MODES, *, device="cuda",
              flowlm_cfg: Optional[FlowLMConfig] = None,
              mimi_cfg: Optional[MimiConfig] = None) -> dict:
    """The offline leg (bench.py:46-267): every mode of OfflineBench at
    (batch, frames). ``weights_s`` times the upload alone (to_device, then
    a fence); ``cuda_init_s`` the first device context and one tiny op, on
    a background thread while the host reads the checkpoint."""
    cfg, mcfg = configs(flowlm_cfg, mimi_cfg)
    dtype = DTYPES[dtype_name]
    dev = torch.device(device)
    no_tf32(dtype)

    t_a = time.perf_counter()
    cuda_init_s = [0.0]

    def _init():
        float(torch.ones(8, device=dev).sum())
        cuda_init_s[0] = time.perf_counter() - t_a

    th = threading.Thread(target=_init, daemon=True)
    th.start()
    with host_weights(dtype, cfg, mcfg) as (fw_h, mw_h):
        th.join()
        t_w = time.perf_counter()
        fw = flowlm.to_device(fw_h, dtype, cfg, dev)
        mw = mimi.to_device(mw_h, dtype, mcfg, dev)
        fence(fw.in_proj[0, 0, :1].float().sum())
        weights_s = time.perf_counter() - t_w

    off = OfflineBench(fw, mw, batch, frames, dtype, cfg, mcfg)
    out = {m: off.measure(m, repeats, verbose) for m in modes}
    streams_on, wall_on, compile_on = out.get("on", (0.0, 0.0, 0.0))
    streams_off, _, compile_off = out.get("off", (1e-9, 0.0, 0.0))
    streams_ragged, wall_ragged, _ = out.get("ragged", (0.0, 0.0, 0.0))
    streams_rb, _, _ = out.get("ragged_bucketed", (0.0, 0.0, 0.0))
    return {
        "metric": "concurrent_realtime_streams",
        "value": streams_on,
        "unit": "streams/chip",
        "detail": {
            "batch": batch,
            "frames": frames,
            "dtype": dtype_name,
            "wall_s": wall_on,
            "compile_s": compile_on + compile_off,
            "weights_s": weights_s,
            "cuda_init_s": cuda_init_s[0],
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "graphs": off.graphs is not None,
            "eos_off_streams": streams_off,
            "eos_on_vs_off": streams_on / streams_off,
            "ragged_eos_streams": streams_ragged,
            "ragged_wall_s": wall_ragged,
            "ragged_bucketed_streams": streams_rb,
        },
    }


def voice_cond(rng: np.random.Generator, d_model: int) -> np.ndarray:
    """The batcher bench's one 40-frame voice (bench.py:323)."""
    return (rng.standard_normal((40, d_model)) * 0.02).astype(np.float32)


def draw_request(rng: np.random.Generator, vocab: int) -> tuple:
    """One closed-loop request's draws, in bench.py:330-340's order:
    (frames in [10, 50], token ids [4..20] in [1, vocab), noise_seed)."""
    frames = int(rng.integers(10, 51))
    ids = rng.integers(1, vocab, size=int(rng.integers(4, 21)))
    return frames, ids.astype(np.int32), int(rng.integers(0, 2**31))


def run_batcher_bench(slots: int, dtype_name: str, target_finished: int,
                      max_seconds: float = 120.0, verbose: bool = True,
                      frames_per_step: int = 1, collect_pcm: bool = True,
                      admit_chunk: int = 32, pipeline: bool = False,
                      max_len: int = 128, label: str = "",
                      split_admit=None, spec_admit: bool = False,
                      stats_out: Optional[dict] = None,
                      warmup_steps: int = 12, weights=None, *,
                      device="cuda", flowlm_cfg: Optional[FlowLMConfig] = None,
                      mimi_cfg: Optional[MimiConfig] = None):
    """Sustained continuous-batching throughput (bench.py:270-458): the
    ContinuousBatcher, closed-loop saturated with ragged requests (10-50
    frames, ids path with one registered voice, seed=-1 device noise) until
    ``target_finished`` complete. First chunk latency runs from the start of
    the step that admitted a request to the collect that landed its first
    chunk (queue wait excluded); the ``warmup_steps`` warm-up steps'
    requests are left out of it. ``weights`` is (fw, mw) on ``device`` in
    ``dtype_name``, read from the bench checkpoint when None. Returns
    (streams, first_chunk_p50_ms, finished, wall)."""
    from .runtime.batching import ContinuousBatcher, Request

    cfg, mcfg = configs(flowlm_cfg, mimi_cfg)
    dtype = DTYPES[dtype_name]
    dev = torch.device(device)
    fw, mw = weights or device_weights(dtype, dev, cfg, mcfg)
    # the engine surface the batcher touches (prepare() is bypassed:
    # requests are enqueued directly, so no tokenizer or context is needed)
    flags = KernelFlags()
    eng = types.SimpleNamespace(flowlm_cfg=cfg, mimi_cfg=mcfg, dtype=dtype, fw=fw, mw=mw,
                                flags=flags, device=dev, graphs=dev.type == "cuda",
                                prefill_impl=flowlm.resolve_prefill_impl(flags.prefill_impl, dev))
    b = ContinuousBatcher(eng, slots=slots, max_len=max_len, admit_chunk=admit_chunk,
                          prefix_budget=T0, max_num_steps=1, frames_per_step=frames_per_step,
                          collect_pcm=collect_pcm, pipeline=pipeline, split_admit=split_admit,
                          spec_admit=spec_admit)
    rng = np.random.default_rng(0)
    vidx = b.register_voice("bench", voice_cond(rng, cfg.d_model))
    if vidx < 0:
        raise api.PttsError("the voice bank refused the bench's 40-frame voice")
    admit_t = {}          # rid -> start of the step that placed it in a slot
    first_chunk_ms = []   # admission -> first 80 ms chunk read back
    pending_first = set()

    def make_req():
        frames, ids, noise_seed = draw_request(rng, cfg.vocab)
        req = Request(rid=-1, prefix=None, noise=None, max_frames=frames, eos_after=0,
                      num_steps=1, eos_threshold=np.float32(1e30), eos_min_frames=1,
                      ids=ids, voice_idx=vidx, noise_seed=noise_seed, temp=0.7)
        with b._rid_lock:
            req.rid = b._next_rid
            b._next_rid += 1
        return req

    def top_up():
        # closed-loop saturation: enough queued work to refill every free
        # slot on the next step
        while len(b.queue) < slots + b.admit_chunk:
            req = make_req()
            b.enqueue(req)
            pending_first.add(req.rid)

    def note_admissions(when):
        for req in b.slot_req:
            if req is not None and req.rid not in admit_t:
                admit_t[req.rid] = when

    def note_first_chunks():
        done = []
        for rid in pending_first:
            ts = b.first_chunk_t.get(rid)
            if ts is None and rid in b.finished:
                fc = b.finished[rid].first_chunk_t
                ts = fc if fc >= 0 else None
            if ts is not None:
                if rid in admit_t:
                    first_chunk_ms.append((ts - admit_t[rid]) * 1000.0)
                done.append(rid)
            elif rid in b.finished or rid not in b.chunks:
                done.append(rid)
        pending_first.difference_update(done)

    for _ in range(warmup_steps):  # allocator pools, library choices at these shapes
        top_up()
        b.step()
    b.finished.clear()
    pending_first.clear()
    first_chunk_ms.clear()
    b.phase_s = {k: 0.0 for k in b.phase_s}
    b.n_steps = 0
    b.n_admit_groups = 0

    frames_done = 0
    finished = 0
    t0 = time.perf_counter()
    while finished < target_finished:
        top_up()
        t_step = time.perf_counter()
        b.step()
        note_admissions(t_step)
        note_first_chunks()
        for r, res in list(b.finished.items()):
            frames_done += res.frames
            finished += 1
            del b.finished[r]
        if time.perf_counter() - t0 > max_seconds:
            break
    wall = time.perf_counter() - t0
    streams = frames_done / mcfg.frame_rate / wall
    p50 = float(np.percentile(first_chunk_ms, 50)) if first_chunk_ms else -1.0
    if verbose:
        tags = "".join([" (device-bound)" if not collect_pcm else "",
                        " (pipelined)" if pipeline else "", f" [{label}]" if label else ""])
        # device-bound mode never reads PCM back: its "first chunk" is the
        # first done-flag readback for the stream
        first = (f"first-flag p50 {p50:.1f} ms (flag readback; PCM stays on the card)"
                 if not collect_pcm else f"first-chunk p50 {p50:.1f} ms")
        print(f"[bench] batcher{tags}: slots={slots} dtype={dtype_name} fps={frames_per_step} "
              f"finished={finished} frames={frames_done} wall={wall:.2f}s -> "
              f"{streams:.1f} sustained streams/chip, {first}", file=sys.stderr)
        n = max(b.n_steps, 1)
        phases = " ".join(f"{k}={v / n * 1e3:.2f}" for k, v in b.phase_s.items())
        # c_wait/c_pcm are sub-phases of collect
        top = sum(v for k, v in b.phase_s.items() if not k.startswith("c_"))
        print(f"[bench] batcher phases (ms/step over {b.n_steps} steps, {b.n_admit_groups} "
              f"admit groups): {phases} other={(wall - top) / n * 1e3:.2f}", file=sys.stderr)
    if stats_out is not None:
        stats_out.update(n_steps=b.n_steps, B1=b.B1, phase_s=dict(b.phase_s),
                         frames_done=frames_done, frame_samples=mcfg.frame_samples,
                         frames_per_step=frames_per_step, wall=wall,
                         n_admit_groups=b.n_admit_groups)
    return streams, p50, finished, wall


def bench_context(device="cuda", flowlm_cfg: Optional[FlowLMConfig] = None,
                  mimi_cfg: Optional[MimiConfig] = None) -> api.Context:
    """An api.Context over the bench checkpoint, whose engine runs in
    PTTS_DTYPE, bf16 when unset (set as bench.py sets it)."""
    cfg, mcfg = configs(flowlm_cfg, mimi_cfg)
    os.environ.setdefault("PTTS_DTYPE", "bf16")
    return api.Context(bench_model_dir(cfg, mcfg), cfg, mcfg, device=device)


def run_batcher_bench_prepared(slots: int, target_finished: int,
                               max_seconds: float = 120.0, frames_per_step: int = 8,
                               verbose: bool = True, warmup_steps: int = 12, *,
                               device="cuda",
                               flowlm_cfg: Optional[FlowLMConfig] = None,
                               mimi_cfg: Optional[MimiConfig] = None):
    """Sustained batcher throughput with the host's request prep on the
    clock (bench.py:461-561): tokenizer, prompt and params through
    ``batcher.prepare()`` on 4 feeder threads (the server's handler-thread
    layout), device-bound and pipelined. Returns (streams, finished, wall)."""
    from .runtime.batching import ContinuousBatcher

    ctx = bench_context(device, flowlm_cfg, mimi_cfg)
    eng = ctx.engine  # full engine: mmap load + packed upload
    b = ContinuousBatcher(eng, slots=slots, max_len=128, admit_chunk=32, prefix_budget=T0,
                          max_num_steps=1, frames_per_step=frames_per_step,
                          collect_pcm=False, pipeline=True)
    rng = np.random.default_rng(0)
    words = ["hello", "world", "how", "low", "can", "you", "go", "today"]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 9)))) for _ in range(64)]
    stop = threading.Event()
    errors = []

    def feeder():
        r = np.random.default_rng(threading.get_ident() & 0xFFFF)
        while not stop.is_set():
            # the queue must cover every free slot, or occupancy caps
            if len(b.queue) < slots + b.admit_chunk:
                p = api.Params(num_frames=int(r.integers(10, 51)), num_steps=1, seed=-1,
                               temp=0.7, eos_enabled=False)
                try:
                    b.enqueue(b.prepare(texts[int(r.integers(len(texts)))], params=p))
                except api.PttsError as e:
                    errors.append(e)
                    break
            else:
                time.sleep(0.0005)

    threads = [threading.Thread(target=feeder, daemon=True) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        # a full queue before the warm-up, so the warm-up steps run full pools
        t_fill = time.perf_counter()
        while len(b.queue) < slots and time.perf_counter() - t_fill < 60 and not errors:
            time.sleep(0.005)
        for _ in range(warmup_steps):
            b.step()
        b.finished.clear()
        frames_done = 0
        finished = 0
        t0 = time.perf_counter()
        while finished < target_finished and not errors:
            if b.step() == 0:
                time.sleep(0.001)  # nothing active: yield the GIL to the feeders
            for r, res in list(b.finished.items()):
                frames_done += res.frames
                finished += 1
                del b.finished[r]
            if time.perf_counter() - t0 > max_seconds:
                break
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
        ctx.close()
    if errors:
        raise errors[0]
    streams = frames_done / eng.mimi_cfg.frame_rate / wall
    if verbose:
        print(f"[bench] batcher (prepared, device-bound, pipelined): slots={slots} "
              f"fps={frames_per_step} finished={finished} frames={frames_done} "
              f"wall={wall:.2f}s -> {streams:.1f} sustained streams/chip", file=sys.stderr)
        ph = {k: round(v / max(b.n_steps, 1) * 1000, 2) for k, v in b.phase_s.items()}
        print(f"[bench] prepared phases (ms/step over {b.n_steps} steps, {b.n_admit_groups} "
              f"admit groups, queue={len(b.queue)}): {ph}", file=sys.stderr)
    return streams, finished, wall


def device_info() -> dict:
    """The card as nvidia-smi names it: {name, power_limit_w, count}."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit_w": float(power.split()[0]),
            "count": torch.cuda.device_count()}


def run_http_leg() -> dict:
    """ptts_torch.tools.bench_http in a clean process (pipelined +
    spec-admit), as bench.py:670-678 runs it; returns its http_* keys."""
    env = dict(os.environ, PTTS_HTTP_PIPELINE="1", PTTS_HTTP_SPEC="1")
    out = subprocess.run([sys.executable, "-m", "ptts_torch.tools.bench_http"], env=env,
                         cwd=REPO, stdout=subprocess.PIPE, timeout=1800, check=True)
    return json.loads(out.stdout.decode().strip().splitlines()[-1])


def kernel_counts() -> dict:
    """Launches of each registered kernel in this process, by shape_label
    (T is the decode attention's Tmax, the Mamba-2 frame step's heads), and
    the RoPE tables built (one per new T)."""
    return {"launches": {name: f.launches for name, f in build.WRAPPERS.items()},
            "shapes": {name: {build.shape_label(k): n for k, n in sorted(f.shapes.items())}
                       for name, f in build.WRAPPERS.items()},
            "rope_tables_built": fa._rope_tables.cache_info().misses}


def require_card(prog: str) -> bool:
    """True when a CUDA card is visible; else says so on stderr. The
    measuring entry points run only on the card: no CPU path."""
    if torch.cuda.is_available():
        return True
    print(f"{prog}: no CUDA card is visible (torch.cuda.is_available() is False); "
          f"it measures the GPU and has no CPU path", file=sys.stderr)
    return False


def main() -> int:
    if not require_card("ptts_torch.bench"):
        return 2
    batch = int(os.environ.get("PTTS_BENCH_BATCH", "256"))
    frames = int(os.environ.get("PTTS_BENCH_FRAMES", "50"))
    dtype = os.environ.get("PTTS_BENCH_DTYPE", "bf16")
    repeats = int(os.environ.get("PTTS_BENCH_REPEATS", "3"))
    warmup = int(os.environ.get("PTTS_BENCH_WARMUP_STEPS", "12"))
    failed, leg_s = {}, {}

    def leg(name, fn):
        """fn()'s result, or None with the error recorded under ``name``;
        its wall seconds go to ``leg_s``."""
        t0 = time.perf_counter()
        try:
            return fn()
        except Exception as e:  # a failed leg is reported, never hidden
            traceback.print_exc(file=sys.stderr)
            failed[name] = f"{type(e).__name__}: {e}"
            return None
        finally:
            leg_s[name] = time.perf_counter() - t0

    b = batch

    def offline():
        nonlocal b
        while b >= 1:
            try:
                return run_bench(b, frames, dtype, repeats)
            except torch.cuda.OutOfMemoryError:
                print(f"[bench] B={b} out of device memory, retrying with {b // 2}",
                      file=sys.stderr)
            b //= 2
            torch.cuda.empty_cache()
        raise torch.cuda.OutOfMemoryError(f"out of device memory at every batch from {batch}")

    result = leg("offline", offline) or {
        "metric": "concurrent_realtime_streams", "value": None, "unit": "streams/chip",
        "detail": {"batch": b, "frames": frames, "dtype": dtype}}
    detail = result["detail"]
    detail["device"] = leg("device", device_info)

    # sustained continuous batching (ragged arrivals, slot reuse, per-frame
    # PCM readback): the closest-to-production numbers
    bslots = int(os.environ.get("PTTS_BENCH_BATCHER_SLOTS", str(max(b, 1))))
    breqs = int(os.environ.get("PTTS_BENCH_BATCHER_REQS", "1200"))
    bfps = int(os.environ.get("PTTS_BENCH_FPS", "8"))
    dslots = int(os.environ.get("PTTS_BENCH_DEVICE_SLOTS", "384"))
    dreqs = breqs * dslots // max(bslots, 1)
    batcher_legs = [
        # (leg, run_batcher_bench arguments, streams key, p50 key)
        ("batcher", dict(slots=bslots, target_finished=breqs, frames_per_step=bfps),
         "sustained_batcher_streams", "batcher_first_chunk_p50_ms"),
        ("batcher_pipelined_spec", dict(slots=bslots, target_finished=breqs,
                                        frames_per_step=bfps, pipeline=True, spec_admit=True,
                                        label="pipelined+spec"),
         "sustained_batcher_streams_pipelined_spec", "batcher_pipelined_spec_p50_ms"),
        ("batcher_lowlat", dict(slots=bslots, target_finished=breqs // 2, frames_per_step=4),
         "batcher_lowlat_streams", "batcher_lowlat_p50_ms"),
        ("batcher_device", dict(slots=dslots, target_finished=dreqs, frames_per_step=bfps,
                                collect_pcm=False, pipeline=True),
         "batcher_device_streams", "batcher_device_p50_ms"),
        ("batcher_device_spec", dict(slots=dslots, target_finished=dreqs,
                                     frames_per_step=bfps, collect_pcm=False, pipeline=True,
                                     spec_admit=True, label="spec-admit"),
         "batcher_device_spec_streams", "batcher_device_spec_p50_ms"),
        ("batcher_device_serial", dict(slots=dslots, target_finished=dreqs,
                                       frames_per_step=bfps, collect_pcm=False),
         "batcher_device_serial_streams", "batcher_device_serial_p50_ms"),
    ]
    shared = []   # one upload of the checkpoint for every batcher leg

    def batcher_weights():
        if not shared:
            shared.append(device_weights(DTYPES[dtype], torch.device("cuda"), *configs()))
        return shared[0]

    for name, kw, streams_key, p50_key in batcher_legs:
        out = leg(name, lambda kw=kw: run_batcher_bench(
            dtype_name=dtype, warmup_steps=warmup, weights=batcher_weights(), **kw))
        if out is not None:
            detail[streams_key], detail[p50_key] = out[0], out[1]
            if name == "batcher":
                detail["batcher_finished"] = out[2]
                detail["batcher_frames_per_step"] = bfps
    shared.clear()
    if os.environ.get("PTTS_BENCH_PREPARED", "1") == "1":
        out = leg("batcher_prepared",
                  lambda: run_batcher_bench_prepared(dslots, dreqs, frames_per_step=bfps,
                                                     warmup_steps=warmup))
        if out is not None:
            detail["sustained_batcher_streams_prepared"] = out[0]
    # the HTTP front door, in a clean process: this one holds every earlier
    # leg's pools
    if os.environ.get("PTTS_BENCH_HTTP", "1") == "1":
        detail.update(leg("http", run_http_leg) or {})
    detail["kernels"] = kernel_counts()
    detail["leg_s"] = leg_s
    detail["failed_legs"] = failed
    print(json.dumps(result))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
