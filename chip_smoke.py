#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ptts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases; any failure raises, exits non-zero and prints no result. They run
in this order, but for phase 3, which runs last, over every (B, T) at which
the other phases launched a kernel, for phase 12 (a), which runs after
phase 2 while the card's memory is free, for phase 13, which runs after
phase 11, on its context, and for phase 14, which runs after phase 12 (b)
and (c). Each phase's seconds are printed:
  1. device  -- CUDA must be available; prints nvidia-smi's name and power limit
  2. build   -- nvcc builds the hand-written kernels from ptts_torch/csrc;
                ptxas registers, shared memory and spills; where the toolkit
                has cuobjdump, the HMMA (tensor-core) instructions of each
                kernel, and a bf16 kernel without one fails (but the
                decode attention's and the Mamba-2 frame step's, on the
                CUDA cores by design)
  3. kernels -- each CUDA kernel against its plain PyTorch version on the same
                inputs at main-path shapes, f32 (gate 1e-4) and bf16 (5e-2),
                max error relative to the largest reference value. At each
                shape: the kernel's device time (profiler kernel events,
                median of 30 launches, each after an L2 flush; CUDA events
                of the call once the process's profiler loses its events,
                listed under "profiler_lost"), the wrapper's host-clock
                time per call, the bound (bytes or FLOPs at the H100's
                published peaks) and the share device time / bound, the plain
                version's device time, and library_ms: scaled_dot_product_
                attention on the rotated [B, H, T, D] q/k/v with the same
                mask (attention only: no RoPE, no split). The shapes are
                B1_CASES and B2_CASES, and every (B, T) that a launch
                counter of another phase recorded, in this process or in
                the bench's and its HTTP leg's (each in f32 and bf16)
  3d. decode -- the decode attention kernel (ops/cuda/decode_attention)
                against its plain version (the masked einsum) at the main
                path's shapes, on KVCache.valid_mask past ring wraps at each
                cell's share of valid columns, and at every other (dtype,
                B, Tmax) a phase launched; gates tools/sanitize.DECODE_GATES
                (max error over max |plain|: f32 1e-4, bf16 1.5e-2; and in
                bf16 the error's norm over the plain output's, 1e-2), and at
                the main path's bf16 shapes two wrong kernels -- K/V rounded
                to fp8, the first column of each split dropped -- must each
                fail both. The call's device time (CUDA events, median of
                30, L2 flushed), the main kernel's and the combine's
                (profiler), the bound (the valid columns' K/V rows, q and
                the output at 3.35 TB/s; the mask's bytes left out) and
                share, the einsum's device time and library_ms:
                scaled_dot_product_attention on the same q, cache views and
                mask; runs right after phase 3
  3e. ssm    -- the hybrid backbone's Mamba-2 frame step (ops/cuda/ssm_step).
                First the hybrid's path: the configuration of granite4h-
                serve-long at its own widths, built by benchmark/hybrid,
                serves HYBRID_REQUESTS through that cell's batcher (256
                slots, 8 frames a step, pipelined, graph replay); launch
                counts set to 0 just before, 9 launches per pool frame,
                replays included. Then the kernel against its plain version
                at SSM_CASES (the pool of 257 rows, bf16 and f32, and one
                row) and at every other (dtype, B, H) that path or a phase
                launched, each launched shape with a case: the conv window
                equal, the state and y within GATES; the call's device time
                (CUDA events, median of 30, L2 flushed), the prologue's and
                the state pass's (profiler), the bound (the state and the
                conv window read and written once, xbc, dt, the weights read,
                y written, at 3.35 TB/s) and share, the plain version's and
                the three-pass yardstick's times (three_pass: the frame code
                it replaced); runs right after phase 3d
  4. slice   -- a full-size synthetic checkpoint through ptts_torch.api:
                generate("Hello world!") and a 4-prompt batch_generate; PCM
                finite, frames_used * 1920 samples; both kernels launched
  5. parity  -- the same 8-frame f32 generate (EOS off) on the CPU (plain
                versions) and on the card (kernels): latents and PCM within
                1e-3, frames_used equal, first_cond/first_flow taps within 1e-4
  6. stream  -- Context.stream("Hello world!"): 1920 int16 samples per chunk,
                as many chunks as the offline frames_used, B1 launched; an
                8-frame StreamingSession (EOS off) on the card against the
                CPU, by frame, gated by the model's own amplification: frames
                1-2 within 1e-4 of max, each later frame within 2x the same
                frame's reading with the kernels' plain versions on the card
                (an engine with prefill_impl="plain", decode_impl="einsum",
                run in this call) plus 2 LSB;
                the whole-session reading against a flat 1e-3 is printed
                only; the streamed int16 within 8 LSB of the quantized
                offline PCM; time to first chunk (first call, warm), per-chunk
                wall time at B = 1 and B = 8, and a torch.profiler table of
                warm streaming steps (kernels per step, device busy share)
  7. cli     -- ptts_torch.cli.main on the card: --flow-test with the three
                dump taps (latents within 1e-5 of generate_full), --mimi-test,
                --mimi-wave (frames * 1920 samples), --tokens --verify; both
                kernels launched
  8. serve   -- runtime/batching.ContinuousBatcher and runtime/server on the
                card: (a) 6 ragged requests (3-8 frames, EOS off, one on the
                host-prefix path) through 4 slots, frames as requested, first
                int16 chunks within 4 LSB of the quantized offline PCM, and,
                read back unclipped, whole streams within 1e-3 of the offline
                f32 max; (b) the same with K = 4, split_admit and spec_admit:
                frames equal, first chunks within 4 LSB and unclipped whole
                streams within 1e-3 of (a); (c) 3 requests through 2 slots on
                the card and on the CPU within 8 LSB; (d) B1 launched once per
                layer by every admit group; (e) HTTP: /healthz, 4 concurrent
                /tts, one /tts-stream, /stats; (f) printed only: closed-loop
                serving (ids path, device noise, 10-50 frames) at 16 and 64
                slots -- streams per chip, per-step wall, admission ms per
                group, first-chunk p50/p95 from admission, a device-time
                table (ptts_torch.utils.profiling)
  9. mesh    -- the batcher's pool sharded over a device mesh
                (ptts_torch.parallel.mesh): every visible GPU, or with one
                GPU a rehearsal on it (2 host groups x 2 shards, all on
                cuda:0): (a) phase 8 (a)'s 6 requests through the 2-host
                sharded pool against the unsharded one: frames equal, first
                int16 chunks within 4 LSB, unclipped whole streams within
                1e-3 of max, every shard's pool tensors on its own device;
                (b) B1 launched once per layer by every admit group of every
                shard; (c) submit(host=h) lands in host h's rows; (d)
                spec_admit on a 1-D 2-shard mesh: all finish, no receipt
                left; (e) ptts_torch.dryrun.dryrun_multichip(4, "cuda")
                passes with B1 and B2 launched, and entry("cuda") runs; (f)
                printed only: closed-loop serving at 64 slots on 1 shard and
                on 2 shards (streams per chip, per-step wall and its
                admit/dispatch/collect split, kernels per step)
 10. flags   -- the kernel switches on the card (f32): (a) an engine with
                KernelFlags(prefill_impl="plain", window_impl="plain",
                decode_impl="einsum") launches none of the three kernels in
                an 8-frame generate_full, whose latents and PCM are within
                1e-3 of the kernel engine's; (b)
                decode_impl="blocked" against "einsum", latents within 1e-3;
                (c) validate=True prints one maxdiff line per layer and frame,
                each within 1e-4 of max, and returns the einsum's result; (d)
                a ContinuousBatcher on a blocked engine raises PttsError; (e)
                PTTS_COMPILE_CACHE=<tmp>: a fresh interpreter imports a
                read-only copy of ptts_torch and builds both libraries in
                <tmp>, the copy unchanged (run in the background)
 11. bf16    -- PTTS_DTYPE=bf16 at full width: (a) the packed bf16 weights
                on the card bit-equal to the same trees packed on the CPU,
                every leaf 256-byte aligned; weights_s of the f32 and bf16
                engines (checkpoint read, host pack, copy); (b)
                generate_full, Context.stream and phase 8 (a)'s requests
                through a 4-slot batcher: frames as asked, B1 and the
                decode attention (and B2 in generate_full) launched in bf16
                only, the first two frames'
                latents within 8% of max of the f32 card run (the stream's
                and the batcher's recorded from their frame step, every
                request's; the PCM of the random model clips and amplifies
                bf16 rounding past that gate, so it is printed only); (c)
                printed only: per-chunk wall at B = 1 and 8, closed-loop
                streams per chip at 64 slots, beside phases 6 and 8's f32;
                (b)'s batcher runs eagerly: its latent records need the
                frame step's Python at every frame
 12. bench   -- (a) one pass of each mode of ptts_torch.bench's offline
                pipeline at its defaults (B = 256, 50 frames, bf16), in this
                process: frames_used as the mode sets it, PCM finite and
                whole, both kernels launched; (b) python -m ptts_torch.bench
                in a subprocess at a reduced size (batch 16, 16 frames, 1
                repeat, 64 batcher requests, 64 device-bound slots, 2
                warm-up steps, HTTP 24 requests from 4 clients): rc 0, one
                JSON line, every leg's value > 0, no failed leg, no HTTP
                error, both kernels launched in the bench's process, the
                device name phase 1's; (c) ptts_torch.tools.bench_streaming
                --batch 8 --frames 16 --repeats 1 through its main(), in this
                process: one JSON line, first chunk and per-frame slope > 0,
                B1 launched
 13. graphs  -- the frame loops replayed as CUDA graphs (ptts_torch/runtime/
                graphs.py) against the same loops run eagerly
                (TTSEngine(ctx, graphs=False)) in this process; (a) bit-equal:
                generate_full in f32 and bf16 with EOS on and off and a
                ragged 4-stream batch_generate; StreamingSession at B = 1 and
                8 for 32 frames (past the Mimi ring's 24); phase 8 (a)'s texts
                at 30-32 frames through 4 slots of a 32-column decode ring at
                K = 1, at K = 4 with split_admit and over the 2 x 2 mesh, the
                cursor past the ring; B1 and B2 launched; (b) printed, graph
                against eager, beside the card's name and power limit:
                per-chunk wall at B = 1 and 8, 64-slot streams per chip with
                dispatch per step, launch calls and busy share of a profiled
                stream step and serving step, the offline bench value at
                B = 256, host syncs and done checks in one generate_full,
                captures and their seconds, the graph pools' memory
 14. tools   -- the port's tools (ptts_torch/tools) on the card: (a)
                sanitize's four phases at full width on phase 4's checkpoint
                (guarded raw launches of B1 and B2 at ragged T, in f32 and
                bf16: output bands bit-identical, outputs finite and within
                phase 3's gates; the per-operation NaN trap over an eager
                generate; the PTTS_SANITIZE guards silent; a planted NaN
                weight named), and the NaN trap again on a bf16 engine; (b)
                flowlm_parity against the JAX package's full-width dumps in
                tests/data/jax_golden/ (the checkpoint's SHA-256 must match
                its meta.json first): f32 latents within 1e-3 and cond and
                flow within 1e-4 of max, the --mimi-wave WAV within 33 LSB
                (1e-3 of full scale), each tap's reading, the latents' by
                frame, the WAV's LSB and clipped share printed; (c) both
                sweeps in this process -- bench_batcher_sweep at 64 slots, K
                = 1 and 8, serial and pipelined, at most 5 s a point, and
                bench_batch_sweep at B = 16 and 32, 10 frames, 1 repeat --
                each row printed with the card's name and power limit
Launch counts (B1, B2, the decode attention and the Mamba-2 frame step,
each at every graph replay too) are set to 0 before each of phases 4, 6,
7, 12 (a) and (c) and 14 and read after; phase 13 sums them over its
runs, phase 8 over its serving runs alone (B2 must stay at 0 there),
phase 9 over its sharded
serving runs and the dry run alone, phase 10 over (a)'s plain run and
over (b)-(c)'s runs, phase 11 over its bf16 runs (the f32 references
excluded); phase 12 (b) reads the counts that the bench's own process and
its HTTP leg's report. Every reset first keeps the shapes launched since
the last one (SEEN): phases 3 and 3d read them. The decode attention must
be launched on every path but phase 10's, and not there. The frame step
must be launched on phase 3e's hybrid path alone, and on no path of
Pocket's.
The int16 gates of phases 6 and 8 (c) let a clipping waveform fall back to
its f32 view at 1e-3 of max (the random full-size PCM clips).
Printed last: {"stream": ...}, {"serve": ...}, {"mesh": ...}, {"flags": ...},
{"bf16": ...}, {"bench": ...}, {"graphs": ...}, {"tools": ...} and
{"phase_s": ...} lines, then
{"kernels": [...]} (each kernel's cases, one for each launched shape in
each dtype), {"decode_kernel": [...]} (phase 3d's cases), {"ssm_kernel":
...} (phase 3e's cases and launches by path), then
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ptts_torch import api, bench, cli, dryrun, synth  # noqa: E402
from ptts_torch.config import KernelFlags  # noqa: E402
from ptts_torch.io.wav import load_wav, quantize_i16  # noqa: E402
from ptts_torch.models import flowlm, mimi  # noqa: E402
from ptts_torch.ops.cuda import build  # noqa: E402
from ptts_torch.ops.cuda import decode_attention as da  # noqa: E402
from ptts_torch.ops import rope  # noqa: E402
from ptts_torch.ops.activations import silu  # noqa: E402
from ptts_torch.ops.cuda import fused_attention as fa  # noqa: E402
from ptts_torch.ops.cuda import ssm_step as ss  # noqa: E402
from ptts_torch.parallel import mesh as pmesh  # noqa: E402
from ptts_torch.runtime import server, streaming  # noqa: E402
from ptts_torch.runtime.batching import ContinuousBatcher, Request  # noqa: E402
from ptts_torch.runtime.engine import TTSEngine  # noqa: E402
from ptts_torch.runtime.streaming import StreamingSession  # noqa: E402
from ptts_torch.utils import packing, profiling  # noqa: E402
from ptts_torch.tools import (bench_batch_sweep, bench_batcher_sweep, bench_streaming,  # noqa: E402
                              flowlm_parity, sanitize)
from ptts_torch.utils.timing import GLOBAL_STATS  # noqa: E402

SOURCE = "ptts_torch/csrc/fused_attention.cu"
PALLAS = "ptts_tpu/ops/pallas/fused_attention.py"
GATES = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
FRAME_SAMPLES = 1920
KERNELS = ("causal_attention_qkv", "window_attention_qkv", "decode_attention", "ssm_step")
WRAPPERS = {"causal_attention_qkv": fa.causal_attention_qkv,
            "window_attention_qkv": fa.window_attention_qkv,
            "decode_attention": da.decode_attention, "ssm_step": ss.ssm_step}
POCKET_KERNELS = KERNELS[:3]   # Pocket's paths launch these; ssm_step only the hybrid's
PROMPTS = ["Hello world!", "The quick brown fox jumps over the lazy dog.", "One, two, three.",
           "This is a longer sentence about nothing in particular.", "Streaming speech.",
           "Eight streams advance in lockstep, one frame per step.", "Short.",
           "A last prompt, of middling length, to fill the batch."]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke FAILED: {msg}")


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, max abs error / max |want|), in f32."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


# every (dtype, B, T) launched on a path, by kernel: reset_launches() adds
# the shapes since the last reset; phase 3 holds each against the plain version
SEEN = {name: collections.Counter() for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        SEEN[name].update(WRAPPERS[name].shapes)
        WRAPPERS[name].launches = 0
        WRAPPERS[name].shapes.clear()


def parse_shapes(by_name: dict) -> dict:
    """{kernel: Counter {(dtype, B, T): launches}} of a read_shapes()-style
    report ({kernel: {"dtype B=.. T=..": launches}}, as ptts_torch.bench
    prints it)."""
    out = {}
    for name, by_shape in by_name.items():
        out[name] = collections.Counter()
        for key, n in by_shape.items():
            d, b, t = key.split()
            out[name][(d, int(b[2:]), int(t[2:]))] += n
    return out


def read_launches() -> dict:
    return {name: WRAPPERS[name].launches for name in KERNELS}


def read_shapes() -> dict:
    """{kernel: {"dtype B=.. T=..": launches}} since the last reset_launches()."""
    return {name: {f"{d} B={b} T={t}": n
                   for (d, b, t), n in sorted(WRAPPERS[name].shapes.items())}
            for name in KERNELS}


def sync(device) -> None:
    """Wait for every visible card (a mesh may span several)."""
    if torch.device(device).type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def lsb_or_clipped(got_i16: np.ndarray, want: np.ndarray, gate: int, what: str) -> int:
    """Max int16 distance between ``got_i16`` and ``want`` (int16, or f32 PCM
    quantized with quantize_i16); past ``gate`` only a clipping waveform
    passes, on its f32 views at 1e-3 of max."""
    check(got_i16.shape == want.shape, f"{what}: shapes {got_i16.shape} {want.shape}")
    if want.dtype == np.int16:
        want_i16, want_f32 = want, want / np.float32(32767.0)
        clipped = float(np.mean(np.abs(want_i16) == 32767))
    else:
        want_i16, want_f32 = quantize_i16(want), np.clip(want, -1.0, 1.0)
        clipped = float(np.mean(np.abs(want) > 1.0))
    lsb = int(np.abs(got_i16.astype(np.int32) - want_i16.astype(np.int32)).max())
    if lsb > gate:
        check(clipped > 0, f"{what}: {lsb} LSB > {gate} with no clipping")
        _, rel = rel_err(torch.from_numpy(got_i16 / np.float32(32767.0)),
                         torch.from_numpy(want_f32))
        print(f"  {what}: {lsb} LSB, PCM clips ({clipped:.4f}); f32 views rel {rel:.3e} "
              f"(gate 1e-3)")
        check(rel <= 1e-3, f"{what}: f32 views rel {rel:.3e} > 1e-3")
    return lsb


def host_us(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-clock microseconds per call of fn() (the enqueue, not the run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


_FLUSH = []
FLUSH_BYTES = 128 << 20   # read once: 2.5x the L2 (50 MB)


def flush_l2() -> None:
    """Fill the L2 cache with clean lines of a 128 MB buffer (one read of
    it), so the next call reads its inputs from device memory, as the byte
    bound assumes, and evicts nothing it has to write back."""
    if not _FLUSH:
        _FLUSH.append(torch.ones(FLUSH_BYTES // 4, device="cuda"))
    _FLUSH[0].sum()


PROFILER_LOST = []   # kernel_device_ms's readings taken by CUDA events instead


def kernel_device_ms(fn, kernel: str, iters: int = 30, warmup: int = 3,
                     attempts: int = 3) -> float:
    """Median device time per launch of the kernel whose name contains
    ``kernel``, from the profiler's kernel events (utils/profiling) over
    ``iters`` calls of fn(), each after an L2 flush. Each event is one
    launch, so an event the profiler drops costs a sample, not the reading.
    The profiler now and then loses a whole session's device events (seen on
    the H100 machine after some tens of sessions in one process): a session
    that saw fewer than half of the launches is run again, up to
    ``attempts`` times. Once a process's profiler has lost them that often
    it does not recover: the reading is then call_device_ms(fn) (CUDA
    events around the whole call), and ``kernel`` is listed in
    PROFILER_LOST, which main() prints."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profiling.device_trace("kernel_times", force=True) as trace_dir:
            for _ in range(iters):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        durs = [float(e["dur"]) for e in profiling.device_events(trace_dir)
                if e.get("cat") == "kernel" and kernel in e.get("name", "")]
        shutil.rmtree(trace_dir, ignore_errors=True)
        if len(durs) >= 0.5 * iters:
            return float(np.median(durs)) / 1e3
        print(f"  profiler session saw {len(durs)} of {iters} {kernel} launches; again")
    print(f"  {attempts} profiler sessions lost the {kernel} launches: CUDA events of the call")
    PROFILER_LOST.append(kernel)
    return call_device_ms(fn, iters, warmup)


def call_device_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of fn() (any number of kernels), each
    after an L2 flush: CUDA events recorded on the stream just before and
    after the call, behind a device-side sleep long enough for the host to
    enqueue the whole call, so the interval holds the call's device work and
    the gaps between its kernels, not the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    enqueue_us = host_us(fn, iters=5, warmup=0)
    cycles = int(max(4 * enqueue_us, 200.0) * 2000)  # at <= 2 GHz: >= 4x the enqueue
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        torch.cuda._sleep(cycles)
        flush_l2()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs]))


# Published H100 SXM peaks at 700 W (NVIDIA's data sheet): memory, and dense
# arithmetic for each input type (f32 on the CUDA cores, bf16 on the tensor
# cores). The bound of a call is the larger of bytes / rate and FLOPs / rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def attention_bound(dtype, B: int, T: int, H: int, D: int, pairs: int, outputs: int,
                    v_rows: int) -> dict:
    """Bytes: q and k of the [B, T, 3HD] projection read once, v only in
    the ``v_rows`` rows that some query may see (B1 never reads a row at or
    past lengths[b]), ``outputs`` [B, T, HD] tensors written once. FLOPs:
    2 * D for q.k and 2 * D for p.v per (query, key, head) pair that the
    mask lets through (``pairs`` counts them over the batch for one head);
    RoPE and the softmax are left out."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (B * T * (2 + outputs) + v_rows) * H * D * esize
    flops = 4 * D * H * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return dict(bytes=nbytes, flops=flops, bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(T: int, lengths) -> int:
    """Query-key pairs of B1: query q sees keys k <= q with k < lengths[b]."""
    return sum(sum(min(q + 1, max(min(n, T), 0)) for q in range(T)) for n in lengths)


def window_pairs(B: int, T: int, context: int) -> int:
    """Query-key pairs of B2: query q sees keys with 0 <= q - k < context."""
    return B * sum(min(q + 1, context) for q in range(T))


def rotated_bhtd(qkv, H: int, D: int):
    """q, k (RoPE applied, as the plain version does) and v of a halves-layout
    projection, each [B, H, T, D] contiguous: the library call's inputs."""
    B, T, _ = qkv.shape
    q, k, v = fa._split_qkv(qkv, H, D)
    q, k = rope.rope_rotate_halves(q, k, torch.arange(T, device=qkv.device)[None, :])
    return [x.transpose(1, 2).contiguous() for x in (q, k, v)]


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    return smi


def hmma_counts(so) -> dict:
    """{kernel function: count of HMMA (tensor-core) instructions} in the
    built library's SASS, or {} where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = build.library()
    so = build.library_path()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(so)}")
    log = so.with_name(so.name + ".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
    check(lib is not None, "kernel library did not load")
    counts = hmma_counts(so)
    if not counts:
        print("build: no cuobjdump in the toolkit; HMMA instructions not counted")
    for name, n in counts.items():
        print(f"  sass: {n} HMMA in {name}")
        if ("bfloat16" in name or "bf16" in name) and not any(
                k in name for k in ("decode_attn", "ssm_prologue", "ssm_update")):
            check(n > 0, f"the bf16 kernel {name} has no HMMA instruction")


def b1_lengths(B: int, T: int) -> list:
    """Ragged lengths of a B1 case: the serving admission pattern at B = 8
    (a group's padded entries at length 1), else full, half, 1, T - 7 over
    and over."""
    if B == 8:
        return [T, 1, 1, T // 2 + 3, 1, 17, T - 5, 1]
    return [(T, T // 2 + 3, 1, max(T - 7, 1))[b % 4] for b in range(B)]


# B1 (B, T) and B2 (B, T) that phase 3 always holds (every other launched
# shape joins them from SEEN): the shapes the main path gives the kernels
# (phases 4, 6 and 8 print them) -- B1 at the slice's 64-row prefix
# bucket (B = 1 generate, B = 4 batch_generate), the stream start's
# unrounded prefix (B = 1, T = 14 for "Hello world!"), serving admission's
# [admit_chunk, prefix_budget] (2 x 128 in phase 8 (a)-(c), 8 x 64 in its
# load runs, 8 x 128), the unrounded T = 37, 100 of longer prompts; B2 at
# offline Mimi's T = 16 x frames (B = 1 generate at the 64-frame bucket,
# B = 4 batch_generate at 16 frames, B = 2 at 64 and 50 frames) and at the
# CLI's --mimi-test (T = 1).
B1_CASES = ((1, 14), (1, 64), (2, 128), (4, 64), (4, 128), (4, 37), (4, 100), (8, 64),
            (8, 128))
B2_CASES = ((1, 1024), (2, 1024), (2, 800), (4, 256), (2, 1))
LIBRARY = "attention only (no RoPE, no split)"
BENCH_BATCH, BENCH_FRAMES = 256, 50   # ptts_torch.bench's defaults


def phase_bench_offline(model_dir: str, device="cuda") -> dict:
    """Phase 12 (a): one pass of each mode of the bench's offline pipeline
    (ptts_torch.bench.OfflineBench) at its defaults, bf16, on ``model_dir``
    -- phase 12 (b) runs the bench at a reduced batch, so this holds the
    default batch's shapes (B1 256 x 64, B2 256 x 800 and the length
    groups') and memory. Checks each mode's frames_used and that its PCM is
    finite and whole; the launch counters are set to 0 just before and read
    just after."""
    os.environ["PTTS_BENCH_MODEL_DIR"] = model_dir
    cfg, mcfg = bench.configs()
    fw, mw = bench.device_weights(torch.bfloat16, torch.device(device), cfg, mcfg)
    off = bench.OfflineBench(fw, mw, BENCH_BATCH, BENCH_FRAMES, torch.bfloat16, cfg, mcfg)
    after = off.ragged_after.cpu().numpy()
    want_used = {"on": np.full(BENCH_BATCH, BENCH_FRAMES), "off": np.full(BENCH_BATCH, 64),
                 "ragged": after + 1, "ragged_bucketed": np.full(BENCH_BATCH, BENCH_FRAMES)}
    reset_launches()
    t0 = time.perf_counter()
    for mode in off.MODES:
        pcms, used = off.run(mode)
        widths = ([BENCH_FRAMES] if mode != "ragged_bucketed" else [w for _, w in off.groups])
        for pcm, width in zip(pcms, widths):
            check(pcm.shape[1] == width * FRAME_SAMPLES, f"bench {mode}: PCM {list(pcm.shape)}")
            check(bool(torch.isfinite(pcm).all()), f"bench {mode}: non-finite PCM")
        check(np.array_equal(used.cpu().numpy(), want_used[mode]),
              f"bench {mode}: frames_used {used.cpu().numpy()[:8]}...")
    sync(device)
    seconds = time.perf_counter() - t0
    launches, shapes = read_launches(), read_shapes()
    for name in POCKET_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the bench's offline path")
    print(f"bench (a): one pass of each offline mode at B={BENCH_BATCH}, "
          f"{BENCH_FRAMES} frames, bf16 in {seconds:.2f} s; launches {launches}; by shape "
          f"{shapes}")
    del off, fw, mw
    torch.cuda.empty_cache()
    return dict(launches=launches, shapes=shapes, seconds=seconds)


def kernel_case(name, dtype, B, T, fn, plain, library, bound, errs) -> dict:
    dev_ms = kernel_device_ms(fn, "attn_")
    plain_ms, library_ms = call_device_ms(plain), call_device_ms(library)
    case = dict(dtype="f32" if dtype == torch.float32 else "bf16", B=B, T=T, ms=dev_ms,
                host_us=host_us(fn), plain_ms=plain_ms,
                library_ms=library_ms, share=bound["bound_ms"] / dev_ms, **bound, **errs)
    print(f"{name} {case['dtype']} B={B} T={T}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; kernel {dev_ms:.4f} ms (profiler, median of 30, L2 flushed), wrapper host "
          f"{case['host_us']:.1f} us/call; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bytes'] / 1e6:.2f} MB, "
          f"{bound['flops'] / 1e9:.3f} GFLOP), share {case['share']:.1%}; plain {plain_ms:.4f} "
          f"ms, library {library_ms:.4f} ms ({LIBRARY}; events around one call, L2 flushed)")
    return case


def phase_kernels(seen: dict) -> dict:
    """Each kernel against its plain version at B1_CASES and B2_CASES and
    at every other (B, T) in ``seen`` ({kernel: {(dtype, B, T): launches}}),
    in f32 and bf16; its device time, the wrapper's host time, the bound,
    the plain version's and the library call's times."""
    b1_cases, b2_cases = (
        cases + tuple(sorted({(b, t) for _, b, t in seen[name]} - set(cases)))
        for name, cases in zip(KERNELS[:2], (B1_CASES, B2_CASES)))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {"causal_attention_qkv": [], "window_attention_qkv": []}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for B, T in b1_cases:
            H, D = 16, 64
            qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(np.float32))
            qkv = qkv.to(dev, dtype)
            lens_list = b1_lengths(B, T)
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            kw = dict(num_heads=H, head_dim=D)
            got, k_rot = fa.causal_attention_qkv(qkv, lens, **kw)
            want, want_k = fa.causal_attention_qkv_plain(qkv, lens, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"B1 {tag} T={T}: non-finite output")
            valid = torch.cat([got[b, :n] for b, n in enumerate(lens_list)])
            valid_ref = torch.cat([want[b, :n] for b, n in enumerate(lens_list)])
            abs_a, rel_a = rel_err(valid, valid_ref)
            abs_k, rel_k = rel_err(k_rot, want_k)
            q, k, v = rotated_bhtd(qkv, H, D)
            t = torch.arange(T, device=dev)
            mask = ((t[None, :] <= t[:, None])[None] & (t[None, None, :] < lens[:, None, None]))
            mask = mask[:, None]
            case = kernel_case(
                "B1 causal_attention_qkv", dtype, B, T,
                lambda: fa.causal_attention_qkv(qkv, lens, **kw),
                lambda: fa.causal_attention_qkv_plain(qkv, lens, **kw),
                lambda: sdpa(q, k, v, attn_mask=mask),
                attention_bound(dtype, B, T, H, D, causal_pairs(T, lens_list), outputs=2,
                                v_rows=sum(min(max(n, 0), T) for n in lens_list)),
                dict(attn_rel=rel_a, k_rot_rel=rel_k))
            case.update(lengths=lens_list, max_abs_err=max(abs_a, abs_k),
                        max_rel_err=max(rel_a, rel_k))
            results["causal_attention_qkv"].append(case)
            check(max(rel_a, rel_k) <= GATES[dtype], f"B1 {tag} B={B} T={T}: rel err "
                  f"{max(rel_a, rel_k):.3e} > {GATES[dtype]}")
        for B, T in b2_cases:
            H, D, ctx = 8, 64, 250
            qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(np.float32))
            qkv = qkv.to(dev, dtype)
            kw = dict(num_heads=H, head_dim=D, context=ctx)
            got = fa.window_attention_qkv(qkv, **kw)
            want = fa.window_attention_qkv_plain(qkv, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"B2 {tag} T={T}: non-finite output")
            abs_e, rel_e = rel_err(got, want)
            q, k, v = rotated_bhtd(qkv, H, D)
            t = torch.arange(T, device=dev)
            band = t[:, None] - t[None, :]
            mask = (band >= 0) & (band < ctx)
            case = kernel_case(
                "B2 window_attention_qkv", dtype, B, T,
                lambda: fa.window_attention_qkv(qkv, **kw),
                lambda: fa.window_attention_qkv_plain(qkv, **kw),
                lambda: sdpa(q, k, v, attn_mask=mask),
                attention_bound(dtype, B, T, H, D, window_pairs(B, T, ctx), outputs=1,
                                v_rows=B * T),
                dict(rel=rel_e))
            case.update(context=ctx, max_abs_err=abs_e, max_rel_err=rel_e)
            results["window_attention_qkv"].append(case)
            check(rel_e <= GATES[dtype], f"B2 {tag} T={T}: rel err {rel_e:.3e} > {GATES[dtype]}")
    return results


# Phase 3d's shapes: (dtype, B, Tmax, prefix columns t0, prefix lengths
# [lo, hi], decode columns written [0, hi), offline). bf16-serve-long's pool
# (40-frame voices + 38-94 ids; 150-375-frame streams, ~139 decode columns
# on average), bf16-serve-short's (4-16 ids, 12-62 frames), f32-offline-
# long's length groups (no wrap: prompts to 153 columns, 2/3 of 375 frames
# written), and B = 1 (Context.stream).
DECODE_CASES = ((torch.bfloat16, 256, 544, 160, (78, 134), 278, False),
                (torch.bfloat16, 256, 128, 64, (44, 56), 63, False),
                (torch.float32, 16, 528, 153, (61, 153), 250, True),
                (torch.bfloat16, 1, 200, 40, (20, 40), 150, False),
                (torch.float32, 1, 200, 40, (20, 40), 150, True))
# Grouped-query cases, (query heads, KV heads, softmax scale) after a
# DECODE_CASES entry: the hybrid backbone's attention layer (granite4h-
# serve-long's pool, 32 query heads over 8 KV heads, scale 1/64). Pocket's
# cases above are 16 heads over 16 at 1/sqrt(64).
GQA_CASES = ((DECODE_CASES[0], (32, 8, 0.015625)),)


def decode_inputs(dtype, B: int, Tmax: int, t0: int, prefix, decoded: int, offline: bool,
                  seed: int = 0, heads=(16, 16)):
    """q [B, Hq, 64] and one layer's random K/V [B, Tmax, Hkv, 64] on the card
    (``heads`` = (Hq, Hkv), Pocket's 16 and 16 by default),
    with the mask of a KVCache whose decode ring (the columns from t0 on)
    has wrapped three times (``offline``: not at all, every stream started
    at t0 and ``decoded`` columns written), prefixes uniform in ``prefix``
    and decode spans uniform in [0, ``decoded``)."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    ring = Tmax - t0
    cursor = t0 + decoded if offline else t0 + 3 * ring + 17
    start = (np.full(B, t0) if offline
             else cursor - np.minimum(rng.integers(0, decoded, B), ring - 1))
    cache = flowlm.KVCache(
        k=torch.empty(1, B, Tmax, 0, 0, device=dev), v=None,   # the mask reads Tmax alone
        prefix_len=torch.from_numpy(rng.integers(prefix[0], prefix[1] + 1, B)).to(dev,
                                                                                  torch.int32),
        start=torch.from_numpy(start).to(dev, torch.int32),
        cursor=torch.tensor(cursor, dtype=torch.int32, device=dev), t0=t0)
    mask = cache.valid_mask()
    hq, hkv = heads
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
               for s in ((B, hq, 64), (B, Tmax, hkv, 64), (B, Tmax, hkv, 64)))
    return q, k, v, mask


def rms_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in f32."""
    return ((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30)).item()


def decode_controls(q, k, v, mask, splits: int, scale=None) -> dict:
    """Two wrong kernels, made by feeding the right one wrong inputs, that
    the bf16 gates must tell from it: {"fp8": K and V rounded to
    float8_e4m3fn, "drop": the first valid column of every split's share
    (the kernel's [s * n // splits, (s + 1) * n // splits) of a stream's n
    valid columns) taken out of the mask}. Their outputs."""
    fp8 = [x.to(torch.float8_e4m3fn).to(x.dtype) for x in (k, v)]
    dropped = mask.clone()
    for b in range(mask.shape[0]):
        cols = torch.nonzero(mask[b]).flatten().tolist()
        n = len(cols)
        for s in range(splits):
            if s * n // splits < (s + 1) * n // splits:
                dropped[b, cols[s * n // splits]] = False
    return {"fp8": da.decode_attention(q, *fp8, mask, scale),
            "drop": da.decode_attention(q, k, v, dropped, scale)}


def phase_decode(seen) -> list:
    """Phase 3d: the decode attention kernel at DECODE_CASES and at every
    other (dtype, B, Tmax) in ``seen`` (launches by shape) against the
    masked einsum; its times, bound and share, the einsum's and the library
    call's times (the profiler's kernel and combine times at DECODE_CASES
    alone: each profiler session risks the process's device events). At
    DECODE_CASES in bf16, the two controls of
    decode_controls, each of which must fail both gates the kernel passes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    tag = {v: k for k, v in dtypes.items()}
    held = {(tag[c[0]], c[1], c[2]) for c in DECODE_CASES}
    # a launched shape with no case of its own: a 3-times-wrapped ring over
    # the cache's second half, prefixes of a quarter to a half of it
    # (Pocket's heads; a grouped launch is keyed with its heads)
    extra = [(dtypes[d], B, T, T // 2, (T // 4, T // 2), max(T - T // 2, 1), False)
             for d, B, T in sorted(set(k for k in seen if len(k) == 3) - held)]
    pocket = (16, 16, None)
    runs = ([(c, pocket, True) for c in DECODE_CASES] + [(c, g, True) for c, g in GQA_CASES]
            + [(c, pocket, False) for c in extra])
    gates, rms_gate = sanitize.DECODE_GATES, sanitize.DECODE_RMS_GATE
    cases = []
    for (dtype, B, Tmax, t0, prefix, decoded, offline), (hq, hkv, scale), main in runs:
        q, k, v, mask = decode_inputs(dtype, B, Tmax, t0, prefix, decoded, offline,
                                      seed=B + Tmax, heads=(hq, hkv))
        got = da.decode_attention(q, k, v, mask, scale)
        want = flowlm.decode_attention_masked(q, k, v, mask, scale)
        torch.cuda.synchronize()
        what = f"decode {tag[dtype]} {B}x{Tmax} {hq}/{hkv} heads"
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        abs_e, rel_e = rel_err(got, want)
        rms_e = rms_rel(got, want)
        valid = int(mask.sum())
        esize = torch.finfo(dtype).bits // 8
        # the valid columns' K and V rows of the KV heads, q and out of the query heads
        nbytes = (2 * valid * hkv + 2 * B * hq) * 64 * esize
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        splits = da.splits_for(B, Tmax, sms)
        call = lambda: da.decode_attention(q, k, v, mask, scale)  # noqa: E731
        ms = call_device_ms(call)
        # main: the profiler's split of the call at these alone
        kernel_ms = kernel_device_ms(call, "decode_attn_kernel") if main else None
        combine_ms = (kernel_device_ms(call, "decode_attn_combine") if splits > 1 else 0.0
                      ) if main else None
        plain_ms = call_device_ms(lambda: flowlm.decode_attention_masked(q, k, v, mask, scale))
        # the library call on the KV heads repeated for their groups (made outside the timing)
        kl, vl = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2) for x in (k, v))
        library_ms = call_device_ms(lambda: sdpa(q[:, :, None], kl, vl,
                                                 attn_mask=mask[:, None, None], scale=scale))
        del kl, vl
        case = dict(dtype=tag[dtype], B=B, T=Tmax, heads=[hq, hkv], launched=not main,
                    valid_share=valid / (B * Tmax), splits=splits, ms=ms, kernel_ms=kernel_ms,
                    combine_ms=combine_ms, host_us=host_us(call), bytes=nbytes,
                    bound_ms=bound_ms, bound_by="bytes", share=bound_ms / ms, plain_ms=plain_ms,
                    library_ms=library_ms, max_abs_err=abs_e, max_rel_err=rel_e, rms_rel_err=rms_e)
        controls = ""
        if dtype == torch.bfloat16 and main:
            case["controls"] = {name: dict(max_rel_err=rel_err(out, want)[1],
                                           rms_rel_err=rms_rel(out, want))
                                for name, out in decode_controls(q, k, v, mask, splits,
                                                                 scale).items()}
            controls = "; controls " + ", ".join(
                f"{n} rel {c['max_rel_err']:.3e} rms {c['rms_rel_err']:.3e}"
                for n, c in case["controls"].items())
        print(f"decode_attention {tag[dtype]} B={B} Tmax={Tmax} heads {hq}/{hkv}: valid "
              f"{case['valid_share']:.1%}, {splits} split(s); rel {rel_e:.3e}, rms {rms_e:.3e}"
              f"{controls}; call {ms:.4f} ms (events, median of 30, L2 flushed)"
              + (f" = kernel {kernel_ms:.4f} + combine {combine_ms:.4f} ms (profiler)" if main
                 else "") + f"; wrapper host "
              f"{case['host_us']:.1f} us/call; bound {bound_ms:.4f} ms by bytes "
              f"({nbytes / 1e6:.2f} MB), share {case['share']:.1%}; einsum {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms (scaled_dot_product_attention, same mask)")
        check(rel_e <= gates[dtype], f"{what}: rel err {rel_e:.3e} > {gates[dtype]}")
        if dtype == torch.bfloat16:
            check(rms_e <= rms_gate, f"{what}: rms err {rms_e:.3e} > {rms_gate}")
        for name, c in case.get("controls", {}).items():
            check(c["max_rel_err"] > gates[dtype] and c["rms_rel_err"] > rms_gate,
                  f"{what}: the {name} control passes a gate ({c})")
        cases.append(case)
    return cases


# The Mamba-2 frame step's cases, (dtype, pool rows) at 64 heads: granite4h-
# serve-long's pool (256 slots and the trash row) in its served bf16 and in
# f32, and one row.
SSM_CASES = ((torch.bfloat16, 257), (torch.float32, 257), (torch.bfloat16, 1))
HYBRID_CONFIG = "benchmark/configs/pocket-tts-granite4h-bf16.json"
HYBRID_TRAFFIC = "benchmark/traffic/serve-long-saturated-granite4h.json"
HYBRID_REQUESTS = (32, 64)   # requests served on phase 3e's hybrid path, frames each


def ssm_inputs(dtype, B: int, H: int, seed: int, device="cuda") -> tuple:
    """A Mamba layer's frame inputs at the kernel's P = 64, N = 128: the
    input projection's output row zxbcdt [B, H*64 + C + H] (xbc_dt splits
    it), a random state and conv window, and weights at Mamba-2's init
    scales. Returns (zxbcdt, ssm, conv, params)."""
    rng = np.random.default_rng(seed)
    C = H * 64 + 256

    def t(shape, lo=None, hi=None, scale=1.0):
        x = rng.standard_normal(shape) * scale if lo is None else rng.uniform(lo, hi, shape)
        return torch.from_numpy(x.astype(np.float32)).to(device, dtype)

    params = (t((C, 4), -0.5, 0.5), t((C,), -0.5, 0.5), t((H,), -5, -1),
              torch.log(t((H,), 1, 16)).to(dtype), torch.ones(H, device=device, dtype=dtype))
    return t((B, H * 64 + C + H)), t((B, H, 64, 128), scale=0.5), t((B, 3, C)), params


def xbc_dt(zxbcdt: torch.Tensor, H: int = 64) -> tuple:
    """xbc and dt: views of the input projection's output, as
    models/hybrid.mamba_step passes them."""
    C = H * 64 + 256
    return zxbcdt[:, H * 64:H * 64 + C], zxbcdt[:, H * 64 + C:]


def three_pass(xbc, dt, ssm, conv, conv_w, conv_b, dt_bias, A_log, D):
    """The yardstick: the frame step as the port computed it before its
    kernel (models/hybrid.mamba_step's core), the decay and the update as
    two in-place passes over the state, each rounding to its dtype, then
    the read-out in the state's dtype."""
    B, H, P, N = ssm.shape
    window = torch.cat([conv, xbc[:, None].to(conv.dtype)], 1)
    conv.copy_(window[:, 1:])
    xc = silu((window.float() * conv_w.float().T).sum(1) + conv_b.float()).to(xbc.dtype)
    xs, Bm, Cm = xc.float().split([H * P, N, N], dim=-1)
    dt = torch.nn.functional.softplus(dt.float() + dt_bias.float())
    dA = torch.exp(dt * -torch.exp(A_log.float()))
    xs = xs.reshape(B, H, P)
    sd = ssm.dtype
    ssm.mul_(dA[:, :, None, None].to(sd))
    ssm.addcmul_((xs * dt[..., None]).to(sd)[..., None], Bm.to(sd)[:, None, None, :])
    y = torch.bmm(ssm.view(B, H * P, N), Cm.to(sd)[:, :, None])[..., 0].float()
    return y + (D.float()[:, None] * xs).reshape(B, H * P)


def ssm_bound_bytes(dtype, B: int, H: int) -> int:
    """The least bytes of one frame step: the state [B, H, 64, 128] and the
    conv window [B, 3, C] read and written once, xbc [B, C], dt [B, H] and
    the layer's weights read, y [B, H*64] written in f32."""
    e = torch.finfo(dtype).bits // 8
    C = H * 64 + 256
    return (2 * B * H * 64 * 128 + 2 * B * 3 * C + B * (C + H) + 5 * C + 3 * H) * e \
        + B * H * 64 * 4


def hybrid_path(seed: int = 2**31 + 977) -> dict:
    """The hybrid's main path as granite4h-serve-long serves it: the
    configuration at its own widths (10 layers, 9 of them Mamba layers of
    64 heads; about 2 GB of bf16 weights) built by the benchmark's own
    builder, the cell's batcher (serving.ServeRun: 256 slots, 8 frames a
    step, pipelined, graph replay), HYBRID_REQUESTS' requests drained
    through it. Launch counts are set to 0 just before the drain; every
    shard step of k frames, eager, captured or replayed, must launch the
    frame step 9k times, and each request return its frames of PCM.
    Returns the launches, pool frames, captures, replays and the Counter of
    shapes launched."""
    from benchmark import hybrid as H, serving, system as S
    from ptts_torch.runtime import graphs as rgraphs

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = H.expand(json.load(open(os.path.join(root, HYBRID_CONFIG))))
    mix = json.load(open(os.path.join(root, HYBRID_TRAFFIC)))
    t0 = time.perf_counter()
    sysm = H.build(cfg, seed, "cuda", mix["voices"])
    run = serving.ServeRun(sysm, mix, seed, 0.0, False)
    b = run.b
    check(sysm.engine.graphs, "ssm (hybrid path): the hybrid's card engine replays no graphs")
    frames = [0]
    shard_step = b._dispatch_shard

    def counted(sh, k):
        frames[0] += k
        return shard_step(sh, k)

    b._dispatch_shard = counted
    n_req, n_frames = HYBRID_REQUESTS
    for i in range(n_req):
        run.enqueue(serving.request_spec(mix, cfg, seed, 0, i, n_frames,
                                         S.DTYPES[cfg["dtype"]]), 0.0)
    stats0 = dict(rgraphs.STATS)
    reset_launches()
    res = b.drain()
    sync("cuda")
    launches, shapes = read_launches(), collections.Counter(WRAPPERS["ssm_step"].shapes)
    replays = rgraphs.STATS["replays"] - stats0["replays"]
    captures = rgraphs.STATS["captures"] - stats0["captures"]
    reset_launches()
    fc = sysm.engine.flowlm_cfg
    rows = sum(sh.rows for sh in b.shards)
    check(len(res) == n_req, f"ssm (hybrid path): {len(res)} of {n_req} requests returned")
    for rid, r in res.items():
        check(r.frames == n_frames and r.pcm_i16.shape == (n_frames * FRAME_SAMPLES,),
              f"ssm (hybrid path) rid {rid}: {r.frames} frames, PCM {r.pcm_i16.shape}")
    check(len(fc.mamba_layers) == 9 and fc.mamba_heads == 64 and rows == 257,
          f"ssm (hybrid path): {len(fc.mamba_layers)} Mamba layers of {fc.mamba_heads} heads "
          f"over {rows} rows")
    check(captures > 0 and replays > 0,
          f"ssm (hybrid path): {captures} captures, {replays} replays")
    check(launches["ssm_step"] == 9 * frames[0] > 0,
          f"ssm (hybrid path): {launches['ssm_step']} frame-step launches in {frames[0]} pool "
          f"frames of 9 Mamba layers")
    print(f"ssm (hybrid path): {n_req} requests of {n_frames} frames through granite4h-serve-"
          f"long's batcher at the configuration's widths in {time.perf_counter() - t0:.1f} s "
          f"(build included): {frames[0]} pool frames, {captures} captures, {replays} "
          f"replays; launches {launches}; frame step by shape {dict(shapes)}")
    b._dispatch_shard = shard_step
    del run, b, sysm, res
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches["ssm_step"], frames=frames[0], captures=captures,
                replays=replays, shapes=shapes)


def phase_ssm(seen) -> dict:
    """Phase 3e: first the hybrid's path (hybrid_path); then the Mamba-2
    frame step at SSM_CASES and at every other (dtype, B, H) that path or
    ``seen`` launched, against its plain version; its times, bound and
    share, the plain version's and the three-pass yardstick's times (the
    profiler's split at SSM_CASES alone). Every shape the hybrid's path
    launched must have a case."""
    hybrid = hybrid_path()
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    tag = {v: k for k, v in dtypes.items()}
    held = {(tag[d], B, 64) for d, B in SSM_CASES}
    launched = set(seen) | set(hybrid["shapes"])
    runs = ([(d, B, 64, True) for d, B in SSM_CASES]
            + [(dtypes[d], B, H, False) for d, B, H in sorted(launched - held)])
    cases = []
    for dtype, B, H, main in runs:
        what = f"ssm_step {tag[dtype]} B={B} H={H}"
        zxbcdt, ssm, conv, params = ssm_inputs(dtype, B, H, seed=B + H)
        xbc, dt = xbc_dt(zxbcdt, H)
        s_plain, c_plain = ssm.clone(), conv.clone()
        want = ss.ssm_step_plain(xbc, dt, s_plain, c_plain, *params)
        got = ss.ssm_step(xbc, dt, ssm, conv, *params)
        sync("cuda")
        check(torch.equal(conv, c_plain), f"{what}: the conv window differs from the plain "
              f"version's")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite y")
        _, rel_s = rel_err(ssm, s_plain)
        abs_y, rel_y = rel_err(got, want)
        check(rel_s <= GATES[dtype] and rel_y <= GATES[dtype],
              f"{what}: state rel {rel_s:.3e}, y rel {rel_y:.3e} > {GATES[dtype]}")
        nbytes = ssm_bound_bytes(dtype, B, H)
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        call = lambda: ss.ssm_step(xbc, dt, ssm, conv, *params)  # noqa: E731
        ms = call_device_ms(call)
        update_ms = kernel_device_ms(call, "ssm_update_kernel") if main else None
        prologue_ms = kernel_device_ms(call, "ssm_prologue_kernel") if main else None
        plain_ms = call_device_ms(lambda: ss.ssm_step_plain(xbc, dt, s_plain, c_plain, *params))
        three_ms = call_device_ms(lambda: three_pass(xbc, dt, s_plain, c_plain, *params))
        state_bytes = 2 * B * H * 64 * 128 * (torch.finfo(dtype).bits // 8)
        case = dict(dtype=tag[dtype], B=B, H=H, launched=(tag[dtype], B, H) in launched,
                    ms=ms, update_ms=update_ms, prologue_ms=prologue_ms, host_us=host_us(call),
                    bytes=nbytes, bound_ms=bound_ms, bound_by="bytes", share=bound_ms / ms,
                    update_tb_s=(state_bytes / update_ms / 1e9) if main else None,
                    plain_ms=plain_ms, three_pass_ms=three_ms, max_abs_err=abs_y,
                    max_rel_err=rel_y, state_rel_err=rel_s)
        print(f"{what}: state rel {rel_s:.3e}, y rel {rel_y:.3e}; call {ms:.4f} ms (events, "
              f"median of 30, L2 flushed)"
              + (f" = prologue {prologue_ms:.4f} + state pass {update_ms:.4f} ms (profiler; "
                 f"the state pass at {case['update_tb_s']:.2f} TB/s)" if main else "")
              + f"; wrapper host {case['host_us']:.1f} us/call; bound {bound_ms:.4f} ms by "
              f"bytes ({nbytes / 1e6:.2f} MB), share {case['share']:.1%}; plain {plain_ms:.4f} "
              f"ms, three-pass yardstick {three_ms:.4f} ms")
        del zxbcdt, xbc, dt, ssm, conv, s_plain, c_plain, want, got
        cases.append(case)
    torch.cuda.empty_cache()
    cased = {(c["dtype"], c["B"], c["H"]) for c in cases}
    check(set(hybrid["shapes"]) <= cased, f"ssm_step: the hybrid's path launched at "
          f"{sorted(set(hybrid['shapes']) - cased)} with no case in phase 3e")
    hybrid["shapes"] = {f"{d} B={b} H={h}": n for (d, b, h), n in sorted(hybrid["shapes"].items())}
    return dict(cases=cases, hybrid=hybrid)


def phase_slice(model_dir: str):
    t0 = time.perf_counter()
    ctx = api.load_dir(model_dir, device="cuda")
    engine = ctx.engine
    check(engine.dtype == torch.float32, "engine is not f32 (PTTS_DTYPE set?)")
    print(f"slice: load + upload {time.perf_counter() - t0:.2f} s")

    reset_launches()
    GLOBAL_STATS.reset()
    t0 = time.perf_counter()
    audio = ctx.generate("Hello world!", params=api.Params(seed=1))
    t1 = time.perf_counter()
    out = engine.generate_full("Hello world!", params=api.Params(seed=1))
    t2 = time.perf_counter()
    prompts = ["Hello world!", "The quick brown fox jumps over the lazy dog.",
               "One, two, three.", "This is a longer sentence about nothing in particular."]
    batch = engine.batch_generate(prompts, params=api.Params(seed=2))
    t3 = time.perf_counter()
    launches, shapes = read_launches(), read_shapes()

    n = len(audio.samples)
    check(n > 0 and n % FRAME_SAMPLES == 0, f"generate: {n} samples is not whole frames")
    check(bool(np.isfinite(audio.samples).all()), "generate: non-finite PCM")
    check(len(out.audio.samples) == out.frames_used * FRAME_SAMPLES,
          f"generate_full: {len(out.audio.samples)} samples for {out.frames_used} frames")
    check(n == len(out.audio.samples)
          and np.allclose(audio.samples, out.audio.samples, atol=1e-5, rtol=1e-5),
          "generate and generate_full disagree at the same seed")
    for i, a in enumerate(batch):
        m = len(a.samples)
        check(m > 0 and m % FRAME_SAMPLES == 0, f"batch stream {i}: {m} samples")
        check(bool(np.isfinite(a.samples).all()), f"batch stream {i}: non-finite PCM")
    for name in POCKET_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the main path")
    stats = GLOBAL_STATS.summary()
    print(f"slice: generate {1e3 * (t1 - t0):.1f} ms (first call), generate_full "
          f"{1e3 * (t2 - t1):.1f} ms, batch_generate(4) {1e3 * (t3 - t2):.1f} ms; "
          f"frames_used {out.frames_used}; batch samples {[len(a.samples) for a in batch]}")
    for label in ("FlowLM latents", "Mimi decode"):
        s = stats[label]
        print(f"  span {label}: count {s['count']}, min {s['min_ms']} ms, "
              f"max {s['max_ms']} ms, total {s['total_ms']} ms")
    print(f"slice: kernel launches {launches}; by shape {shapes}")
    return ctx, launches


def phase_parity(cpu_ctx, gpu_ctx) -> None:
    p = api.Params(seed=3, num_frames=8, eos_enabled=False)
    text = "Hello world, this is the card against the CPU."
    cpu = cpu_ctx.engine.generate_full(text, params=p)
    gpu = gpu_ctx.engine.generate_full(text, params=p)
    check(cpu.frames_used == gpu.frames_used == 8,
          f"frames_used cpu {cpu.frames_used} gpu {gpu.frames_used}")
    for name, tol in (("latents", 1e-3), ("first_cond", 1e-4), ("first_flow", 1e-4)):
        _, rel = rel_err(torch.from_numpy(getattr(gpu, name)), torch.from_numpy(getattr(cpu, name)))
        print(f"parity: {name} rel {rel:.3e} (gate {tol})")
        check(rel <= tol, f"parity {name}: {rel:.3e} > {tol}")
    _, rel = rel_err(torch.from_numpy(gpu.audio.samples), torch.from_numpy(cpu.audio.samples))
    print(f"parity: pcm rel {rel:.3e} (gate 1e-3)")
    check(rel <= 1e-3, f"parity pcm: {rel:.3e} > 1e-3")


def session_pcm(engine, texts, params) -> np.ndarray:
    """[B, frames * 1920] f32 view of a whole StreamingSession."""
    chunks = list(StreamingSession.start(engine, texts, params=params))
    return np.concatenate([c.pcm for c in chunks], axis=1)


def session_drift(engine, plain_engine, cpu_engine, text: str, params) -> dict:
    """A one-stream StreamingSession on the card against the CPU, by frame:
    max |card - CPU| of each frame's f32 view over max |CPU|. Run twice on
    the card: with the kernels (``engine``) and with their plain versions
    (``plain_engine``: prefill_impl="plain", decode_impl="einsum"), which
    carries the rest of the card's arithmetic. The random model amplifies either's rounding frame by
    frame, so the gate follows that amplification, from this same call:
    frames 1-2 within 1e-4; from frame 3 on, each frame within 2x the plain
    run's reading of that frame plus 2 LSB. The whole-session reading is
    printed beside it against the old flat 1e-3, ungated."""
    cpu = session_pcm(cpu_engine, [text], params)
    lsb2 = 2.0 / 32767.0 / max(float(np.abs(cpu).max()), 1e-30)
    out = {}
    for label, eng in (("kernels", engine), ("plain", plain_engine)):
        gpu = session_pcm(eng, [text], params)
        check(gpu.shape == cpu.shape == (1, params.num_frames * FRAME_SAMPLES),
              f"session shapes {gpu.shape} {cpu.shape}")
        _, rel = rel_err(torch.from_numpy(gpu), torch.from_numpy(cpu))
        out[label] = dict(rel=rel, by_frame=rel_by_frame(gpu[0], cpu[0]))
        print(f"stream: {params.num_frames}-frame session, card ({label}) vs CPU f32 view rel "
              f"{rel:.3e} (flat 1e-3 reading, printed); by frame "
              f"{[f'{x:.2e}' for x in out[label]['by_frame']]}")
    got, plain = out["kernels"]["by_frame"], out["plain"]["by_frame"]
    limits = [1e-4 if i < 2 else 2.0 * plain[i] + lsb2 for i in range(len(got))]
    out["limits"] = limits
    print(f"stream: session gate by frame (1e-4 at frames 1-2, then 2x plain + 2 LSB = "
          f"{lsb2:.2e}): limits {[f'{x:.2e}' for x in limits]}")
    for i, (g, lim) in enumerate(zip(got, limits)):
        check(g <= lim, f"stream card vs CPU frame {i + 1}: {g:.3e} > {lim:.3e}")
    return out


def chunk_times(engine, B: int, frames: int = 32) -> dict:
    """Per-chunk host wall time of a warm B-stream session, EOS off."""
    p = api.Params(seed=5, num_frames=frames, eos_enabled=False)
    for _ in StreamingSession.start(engine, PROMPTS[:B], params=dataclasses.replace(p, num_frames=4)):
        pass  # warm-up at this batch size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = StreamingSession.start(engine, PROMPTS[:B], params=p)
    start_ms = 1e3 * (time.perf_counter() - t0)
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        chunk = sess.step()
        times.append(1e3 * (time.perf_counter() - t0))
        check(bool(chunk.active.all()), f"B={B}: a stream ended with EOS off")
    check(sess.all_done, f"B={B}: session not done after {frames} frames")
    return dict(B=B, frames=frames, start_ms=start_ms, mean_ms=float(np.mean(times)),
                p50_ms=float(np.median(times)), max_ms=float(np.max(times)), first_ms=times[0])


def trace_figures(trace_dir: str, steps: int, wall_us: float, table: bool) -> dict:
    """Kernels, host launch calls (kernel, graph, copy) and device time per
    step, and the device busy share of the host-clock wall, from a
    profiling.device_trace of ``steps`` steps (prints the device-time table
    when ``table``)."""
    if table:
        print(profiling.format_summary(trace_dir, 20))
    ops = profiling.summarize_trace(trace_dir)
    kernels = sum(v["count"] for name, v in ops.items()
                  if not name.startswith(("Memcpy", "Memset")))
    busy = profiling.busy_us(trace_dir)
    check(kernels > 0, "the profiler saw no device kernel")
    calls = profiling.launch_calls(trace_dir)
    return dict(steps=steps, kernels_per_step=kernels / steps,
                launches_per_step={k: v / steps for k, v in calls.items()},
                device_us_per_step=busy / steps, profiled_wall_us_per_step=wall_us / steps,
                busy_share=busy / wall_us)


def profile_steps(engine, steps: int = 8, table: bool = True) -> dict:
    """A device trace of ``steps`` warm streaming steps at B = 1: prints
    the device-time table when ``table``; returns kernels and launch calls
    per step and the busy share."""
    sess = StreamingSession.start(engine, ["Hello world!"],
                                  params=api.Params(seed=5, num_frames=steps + 4,
                                                    eos_enabled=False))
    for _ in range(4):
        sess.step()
    torch.cuda.synchronize()
    with profiling.device_trace("stream_steps", force=True) as trace_dir:
        t0 = time.perf_counter()
        for _ in range(steps):
            sess.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    return trace_figures(trace_dir, steps, wall_us, table=table)


def phase_stream(gpu_ctx, cpu_ctx, plain_engine) -> dict:
    engine = gpu_ctx.engine
    text = "Hello world!"
    p = api.Params(seed=1)
    reset_launches()
    t0 = time.perf_counter()
    gen = gpu_ctx.stream(text, params=p)
    first = next(gen)
    ttfc_first = 1e3 * (time.perf_counter() - t0)
    chunks = [first] + list(gen)
    launches, shapes = read_launches(), read_shapes()
    used = engine.generate_full(text, params=p, decode_audio=False).frames_used
    for i, c in enumerate(chunks):
        check(c.pcm_i16.shape == (FRAME_SAMPLES,) and c.pcm_i16.dtype == np.int16,
              f"stream chunk {i}: {c.pcm_i16.shape} {c.pcm_i16.dtype}")
    check(len(chunks) == used, f"stream: {len(chunks)} chunks, offline frames_used {used}")
    check(launches["causal_attention_qkv"] > 0, "B1 was not launched by the stream")
    print(f"stream: {len(chunks)} chunks of {FRAME_SAMPLES} int16 (offline frames_used {used}); "
          f"launches {launches}; by shape {shapes}")

    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        gen = gpu_ctx.stream(text, params=p)
        next(gen)
        warm.append(1e3 * (time.perf_counter() - t0))
        gen.close()
    print(f"stream: time to first chunk, first call {ttfc_first:.2f} ms; warm "
          f"{', '.join(f'{t:.2f}' for t in warm)} ms")

    p8 = api.Params(seed=3, num_frames=8, eos_enabled=False)
    text8 = "Hello world, this is the card against the CPU."
    drift = session_drift(engine, plain_engine, cpu_ctx.engine, text8, p8)

    streamed = np.concatenate([c.pcm_i16 for c in gpu_ctx.stream(text8, params=p8)])
    offline = engine.generate(text8, params=p8).samples
    lsb = lsb_or_clipped(streamed, offline, 8, "stream vs offline")
    print(f"stream: int16 vs quantized offline PCM, max {lsb} LSB (gate 8); offline |pcm| max "
          f"{np.abs(offline).max():.4f}, share clipped {float(np.mean(np.abs(offline) > 1.0)):.4f}")

    rates = [chunk_times(engine, B) for B in (1, 8)]
    for r in rates:
        print(f"stream: B={r['B']} per-chunk wall mean {r['mean_ms']:.3f} ms, max "
              f"{r['max_ms']:.3f} ms over {r['frames']} frames (first {r['first_ms']:.3f} ms; "
              f"session start {r['start_ms']:.3f} ms)")
    prof = profile_steps(engine)
    print(f"stream: profiled B=1 step: {prof['kernels_per_step']:.1f} device kernels per step, "
          f"device busy {prof['device_us_per_step']:.1f} us of {prof['profiled_wall_us_per_step']:.1f} "
          f"us profiled wall per step (busy share {prof['busy_share']:.3f}); against the "
          f"unprofiled B=1 mean {rates[0]['mean_ms']:.3f} ms: "
          f"{prof['device_us_per_step'] / (10 * rates[0]['mean_ms']):.1f}% busy")
    return dict(launches=launches, ttfc_first_ms=ttfc_first, ttfc_warm_ms=warm,
                lsb=lsb, rates=rates, profile=prof, drift=drift)


def phase_cli(model_dir: str, gpu_ctx) -> dict:
    text = "Hello world!"
    base = ["-d", model_dir, "-p", text, "--device", "cuda", "-S", "1", "--frames", "4",
            "--eos-threshold", "1e9"]
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="ptts_cli_") as tmp:
        lat, cond, flow, wave = (os.path.join(tmp, n) for n in
                                 ("lat.f32", "cond.f32", "flow.f32", "mimi.wav"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(base + ["--flow-test", "--latent-out", lat, "--cond-out", cond,
                                  "--flow-out", flow])
        check(rc == 0, f"cli --flow-test exited {rc}")
        check(out.getvalue().startswith("FlowLM step: eos_logit="), f"cli: {out.getvalue()!r}")
        sizes = [os.path.getsize(f) for f in (lat, cond, flow)]
        fc = gpu_ctx.flowlm_cfg
        check(sizes == [4 * 4 * fc.latent_dim, 4 * fc.d_model, 4 * fc.latent_dim],
              f"cli dump sizes {sizes}")
        params = cli._params_from_args(cli.build_parser().parse_args(base))
        want = gpu_ctx.engine.generate_full(text, params=params, decode_audio=False)
        got = np.fromfile(lat, dtype="<f4").reshape(4, fc.latent_dim)
        _, rel = rel_err(torch.from_numpy(got), torch.from_numpy(want.latents))
        check(rel <= 1e-5, f"cli --latent-out vs generate_full: {rel:.3e} > 1e-5")

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(base + ["--mimi-test", "--mimi-wave", wave])
        check(rc == 0, f"cli --mimi-test --mimi-wave exited {rc}")
        check("Mimi decode (transformer) stats:" in out.getvalue(), f"cli: {out.getvalue()!r}")
        n = load_wav(wave).num_samples
        check(n == 4 * FRAME_SAMPLES, f"cli --mimi-wave: {n} samples for 4 frames")

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-d", model_dir, "-p", text, "--device", "cuda", "--tokens", "--verify"])
        check(rc == 0 and out.getvalue().startswith("Tokens ("), f"cli --tokens --verify: {rc}")
    launches = read_launches()
    for name in POCKET_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the CLI modes")
    print(f"cli: --flow-test dumps {sizes} bytes, latents vs generate_full rel {rel:.3e}; "
          f"--mimi-wave {n} samples; --tokens --verify ok; launches {launches}")
    return launches


SERVE_FRAMES = (3, 8, 5, 4, 7, 6)   # ragged num_frames of the equality requests
SERVE_SEED = 7
PCM_SCALE = 8.0  # unclipped readback: the random full-size PCM reaches |4.6|


@contextlib.contextmanager
def unclipped_pcm():
    """While active, the serving step's device quantizer takes pcm /
    PCM_SCALE, so the int16 chunks carry the whole waveform unclipped, at
    PCM_SCALE / 32767 resolution (a power-of-two scale is exact in f32)."""
    quantize = streaming.quantize_i16_device
    streaming.quantize_i16_device = lambda pcm: quantize(pcm / PCM_SCALE)
    try:
        yield
    finally:
        streaming.quantize_i16_device = quantize


def unclipped_view(pcm_i16: np.ndarray, what: str) -> np.ndarray:
    """f32 PCM of an unclipped_pcm() run's int16 chunks."""
    check(int(np.abs(pcm_i16.astype(np.int32)).max()) < 32767, f"{what}: scaled PCM clips")
    return pcm_i16.astype(np.float32) * np.float32(PCM_SCALE / 32767.0)


def rel_by_frame(got: np.ndarray, want: np.ndarray) -> list:
    """Max |got - want| of each 1920-sample frame over max |want|."""
    diff = np.abs(got.astype(np.float64) - want).reshape(-1, FRAME_SAMPLES).max(axis=1)
    return [float(d) for d in diff / max(float(np.abs(want).max()), 1e-30)]


def serve_batch(engine, texts, frames, host_prefix=(), **pool_kw) -> tuple:
    """One request per (text, frames) through a fresh ContinuousBatcher, EOS
    off, explicit seed (host parity noise: request rid draws seed + rid);
    requests whose index is in ``host_prefix`` take the host-prefix
    admission path. Returns (rids, {rid: Result}, batcher)."""
    b = ContinuousBatcher(engine, **pool_kw)
    cond, _ = engine._voice_cond(None)
    rids = []
    for j, (text, f) in enumerate(zip(texts, frames)):
        req = b.prepare(text, params=api.Params(seed=SERVE_SEED, num_frames=f,
                                                eos_enabled=False))
        if j in host_prefix:
            req = dataclasses.replace(req, prefix=engine._build_prefix(req.ids, cond), ids=None,
                                      voice_idx=-1)
        rids.append(b.enqueue(req))
    return rids, b.drain(), b


def serve_http(ctx) -> dict:
    """server.serve on the card: /healthz, 4 concurrent /tts, one
    /tts-stream, /stats."""
    import http.client
    import threading

    httpd = server.serve(ctx, port=0, slots=4, max_len=192, prefix_budget=128)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    addr = httpd.server_address

    def call(method, path, payload=None):
        conn = http.client.HTTPConnection(*addr, timeout=300)
        conn.request(method, path, None if payload is None else json.dumps(payload))
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        return resp.status, body

    try:
        status, body = call("GET", "/healthz")
        check(status == 200 and body == b"ok", f"/healthz: {status} {body!r}")
        outs = [None] * 4

        def worker(i):
            outs[i] = call("POST", "/tts", {"text": PROMPTS[i], "num_frames": 4, "seed": 20 + i,
                                           "eos_enabled": False})

        t0 = time.perf_counter()
        workers = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        tts_s = time.perf_counter() - t0
        for i, out in enumerate(outs):
            check(out is not None and out[0] == 200, f"/tts {i}: {out and out[0]}")
            body = out[1]
            check(body[:4] == b"RIFF" and len(body) == 44 + 4 * FRAME_SAMPLES * 2,
                  f"/tts {i}: {len(body)} bytes for 4 frames")
        status, body = call("POST", "/tts-stream", {"text": PROMPTS[4], "num_frames": 4,
                                                    "seed": 30, "eos_enabled": False})
        check(status == 200 and len(body) == 4 * FRAME_SAMPLES * 2,
              f"/tts-stream: {status}, {len(body)} bytes for 4 frames")
        status, body = call("GET", "/stats")
        serving = json.loads(body)["serving"]
        check(status == 200 and serving["slots"] == 4 and serving["steps"] > 0,
              f"/stats: {status} {serving}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.tts_service.close()
        thread.join(timeout=30)
    print(f"serve (e): HTTP /healthz ok; 4 concurrent /tts 4-frame WAVs in {tts_s:.3f} s; "
          f"/tts-stream {4 * FRAME_SAMPLES * 2} bytes; /stats serving {serving}")
    return dict(concurrent_tts_s=tts_s, stats_serving=serving)


def serve_load(engine, slots: int, target: int = 200, max_seconds: float = 25.0,
               profile_steps: int = 0, table: bool = False, mesh=None) -> dict:
    """Closed-loop serving as bench.py's batcher bench: the ids path with one
    registered 40-frame voice, seed=-1 device noise, ragged 10-50 frames,
    prefix_budget 64, max_len 128, admit_chunk 8, K = 1, pipelined, the
    queue topped up to refill every free slot each step; the pool sharded
    over ``mesh`` when given."""
    cfg = engine.flowlm_cfg
    b = ContinuousBatcher(engine, slots=slots, max_len=128, admit_chunk=8, prefix_budget=64,
                          max_num_steps=1, frames_per_step=1, pipeline=True, mesh=mesh)
    rng = np.random.default_rng(0)
    vidx = b.register_voice("bench", (rng.standard_normal((40, cfg.d_model)) * 0.02)
                            .astype(np.float32))
    check(vidx >= 0, "serve load: voice bank refused the 40-frame voice")
    admit_t, first_ms, pending = {}, [], set()

    def top_up():
        while len(b.queue) < slots + b.admit_chunk:
            with b._rid_lock:
                rid = b._next_rid
                b._next_rid += 1
            ids = rng.integers(1, cfg.vocab, size=int(rng.integers(4, 21))).astype(np.int32)
            b.enqueue(Request(rid=rid, prefix=None, noise=None,
                              max_frames=int(rng.integers(10, 51)), eos_after=0, num_steps=1,
                              eos_threshold=np.float32(1e30), eos_min_frames=1, ids=ids,
                              voice_idx=vidx, noise_seed=int(rng.integers(0, 2**31)), temp=0.7))
            pending.add(rid)

    def note(when):
        for req in b.slot_req:
            if req is not None and req.rid not in admit_t:
                admit_t[req.rid] = when
        done = []
        for rid in pending:
            ts = b.first_chunk_t.get(rid)
            if ts is None and rid in b.finished and b.finished[rid].first_chunk_t >= 0:
                ts = b.finished[rid].first_chunk_t
            if ts is not None:
                if rid in admit_t:
                    first_ms.append(1e3 * (ts - admit_t[rid]))
                done.append(rid)
            elif rid in b.finished or rid not in b.chunks:
                done.append(rid)
        pending.difference_update(done)

    for _ in range(12):  # warm-up: allocator pools, cuDNN choices at this B
        top_up()
        b.step()
    sync(engine.device)
    b.finished.clear()
    pending.clear()
    b.phase_s = {k: 0.0 for k in b.phase_s}
    b.n_steps = b.n_admit_groups = 0
    frames = finished = 0
    t0 = time.perf_counter()
    while finished < target and time.perf_counter() - t0 < max_seconds:
        top_up()
        t_step = time.perf_counter()
        b.step()
        note(t_step)
        for rid, res in list(b.finished.items()):
            frames += res.frames
            finished += 1
            del b.finished[rid]
    sync(engine.device)
    wall = time.perf_counter() - t0
    check(finished > 0, f"serve load at {slots} slots finished no request")
    out = dict(slots=slots, shards=len(b.shards), finished=finished, frames=frames, wall_s=wall,
               audio_s_per_s=frames * 0.08 / wall, steps=b.n_steps,
               step_ms=1e3 * wall / max(b.n_steps, 1),
               admit_ms_per_group=1e3 * b.phase_s["admit"] / max(b.n_admit_groups, 1),
               admit_groups=b.n_admit_groups,
               phase_ms_per_step={k: 1e3 * v / max(b.n_steps, 1) for k, v in b.phase_s.items()},
               first_chunk_p50_ms=float(np.percentile(first_ms, 50)) if first_ms else -1.0,
               first_chunk_p95_ms=float(np.percentile(first_ms, 95)) if first_ms else -1.0)
    if profile_steps:
        out["profile"] = profile_load(b, top_up, profile_steps, table)
    return out


def profile_load(b, top_up, steps: int, table: bool) -> dict:
    """A device trace of ``steps`` warm closed-loop batcher steps (prints
    the device-time table when ``table``); returns kernels per step and
    the device busy share."""
    sync("cuda")
    with profiling.device_trace(f"serve_{b.slots}_slots_{len(b.shards)}_shards",
                                force=True) as trace_dir:
        t0 = time.perf_counter()
        for _ in range(steps):
            top_up()
            b.step()
        sync("cuda")
        wall_us = 1e6 * (time.perf_counter() - t0)
    return trace_figures(trace_dir, steps, wall_us, table)


def phase_serve(gpu_ctx, cpu_ctx, measure: bool = True) -> dict:
    """Phase 8. Launch counts are summed over the serving runs alone: each
    is bracketed by reset_launches()/read_launches(); the offline
    references and the CPU run are not."""
    engine = gpu_ctx.engine
    texts = PROMPTS[:6]
    pool_a = dict(slots=4, admit_chunk=2, prefix_budget=128, max_len=192)
    served = dict.fromkeys(KERNELS, 0)
    shapes = {name: {} for name in KERNELS}

    def on_path(fn, *args, **kw):
        reset_launches()
        out = fn(*args, **kw)
        for name, n in read_launches().items():
            served[name] += n
        for name, by_shape in read_shapes().items():
            for shape, n in by_shape.items():
                shapes[name][shape] = shapes[name].get(shape, 0) + n
        return out

    t0 = time.perf_counter()
    rids, res_a, b = on_path(serve_batch, engine, texts, SERVE_FRAMES, host_prefix=(5,), **pool_a)
    t_a = time.perf_counter() - t0
    # (d): every admit group prefilled through B1, once per layer
    admit_launches = served["causal_attention_qkv"]
    n_layers = engine.flowlm_cfg.num_layers
    print(f"serve (d): B1 launched {admit_launches} times by (a)'s {b.n_admit_groups} admit "
          f"groups ({n_layers} layers)")
    check(b.n_admit_groups >= 3, f"serve (a): {b.n_admit_groups} admit groups")
    check(admit_launches == n_layers * b.n_admit_groups > 0,
          f"serve (d): admission launched B1 {admit_launches} times, not once per layer and group")
    # The same requests again with the quantizer scaled (unclipped_pcm), so
    # the whole streams compare unclipped: (a) against the offline f32 PCM
    # and (b) against (a), each at 1e-3 of max. int16 first chunks keep the
    # 4 LSB gate; whole-stream int16 distances are printed only (the random
    # full-size model amplifies float rounding frame by frame; PERF.md).
    with unclipped_pcm():
        _, res_au, _ = on_path(serve_batch, engine, texts, SERVE_FRAMES, host_prefix=(5,),
                               **pool_a)
    lsb_a, first_a, rel_a, frames_a, offline = [], [], [], {}, {}
    for rid, text, f in zip(rids, texts, SERVE_FRAMES):
        r = res_a[rid]
        check(r.frames == res_au[rid].frames == f,
              f"serve (a) rid {rid}: {r.frames} / {res_au[rid].frames} frames, asked {f}")
        check(r.pcm_i16.shape == (f * FRAME_SAMPLES,), f"serve (a) rid {rid}: {r.pcm_i16.shape}")
        offline[rid] = engine.generate(text, params=api.Params(seed=SERVE_SEED + rid, num_frames=f,
                                                               eos_enabled=False)).samples
        first_a.append(lsb_or_clipped(r.pcm_i16[:FRAME_SAMPLES], offline[rid][:FRAME_SAMPLES], 4,
                                      f"serve (a) rid {rid} first chunk vs offline"))
        lsb_a.append(int(np.abs(r.pcm_i16.astype(np.int32)
                                - quantize_i16(offline[rid]).astype(np.int32)).max()))
        frames_a[rid] = rel_by_frame(unclipped_view(res_au[rid].pcm_i16, f"serve (a) rid {rid}"),
                                     offline[rid])
        rel_a.append(max(frames_a[rid]))
    print(f"serve (a): 6 requests (frames {SERVE_FRAMES}, rid 5 on the host-prefix path) "
          f"through 4 slots in {1e3 * t_a:.1f} ms, {b.n_admit_groups} admit groups; int16 vs "
          f"quantized offline: first chunk max LSB {first_a} (gate 4), whole stream {lsb_a} "
          f"(printed); unclipped vs offline f32, rel of max {[f'{x:.3e}' for x in rel_a]} "
          f"(gate 1e-3); offline |pcm| max "
          f"{ {k: round(float(np.abs(v).max()), 3) for k, v in offline.items()} }")
    for rid in rids:
        print(f"  serve (a) rid {rid} unclipped rel by frame "
              f"{[f'{x:.2e}' for x in frames_a[rid]]}")

    spec = dict(host_prefix=(5,), frames_per_step=4, split_admit=True, spec_admit=True, **pool_a)
    rids_b, res_b, _ = on_path(serve_batch, engine, texts, SERVE_FRAMES, **spec)
    with unclipped_pcm():
        _, res_bu, _ = on_path(serve_batch, engine, texts, SERVE_FRAMES, **spec)
    check(rids_b == rids, f"serve (b): rids {rids_b} != {rids}")
    lsb_b, first_b, rel_b = [], [], []
    for rid in rids:
        got, ref = res_b[rid].pcm_i16, res_a[rid].pcm_i16
        check(res_b[rid].frames == res_bu[rid].frames == res_a[rid].frames,
              f"serve (b) rid {rid}: {res_b[rid].frames} frames vs {res_a[rid].frames}")
        first_b.append(lsb_or_clipped(got[:FRAME_SAMPLES], ref[:FRAME_SAMPLES], 4,
                                      f"serve (b) rid {rid} first chunk vs (a)"))
        lsb_b.append(int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()))
        ref_u = unclipped_view(res_au[rid].pcm_i16, f"serve (a) rid {rid}")
        rel_b.append(max(rel_by_frame(unclipped_view(res_bu[rid].pcm_i16,
                                                     f"serve (b) rid {rid}"), ref_u)))
    print(f"serve (b): K=4 + split_admit + spec_admit vs (a): frames equal; first chunk max "
          f"LSB {first_b} (gate 4), whole stream {lsb_b} (printed); unclipped rel of max "
          f"{[f'{x:.3e}' for x in rel_b]} (gate 1e-3)")
    for what, rels in (("(a) vs offline", rel_a), ("(b) vs (a)", rel_b)):
        for rid, rel in zip(rids, rels):
            check(rel <= 1e-3, f"serve {what} rid {rid}: unclipped rel {rel:.3e} > 1e-3")

    pool_c = dict(slots=2, admit_chunk=2, prefix_budget=128, max_len=192)
    frames_c = (4, 4, 4)
    rids_g, res_g, _ = on_path(serve_batch, engine, texts[:3], frames_c, **pool_c)
    rids_c, res_c, _ = serve_batch(cpu_ctx.engine, texts[:3], frames_c, **pool_c)
    check(rids_g == rids_c, f"serve (c): rids {rids_g} != {rids_c}")
    lsb_c = []
    for rid in rids_g:
        check(res_g[rid].frames == res_c[rid].frames == 4, f"serve (c) rid {rid}: frames")
        lsb_c.append(lsb_or_clipped(res_g[rid].pcm_i16, res_c[rid].pcm_i16, 8,
                                    f"serve (c) rid {rid} card vs CPU"))
    print(f"serve (c): 3 requests through 2 slots, card vs CPU max LSB {lsb_c} (gate 8)")

    http = on_path(serve_http, gpu_ctx)
    out = dict(lsb_a=lsb_a, first_a=first_a, rel_a=rel_a, lsb_b=lsb_b, first_b=first_b,
               rel_b=rel_b, lsb_c=lsb_c, equality_ms=1e3 * t_a, http=http,
               pool_a=(rids, res_a, res_au))
    if measure:
        on_card = engine.device.type == "cuda"
        out["load"] = [on_path(serve_load, engine, slots, profile_steps=8 if on_card else 0,
                               table=slots == 64) for slots in (16, 64)]
        for r in out["load"]:
            print(f"serve (f): {r['slots']} slots: {r['finished']} streams finished in "
                  f"{r['wall_s']:.3f} s ({r['steps']} steps), {r['audio_s_per_s']:.2f} audio s "
                  f"per wall s; {r['step_ms']:.3f} ms per step; admission "
                  f"{r['admit_ms_per_group']:.3f} ms per group ({r['admit_groups']} groups); "
                  f"first chunk from admission p50 {r['first_chunk_p50_ms']:.2f} ms, p95 "
                  f"{r['first_chunk_p95_ms']:.2f} ms; phases ms/step "
                  f"{ {k: round(v, 3) for k, v in r['phase_ms_per_step'].items()} }")
            prof = r.get("profile")
            if prof:
                print(f"serve (f): profiled {r['slots']}-slot step: "
                      f"{prof['kernels_per_step']:.1f} device kernels per step, device busy "
                      f"{prof['device_us_per_step']:.1f} us of "
                      f"{prof['profiled_wall_us_per_step']:.1f} us profiled wall per step "
                      f"(busy share {prof['busy_share']:.3f})")
    out["launches"], out["shapes"] = served, shapes
    print(f"serve: kernel launches on the serving runs {served}; by shape {shapes}")
    check(served["causal_attention_qkv"] > 0, "B1 was not launched on the serving path")
    check(served["window_attention_qkv"] == 0,
          f"B2 launched {served['window_attention_qkv']} times on the serving path, whose "
          f"streaming Mimi has no window kernel")
    return out


def mesh_layouts() -> tuple:
    """(2-host mesh, 1-D 2-shard mesh, GPU count): over the visible GPUs, or
    with one GPU its rehearsal on cuda:0 (2 host groups x 2 shards)."""
    n = torch.cuda.device_count()
    if n == 1:
        return (pmesh.make_multihost_mesh(2, ["cuda:0"] * 4),
                pmesh.make_mesh(["cuda:0"] * 2), n)
    devs = [f"cuda:{i}" for i in range(n)]
    # at most 4 positions: phase 8 (a)'s pool has 4 slots, and a shard may not be empty
    return pmesh.make_multihost_mesh(2, devs[: min(4, n - n % 2)]), pmesh.make_mesh(devs[:2]), n


def phase_mesh(gpu_ctx, unsharded, measure: bool = True) -> dict:
    """Phase 9: phase 8 (a)'s requests through the sharded pool against the
    unsharded results ``unsharded`` = (rids, int16 results, unclipped
    results); host pinning, spec_admit, the dry run; closed-loop figures.
    Launch counts are summed over this phase's sharded serving runs and the
    dry run; the unsharded baseline of (f) is not counted."""
    engine = gpu_ctx.engine
    hmesh, mesh1, n_gpu = mesh_layouts()
    names = [torch.cuda.get_device_name(i) for i in range(n_gpu)]
    print(f"mesh: {n_gpu} visible GPU(s) {names}; 2-host mesh {hmesh.devices}, "
          f"1-D mesh {mesh1.device_list}")
    texts = PROMPTS[:6]
    pool_a = dict(slots=4, admit_chunk=2, prefix_budget=128, max_len=192)
    n_layers = engine.flowlm_cfg.num_layers
    served = dict.fromkeys(KERNELS, 0)

    def on_path(fn, *args, **kw):
        reset_launches()
        out = fn(*args, **kw)
        for name, n in read_launches().items():
            served[name] += n
        return out

    # (a) equality with the unsharded pool; (b) B1 once per layer per group
    rids_u, res_u, res_uu = unsharded
    rids, res_s, b = on_path(serve_batch, engine, texts, SERVE_FRAMES, host_prefix=(5,),
                             mesh=hmesh, **pool_a)
    groups, b1 = b.n_admit_groups, read_launches()["causal_attention_qkv"]
    print(f"mesh (b): B1 launched {b1} times by {groups} admit groups over "
          f"{len(b.shards)} shards ({n_layers} layers)")
    check(b1 == n_layers * groups > 0,
          f"mesh (b): B1 launched {b1} times, not once per layer and admit group")
    check(rids == rids_u, f"mesh (a): rids {rids} != {rids_u}")
    for sh in b.shards:
        tensors = (sh.cache.k, sh.x, sh.done, sh.noise_tab, sh.time_embs, sh.cond_bank,
                   sh.mimi_state["ring"]["k"], *sh.params_dev)
        check(all(t.device == sh.device for t in tensors),
              f"mesh (a): shard {sh.index}'s pool is not all on {sh.device}")
    with unclipped_pcm():
        _, res_su, _ = on_path(serve_batch, engine, texts, SERVE_FRAMES, host_prefix=(5,),
                               mesh=hmesh, **pool_a)
    first, rel, whole = [], [], []
    for rid in rids:
        got, ref = res_s[rid].pcm_i16, res_u[rid].pcm_i16
        check(res_s[rid].frames == res_su[rid].frames == res_u[rid].frames,
              f"mesh (a) rid {rid}: {res_s[rid].frames} frames vs {res_u[rid].frames}")
        first.append(lsb_or_clipped(got[:FRAME_SAMPLES], ref[:FRAME_SAMPLES], 4,
                                    f"mesh (a) rid {rid} first chunk vs unsharded"))
        whole.append(int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()))
        rel.append(max(rel_by_frame(unclipped_view(res_su[rid].pcm_i16, f"mesh (a) rid {rid}"),
                                    unclipped_view(res_uu[rid].pcm_i16,
                                                   f"serve (a) rid {rid}"))))
    print(f"mesh (a): 6 requests through {len(b.shards)} shards vs unsharded: frames equal; "
          f"first chunk max LSB {first} (gate 4), whole stream {whole} (printed); unclipped "
          f"rel of max {[f'{x:.3e}' for x in rel]} (gate 1e-3)")
    for rid, r in zip(rids, rel):
        check(r <= 1e-3, f"mesh (a) rid {rid}: unclipped rel {r:.3e} > 1e-3")

    # (c) host pinning
    bp = ContinuousBatcher(engine, mesh=hmesh, **pool_a)
    p = api.Params(seed=SERVE_SEED, num_frames=3, eos_enabled=False)
    pinned = {bp.submit(texts[h], params=p, host=h): h for h in (0, 1, 1)}
    on_path(bp.step)
    slot_of = {req.rid: s for s, req in enumerate(bp.slot_req) if req is not None}
    check(all(slot_of[rid] in bp._host_slots[h] for rid, h in pinned.items()),
          f"mesh (c): rows {slot_of} not in their host groups' {bp._host_slots}")
    res_p = on_path(bp.drain)
    check(all(res_p[rid].frames == 3 for rid in pinned), "mesh (c): pinned requests' frames")
    print(f"mesh (c): submit(host=h) -> rows {slot_of} of host groups {bp._host_slots}")

    # (d) spec_admit on a 1-D 2-shard mesh
    rids_d, res_d, bd = on_path(serve_batch, engine, texts, SERVE_FRAMES, mesh=mesh1,
                                spec_admit=True, pipeline=True, **pool_a)
    check(all(res_d[rid].frames == f for rid, f in zip(rids_d, SERVE_FRAMES)),
          "mesh (d): spec_admit frames")
    check(bd._spec_inflight == 0 and not bd._receipts, "mesh (d): spec_admit left a receipt")
    print(f"mesh (d): spec_admit over {len(bd.shards)} shards: {len(res_d)} requests "
          f"finished, frames {[res_d[r].frames for r in rids_d]}, no receipt left")

    # (e) the dry run and the frame-step entry
    t0 = time.perf_counter()
    on_path(dryrun.dryrun_multichip, 4, "cuda")
    dry = read_launches()
    t_dry = time.perf_counter() - t0
    check(all(dry[name] > 0 for name in POCKET_KERNELS), f"mesh (e): dry-run launches {dry}")
    fn, args = dryrun.entry("cuda")
    with torch.inference_mode():
        _, x, latent, eos = fn(*args)
    sync("cuda")
    check(bool(torch.isfinite(x).all() and torch.isfinite(latent).all()), "mesh (e): entry")
    print(f"mesh (e): dryrun_multichip(4, 'cuda') passed in {t_dry:.2f} s, launches {dry}; "
          f"entry('cuda') frame step at B = {x.shape[0]}: x {tuple(x.shape)}, latent "
          f"{tuple(latent.shape)}")

    out = dict(gpus=n_gpu, names=names, first=first, whole=whole, rel=rel, b1=b1,
               groups=groups, dry_launches=dry)
    if measure:
        # the 1-shard baseline is phase 8's path: its launches stay out of the mesh count
        out["load"] = [serve_load(engine, 64, max_seconds=12.0, profile_steps=8, mesh=None),
                       on_path(serve_load, engine, 64, max_seconds=12.0, profile_steps=8,
                               mesh=mesh1)]
        for r in out["load"]:
            prof = r["profile"]
            phases = {k: round(v, 3) for k, v in r["phase_ms_per_step"].items()}
            print(f"mesh (f): 64 slots on {r['shards']} shard(s): {r['finished']} streams "
                  f"finished in {r['wall_s']:.3f} s ({r['steps']} steps), "
                  f"{r['audio_s_per_s']:.2f} audio s per wall s; {r['step_ms']:.3f} ms per step, "
                  f"phases ms/step {phases}; "
                  f"{prof['kernels_per_step']:.1f} device kernels and "
                  f"{prof['device_us_per_step']:.1f} us device time per profiled step "
                  f"(busy share {prof['busy_share']:.3f})")
    out["launches"] = served
    print(f"mesh: kernel launches on the mesh runs {served}")
    return out


FLAGS_TEXT = "Hello world, this is the card against the CPU."


@contextlib.contextmanager
def swapped_flags(engine, **changes):
    """While active, ``engine.flags`` has ``changes`` (decode_impl and
    validate are read per call; the kernel switches are resolved at
    construction and take an engine of their own)."""
    orig = engine.flags
    engine.flags = dataclasses.replace(orig, **changes)
    try:
        yield engine
    finally:
        engine.flags = orig


CACHE_PROBE = """
import sys
sys.path.insert(0, sys.argv[1])
import ptts_torch
from ptts_torch import native
from ptts_torch.ops.cuda import build
print(build.library_path())
print(native.available())
"""


def start_cache_probe(tmp: str) -> tuple:
    """Phase 10 (e), started in the background: a copy of ptts_torch/ made
    read-only, imported by a fresh interpreter with PTTS_COMPILE_CACHE
    pointing elsewhere, which builds both libraries (nvcc, g++) there."""
    root, cache = os.path.join(tmp, "readonly"), os.path.join(tmp, "compile_cache")
    pkg = os.path.join(root, "ptts_torch")
    shutil.copytree(os.path.join(os.path.dirname(os.path.abspath(__file__)), "ptts_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for d, _, files in os.walk(pkg):
        for f in files:
            os.chmod(os.path.join(d, f), 0o444)
        os.chmod(d, 0o555)
    listing = sorted(os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs)
    env = {**os.environ, "PTTS_COMPILE_CACHE": cache, "PYTHONDONTWRITEBYTECODE": "1"}
    proc = subprocess.Popen([sys.executable, "-c", CACHE_PROBE, root], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return proc, pkg, cache, listing, time.perf_counter()


def finish_cache_probe(probe) -> dict:
    proc, pkg, cache, listing, t0 = probe
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for d, _, _ in os.walk(pkg):
            os.chmod(d, 0o755)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"flags (e): the read-only import failed:\n{err[-2000:]}")
    built = sorted(os.listdir(cache)) if os.path.isdir(cache) else []
    lines = out.split()
    check(lines[-1] == "True", f"flags (e): the host library did not build: {err[-2000:]}")
    check(os.path.dirname(lines[-2]) == cache, f"flags (e): kernels built at {lines[-2]}")
    for stem in ("libptts_torch_kernels_", "libptts_host_"):
        check(any(f.startswith(stem) and f.endswith(".so") for f in built),
              f"flags (e): no {stem}*.so in {cache}: {built}")
    now = sorted(os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs)
    check(now == listing, f"flags (e): the read-only package gained {set(now) - set(listing)}")
    print(f"flags (e): PTTS_COMPILE_CACHE=<tmp>, package copy read-only: both libraries built "
          f"there in {wall:.2f} s ({built}); the package directory unchanged")
    return dict(built=built, wall_s=wall)


def phase_flags(ctx, plain_engine, tmp: str) -> dict:
    """Phase 10: the kernel switches, validate mode and the build directory
    on the card (f32, full width)."""
    probe = start_cache_probe(tmp)
    engine = ctx.engine
    n_layers = engine.flowlm_cfg.num_layers
    p8 = api.Params(seed=3, num_frames=8, eos_enabled=False)
    ref = engine.generate_full(FLAGS_TEXT, params=p8)

    # (a) the switches on the plain versions: no launch, and the kernels' result
    check((plain_engine.prefill_impl, plain_engine.window_impl, plain_engine.flags.decode_impl)
          == ("plain", "plain", "einsum"), f"flags (a): resolved {plain_engine.prefill_impl}, "
          f"{plain_engine.window_impl}, {plain_engine.flags.decode_impl}")
    reset_launches()
    out = plain_engine.generate_full(FLAGS_TEXT, params=p8)
    sync("cuda")
    plain_launches = read_launches()
    check(all(n == 0 for n in plain_launches.values()),
          f"flags (a): the plain switches launched {plain_launches}")
    check(out.frames_used == ref.frames_used == 8, f"flags (a): frames {out.frames_used}")
    rels = {}
    for name, got, want in (("latents", out.latents, ref.latents),
                            ("pcm", out.audio.samples, ref.audio.samples)):
        _, rels[name] = rel_err(torch.from_numpy(got), torch.from_numpy(want))
        check(rels[name] <= 1e-3, f"flags (a): plain vs kernels {name} {rels[name]:.3e} > 1e-3")
    print(f"flags (a): prefill_impl=plain, window_impl=plain, decode_impl=einsum: launches "
          f"{plain_launches}; 8-frame "
          f"generate_full vs the kernel engine: latents rel {rels['latents']:.3e}, PCM rel "
          f"{rels['pcm']:.3e} (gate 1e-3)")

    # (b) blocked decode attention against the masked einsum; (c) validate
    reset_launches()
    with swapped_flags(engine, decode_impl="einsum"):
        einsum = engine.generate_full(FLAGS_TEXT, params=p8, decode_audio=False)
    with swapped_flags(engine, decode_impl="blocked"):
        blocked = engine.generate_full(FLAGS_TEXT, params=p8, decode_audio=False)
    _, rel_b = rel_err(torch.from_numpy(blocked.latents), torch.from_numpy(einsum.latents))
    check(rel_b <= 1e-3, f"flags (b): blocked vs einsum latents {rel_b:.3e} > 1e-3")
    printed = io.StringIO()
    with swapped_flags(engine, decode_impl="blocked", validate=True), \
            contextlib.redirect_stdout(printed):
        validated = engine.generate_full(FLAGS_TEXT, params=p8, decode_audio=False)
    launches = read_launches()
    check(launches["decode_attention"] == 0,
          f"flags (b)-(c): einsum and blocked runs launched the decode kernel ({launches})")
    lines = [ln for ln in printed.getvalue().splitlines()
             if ln.startswith("[ptts] validate decode_attention maxdiff=")]
    check(len(lines) == n_layers * 8, f"flags (c): {len(lines)} validate lines for "
          f"{n_layers} layers x 8 frames")
    worst = 0.0
    for ln in lines:
        diff, top = (float(v) for v in re.findall(r"=(\S+)", ln))
        worst = max(worst, diff / max(top, 1e-30))
    check(worst <= 1e-4, f"flags (c): validate maxdiff {worst:.3e} of max > 1e-4")
    _, rel_v = rel_err(torch.from_numpy(validated.latents), torch.from_numpy(einsum.latents))
    check(rel_v <= 1e-6, f"flags (c): validate mode's latents {rel_v:.3e} from the einsum run's")
    print(f"flags (b): decode_impl=blocked vs einsum, 8 frames: latents rel {rel_b:.3e} "
          f"(gate 1e-3); (c) validate: {len(lines)} lines ({n_layers} layers x 8 frames), worst "
          f"maxdiff {worst:.3e} of max (gate 1e-4), e.g. {lines[0]!r}; its latents vs the "
          f"einsum run rel {rel_v:.1e} (bit-equal {rel_v == 0}); launches {launches}")

    # (d) the batcher refuses the blocked decode (its ring wraps)
    with swapped_flags(engine, decode_impl="blocked"):
        try:
            ContinuousBatcher(engine, slots=4, max_len=192, prefix_budget=128)
        except api.PttsError as e:
            print(f"flags (d): ContinuousBatcher on a blocked engine: PttsError ({e})")
        else:
            check(False, "flags (d): the batcher accepted decode_impl=blocked")

    cache = finish_cache_probe(probe)
    return dict(plain_launches=plain_launches, plain_rel=rels, blocked_rel=rel_b,
                validate_lines=len(lines), validate_worst=worst, launches=launches,
                compile_cache=cache)


def first_frames_rel(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over the first two frames, over max |want| there."""
    _, rel = rel_err(torch.from_numpy(np.asarray(got, np.float32)),
                     torch.from_numpy(np.asarray(want, np.float32)))
    return rel


@contextlib.contextmanager
def recorded_latents(out: list):
    """While active, every FlowLM frame of the streaming step
    (streaming.flow_frame_step, which fused_stream_step(s) call) appends
    (frame index, pre-step done flags, raw latent [B, latent] in f32) to
    ``out``: the latents of a stream or a batcher run, which their PCM
    chunks do not show. A graph replay runs no Python: with graphs only the
    eager warm-up frames (graphs.WARMUP: a session's frames 0 and 1) and
    the capture append, and the capture's record holds what the last
    replay wrote (its frame index is the last frame's)."""
    step = streaming.flow_frame_step

    def record(w, cache, x, noise, time_embs, frame_idx, eos_step, done, *args, **kw):
        res = step(w, cache, x, noise, time_embs, frame_idx, eos_step, done, *args, **kw)
        raw = (res[2].float() - w.emb_mean.float()) / w.emb_std.float()
        fi = frame_idx if isinstance(frame_idx, int) else frame_idx.clone()
        out.append((fi, done.clone(), raw))
        return res

    streaming.flow_frame_step = record
    try:
        yield out
    finally:
        streaming.flow_frame_step = step


@contextlib.contextmanager
def eager_steps(engine):
    """While active, a batcher or session built on ``engine`` runs its
    frame step eagerly (engine.graphs is False), as TTSEngine(ctx,
    graphs=False) would, on the same weights."""
    saved = engine._graphs_on
    engine._graphs_on = False
    try:
        yield engine
    finally:
        engine._graphs_on = saved


def first_two_latents(records: list, trash_row: bool = False) -> np.ndarray:
    """The latents of every live row at frame 0 or 1, in record order;
    ``trash_row``: leave out the last row (a one-shard pool's trash row,
    which admission padding runs)."""
    rows = []
    for fi, done, raw in records:
        fi = torch.as_tensor(fi, device=raw.device).expand(raw.shape[0])
        live = (fi < 2) & ~done
        if trash_row:
            live[-1] = False
        rows.append(raw[live])
    return torch.cat(rows).cpu().numpy()


def bf16_shapes_ok(shapes: dict, name: str, what: str) -> None:
    by_shape = shapes[name]
    check(by_shape and all(k.startswith("bf16 ") for k in by_shape),
          f"bf16 {what}: {name} launches by shape {by_shape}")


def phase_bf16(model_dir: str, ctx, stream: dict, serve: dict) -> dict:
    """Phase 11: PTTS_DTYPE=bf16 on the card at full width: the packed
    bf16 load, generate_full, Context.stream and the batcher, each against
    the f32 card run of this call (the first two frames' latents within 8%
    of max, the gate of tests/test_bf16.py; the stream's and the batcher's
    recorded from their frame step); per-chunk wall and streams per chip
    beside phases 6 and 8's f32 figures."""
    cfg, mcfg = ctx.flowlm_cfg, ctx.mimi_cfg
    with mock.patch.dict(os.environ, {"PTTS_DTYPE": "bf16"}):
        bctx = api.load_dir(model_dir, device="cuda")
        engine = bctx.engine
    check(engine.dtype == torch.bfloat16, f"bf16: engine dtype {engine.dtype}")

    # (a) the packed load: bit-equal to the same trees packed on the CPU, aligned
    host = (flowlm.to_device(flowlm.load_weights(bctx.weights, cfg, dtype=torch.bfloat16),
                             torch.bfloat16, cfg, "cpu"),
            mimi.to_device(mimi.load_weights(bctx.weights, mcfg), torch.bfloat16, mcfg, "cpu"))
    n_leaves = 0
    for dev_tree, cpu_tree in zip((engine.fw, engine.mw), host):
        for (name, d), (_, c) in zip(dev_tree.named_buffers(), cpu_tree.named_buffers()):
            check(d.device.type == engine.device.type and d.dtype == torch.bfloat16,
                  f"bf16 (a): {name} {d.device} {d.dtype}")
            check(d.data_ptr() % packing.ALIGN == 0, f"bf16 (a): {name} at {d.data_ptr():#x}")
            check(torch.equal(d.cpu().view(torch.int16), c.view(torch.int16)),
                  f"bf16 (a): {name} differs from the CPU pack")
            n_leaves += 1
    del host
    f32_s, bf16_s = ctx.engine.weights_s, engine.weights_s
    print(f"bf16 (a): {n_leaves} leaves bit-equal to the CPU pack, each {packing.ALIGN}-byte "
          f"aligned; weights_s f32 {json.dumps(f32_s)}, bf16 {json.dumps(bf16_s)} "
          f"(checkpoint read, host pack, copy)")

    # (b) generate_full, Context.stream, a 4-slot batcher: against f32, B1/B2 in bf16
    p8 = api.Params(seed=3, num_frames=8, eos_enabled=False)
    want = ctx.engine.generate_full(FLAGS_TEXT, params=p8)
    reset_launches()
    got = engine.generate_full(FLAGS_TEXT, params=p8)
    sync("cuda")
    launches, shapes = read_launches(), read_shapes()
    check(got.frames_used == 8 and np.isfinite(got.audio.samples).all()
          and len(got.audio.samples) == 8 * FRAME_SAMPLES, "bf16 generate_full: frames or PCM")
    bf16_shapes_ok(shapes, "causal_attention_qkv", "generate_full")
    bf16_shapes_ok(shapes, "window_attention_qkv", "generate_full")
    bf16_shapes_ok(shapes, "decode_attention", "generate_full")
    rel_gen = first_frames_rel(got.latents[:2], want.latents[:2])
    check(rel_gen <= 0.08, f"bf16 generate_full: first two latents {rel_gen:.3e} > 8%")

    _, rel_pcm = rel_err(torch.from_numpy(got.audio.samples[: 2 * FRAME_SAMPLES]),
                         torch.from_numpy(want.audio.samples[: 2 * FRAME_SAMPLES]))

    text, p = "Hello world!", api.Params(seed=1, num_frames=8, eos_enabled=False)
    with recorded_latents([]) as rec_f:
        list(ctx.stream(text, params=p))
    reset_launches()
    with recorded_latents([]) as rec_b:
        chunks = list(bctx.stream(text, params=p))
    sync("cuda")
    stream_launches, stream_shapes = read_launches(), read_shapes()
    check(len(chunks) == 8 and all(c.pcm_i16.shape == (FRAME_SAMPLES,) for c in chunks),
          f"bf16 stream: {len(chunks)} chunks")
    bf16_shapes_ok(stream_shapes, "causal_attention_qkv", "stream")
    bf16_shapes_ok(stream_shapes, "decode_attention", "stream")
    check(stream_launches["window_attention_qkv"] == 0, "bf16 stream: B2 launched")
    lat_b, lat_f = first_two_latents(rec_b), first_two_latents(rec_f)
    check(lat_b.shape == lat_f.shape == (2, cfg.latent_dim) and np.isfinite(lat_b).all(),
          f"bf16 stream: first two latents {lat_b.shape} {lat_f.shape}")
    rel_stream = first_frames_rel(lat_b, lat_f)
    check(rel_stream <= 0.08, f"bf16 stream: first two latents {rel_stream:.3e} > 8%")

    # phase 8 (a)'s requests through 4 slots, f32 and bf16 alike: the same
    # schedule, so the records align step by step and row by row. The
    # records need the frame step's Python at every frame, which a graph
    # replay does not run, and the later admissions' first frames fall in
    # replays: these two pools are eager (phase 13 holds the replayed pool
    # bit-equal to the eager one)
    pool = dict(slots=4, admit_chunk=2, prefix_budget=128, max_len=192)
    with recorded_latents([]) as rec_f, eager_steps(ctx.engine):
        serve_batch(ctx.engine, PROMPTS[:6], SERVE_FRAMES, host_prefix=(5,), **pool)
    reset_launches()
    with recorded_latents([]) as rec_b, eager_steps(engine):
        rids, res, _ = serve_batch(engine, PROMPTS[:6], SERVE_FRAMES, host_prefix=(5,), **pool)
    sync("cuda")
    serve_launches, serve_shapes = read_launches(), read_shapes()
    bf16_shapes_ok(serve_shapes, "causal_attention_qkv", "serve")
    bf16_shapes_ok(serve_shapes, "decode_attention", "serve")
    check(serve_launches["window_attention_qkv"] == 0, "bf16 serve: B2 launched")
    for rid, f in zip(rids, SERVE_FRAMES):
        check(res[rid].frames == f and res[rid].pcm_i16.shape == (f * FRAME_SAMPLES,),
              f"bf16 serve rid {rid}: {res[rid].frames} frames, asked {f}")
    lat_b, lat_f = first_two_latents(rec_b, True), first_two_latents(rec_f, True)
    check(lat_b.shape == lat_f.shape == (2 * len(rids), cfg.latent_dim)
          and np.isfinite(lat_b).all(), f"bf16 serve: first two latents {lat_b.shape} "
          f"{lat_f.shape}")
    rel_serve = first_frames_rel(lat_b, lat_f)
    check(rel_serve <= 0.08, f"bf16 serve: first two latents {rel_serve:.3e} > 8%")
    print(f"bf16 (b): first two frames' latents vs the f32 card run: generate_full "
          f"{rel_gen:.3e}, stream {rel_stream:.3e}, batcher (6 requests) {rel_serve:.3e} "
          f"(gate 8e-2); printed only: generate_full PCM of those frames {rel_pcm:.3e}; "
          f"launches by shape: generate_full {shapes}, stream {stream_shapes}, serve "
          f"{serve_shapes}")

    # (c) printed only: per-chunk wall, streams per chip at 64 slots
    rates = [chunk_times(engine, B) for B in (1, 8)]
    load = serve_load(engine, 64, max_seconds=12.0)
    f32_load = next(r for r in serve["load"] if r["slots"] == 64)
    for r, f in zip(rates, stream["rates"]):
        print(f"bf16 (c): B={r['B']} per-chunk wall mean {r['mean_ms']:.3f} ms, max "
              f"{r['max_ms']:.3f} ms (f32 in phase 6: {f['mean_ms']:.3f} / {f['max_ms']:.3f} ms)")
    print(f"bf16 (c): 64 slots closed loop: {load['audio_s_per_s']:.2f} audio s per wall s, "
          f"{load['step_ms']:.3f} ms per step, first chunk p50/p95 "
          f"{load['first_chunk_p50_ms']:.2f}/{load['first_chunk_p95_ms']:.2f} ms (f32 in phase "
          f"8: {f32_load['audio_s_per_s']:.2f}, {f32_load['step_ms']:.3f} ms, "
          f"{f32_load['first_chunk_p50_ms']:.2f}/{f32_load['first_chunk_p95_ms']:.2f} ms)")
    by_path = {name: launches[name] + stream_launches[name] + serve_launches[name]
               for name in KERNELS}
    bctx.close()
    return dict(weights_s={"f32": f32_s, "bf16": bf16_s}, rel_generate=rel_gen,
                rel_generate_pcm=rel_pcm, rel_stream=rel_stream, rel_serve=rel_serve,
                rates=rates, load=load,
                f32_rates=stream["rates"], f32_load=f32_load, launches=by_path,
                shapes={"generate_full": shapes, "stream": stream_shapes, "serve": serve_shapes})


# phase 13: phase 8 (a)'s requests at 30-32 frames through 4 slots of a pool
# whose FlowLM decode ring is 32 columns (max_len - prefix_budget): every
# request outlasts the Mimi ring's 24-frame cycle and the pool's cursor laps
# the FlowLM ring
GRAPH_FRAMES = (30, 31, 32, 30, 31, 32)
GRAPH_POOL = dict(slots=4, admit_chunk=2, prefix_budget=128, max_len=160)


def graph_pool_bytes() -> int:
    """Bytes of the allocator's segments that belong to a CUDA graph's
    private pool (torch.cuda.memory_snapshot: pool id other than (0, 0))."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def count_syncs(fn):
    """(fn(), the host syncs PyTorch flags while it runs), from
    torch.cuda.set_sync_debug_mode("warn"): every synchronizing operation
    (.item(), bool(), .cpu(), a copy to pageable memory) warns once."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def same_results(got: dict, want: dict, rids, what: str) -> None:
    for rid in rids:
        check(got[rid].frames == want[rid].frames,
              f"{what} rid {rid}: {got[rid].frames} frames, eager {want[rid].frames}")
        check(np.array_equal(got[rid].pcm_i16, want[rid].pcm_i16),
              f"{what} rid {rid}: replayed PCM differs from eager")


def same_generate(a, b, what: str) -> None:
    check(a.frames_used == b.frames_used, f"{what}: frames {a.frames_used} vs {b.frames_used}")
    for name in ("latents", "first_cond", "first_flow"):
        check(np.array_equal(getattr(a, name), getattr(b, name)),
              f"{what}: {name} differs from eager")
    check(np.array_equal(a.audio.samples, b.audio.samples), f"{what}: PCM differs from eager")


def phase_graphs(ctx, smi: str) -> dict:
    """Phase 13: the frame loops replayed as CUDA graphs (runtime/graphs)
    against the same loops run eagerly (TTSEngine(ctx, graphs=False)), in
    this process. Launch counts are summed over the phase's runs, graph and
    eager alike (both are the main path, with graphs on and off)."""
    from ptts_torch.runtime import graphs as rgraphs

    engine = ctx.engine
    eager = TTSEngine(ctx, graphs=False)
    check(engine.graphs and not eager.graphs, "graphs: the default card engine does not "
          "replay graphs, or graphs=False does")
    served = dict.fromkeys(KERNELS, 0)

    def on_path(fn, *args, **kw):
        reset_launches()
        out = fn(*args, **kw)
        for name, n in read_launches().items():
            served[name] += n
        return out

    stats0 = dict(rgraphs.STATS)
    pool0, reserved0 = graph_pool_bytes(), torch.cuda.memory_reserved()

    # (a) offline: f32 and bf16, EOS on with ragged budgets and EOS off
    bf16 = (TTSEngine(ctx, dtype=torch.bfloat16), TTSEngine(ctx, dtype=torch.bfloat16,
                                                             graphs=False))
    runs = (api.Params(seed=11), api.Params(seed=12, num_frames=40, eos_enabled=False))
    offline = {}
    for label, (g, e) in (("f32", (engine, eager)), ("bf16", bf16)):
        for p in runs:
            tag = f"{label} EOS {'on' if p.eos_enabled else 'off'}"
            a = on_path(g.generate_full, PROMPTS[1], params=p)
            same_generate(a, on_path(e.generate_full, PROMPTS[1], params=p),
                          f"graphs (a) generate_full {tag}")
            offline[tag] = a.frames_used
        p = api.Params(seed=13)
        got = on_path(g.batch_generate, PROMPTS[:4], params=p)
        want = on_path(e.batch_generate, PROMPTS[:4], params=p)
        for i, (x, y) in enumerate(zip(got, want)):
            check(np.array_equal(x.samples, y.samples),
                  f"graphs (a) batch_generate {label} stream {i}: PCM differs from eager")
        offline[f"{label} batch frames"] = [len(x.samples) // FRAME_SAMPLES for x in got]
    del bf16
    print(f"graphs (a): generate_full and a 4-stream ragged batch_generate, f32 and bf16, EOS "
          f"on and off, bit-equal replayed and eager; frames {offline}")

    # (a) StreamingSession at B = 1 and 8, 32 frames (past the Mimi ring's 24)
    p32 = api.Params(seed=5, num_frames=32, eos_enabled=False)
    for B in (1, 8):
        a = on_path(lambda: list(StreamingSession.start(engine, PROMPTS[:B], params=p32)))
        b = on_path(lambda: list(StreamingSession.start(eager, PROMPTS[:B], params=p32)))
        check(len(a) == len(b) == 32, f"graphs (a) session B={B}: {len(a)} / {len(b)} chunks")
        for i, (x, y) in enumerate(zip(a, b)):
            check(np.array_equal(x.pcm_i16, y.pcm_i16) and np.array_equal(x.active, y.active),
                  f"graphs (a) session B={B} chunk {i}: replayed differs from eager")
    print("graphs (a): StreamingSession B=1 and B=8, 32 frames: every chunk bit-equal")

    # (a) the batcher at K = 1 and K = 4 with split_admit, and the 2 x 2 mesh
    hmesh, _, _ = mesh_layouts()
    laps = {}
    for label, kw in (("K=1", dict(frames_per_step=1)),
                      ("K=4 split", dict(frames_per_step=4, split_admit=True)),
                      ("K=1 mesh", dict(frames_per_step=1, mesh=hmesh))):
        rids, got, b = on_path(serve_batch, engine, PROMPTS[:6], GRAPH_FRAMES,
                               host_prefix=(5,), **GRAPH_POOL, **kw)
        _, want, be = on_path(serve_batch, eager, PROMPTS[:6], GRAPH_FRAMES,
                              host_prefix=(5,), **GRAPH_POOL, **kw)
        check(b._graphs is not None and len(b._graphs) > 0 and be._graphs is None,
              f"graphs (a) batcher {label}: no step was replayed")
        ring = b.max_len - b.prefix_budget
        lap = (int(b.shards[0].cache.cursor) - b.prefix_budget) / ring
        check(lap > 1, f"graphs (a) batcher {label}: the cursor did not lap the ring ({lap:.2f})")
        same_results(got, want, rids, f"graphs (a) batcher {label}")
        laps[label] = dict(ring_laps=lap, shards=len(b.shards), graphs=len(b._graphs))
    print(f"graphs (a): phase 8 (a)'s requests at {GRAPH_FRAMES} frames through 4 slots, "
          f"replayed vs eager: frames and int16 PCM equal; {laps}")
    for name, label in (("causal_attention_qkv", "B1"), ("window_attention_qkv", "B2")):
        check(served[name] > 0, f"graphs: {label} was not launched on the phase's paths")
    sync("cuda")
    pool1, reserved1 = graph_pool_bytes(), torch.cuda.memory_reserved()

    # (b) printed only, graph against eager in this call
    rates = {label: [chunk_times(e, B) for B in (1, 8)]
             for label, e in (("graphs", engine), ("eager", eager))}
    load = {label: serve_load(e, 64, max_seconds=5.0, profile_steps=8)
            for label, e in (("graphs", engine), ("eager", eager))}
    prof = {label: profile_steps(e, table=False) for label, e in (("graphs", engine),
                                                                    ("eager", eager))}
    text, p = PROMPTS[1], api.Params(seed=11)
    syncs, checks = {}, {}
    for label, e in (("graphs", engine), ("eager", eager)):
        before = flowlm.HOST_CHECKS
        syncs[label] = count_syncs(lambda: e.generate_full(text, params=p))[1]
        checks[label] = flowlm.HOST_CHECKS - before
    cfg, mcfg = bench.configs()
    fw, mw = bench.device_weights(torch.bfloat16, torch.device("cuda"), cfg, mcfg)
    value = {}
    for label, on in (("eager", False), ("graphs", True)):
        off = bench.OfflineBench(fw, mw, BENCH_BATCH, BENCH_FRAMES, torch.bfloat16, cfg, mcfg,
                                 graphs=on)
        streams, wall, compile_s = off.measure("on", 1, verbose=False)
        value[label] = dict(streams=streams, wall_s=wall, compile_s=compile_s)
        del off
    del fw, mw
    torch.cuda.empty_cache()
    stats2 = dict(rgraphs.STATS)
    captures = stats2["captures"] - stats0["captures"]
    capture_s = stats2["capture_s"] - stats0["capture_s"]

    print(f"graphs (b), {smi}:")
    for label in ("graphs", "eager"):
        for r in rates[label]:
            print(f"  {label}: stream B={r['B']} per-chunk wall mean {r['mean_ms']:.3f} ms, p50 "
                  f"{r['p50_ms']:.3f} ms, max {r['max_ms']:.3f} ms over {r['frames']} frames "
                  f"(session start {r['start_ms']:.3f} ms, first step {r['first_ms']:.3f} ms)")
        pr, r = prof[label], load[label]
        rp = r["profile"]
        print(f"  {label}: stream B=1 profiled step: launch calls {pr['launches_per_step']}, "
              f"{pr['kernels_per_step']:.1f} device kernels, {pr['device_us_per_step']:.1f} us "
              f"device of {pr['profiled_wall_us_per_step']:.1f} us wall (busy share "
              f"{pr['busy_share']:.3f})")
        print(f"  {label}: 64 slots closed loop: {r['audio_s_per_s']:.2f} streams per chip "
              f"(audio s per wall s), {r['step_ms']:.3f} ms per step, dispatch "
              f"{r['phase_ms_per_step']['dispatch']:.3f} ms per step, phases ms/step "
              f"{ {k: round(v, 3) for k, v in r['phase_ms_per_step'].items()} }; profiled step: "
              f"launch calls {rp['launches_per_step']}, {rp['device_us_per_step']:.1f} us device "
              f"of {rp['profiled_wall_us_per_step']:.1f} us wall (busy share "
              f"{rp['busy_share']:.3f})")
        v = value[label]
        print(f"  {label}: offline bench value (mode on, B={BENCH_BATCH}, {BENCH_FRAMES} frames, "
              f"bf16) {v['streams']:.1f} streams/chip, wall {v['wall_s']:.4f} s, first pass "
              f"(compile_s) {v['compile_s']:.2f} s; host syncs in one f32 generate_full "
              f"{syncs[label]}, of which done checks {checks[label]}")
    print(f"  captures in this phase {captures}, {capture_s:.3f} s in all "
          f"({capture_s / max(captures, 1) * 1e3:.1f} ms each); graph pools "
          f"{pool1 / 2**20:.1f} MiB after (a) (from {pool0 / 2**20:.1f} MiB), memory_reserved "
          f"+{(reserved1 - reserved0) / 2**20:.1f} MiB over (a)")
    return dict(offline_frames=offline, batcher=laps, rates=rates, load=load, profile=prof,
                host_syncs=syncs, done_checks=checks, bench_value=value, captures=captures,
                capture_s=capture_s, replays=stats2["replays"] - stats0["replays"],
                graph_pool_mib=pool1 / 2**20,
                reserved_growth_mib=(reserved1 - reserved0) / 2**20, launches=served,
                device=smi)


# phase 12 (b), (c): ptts_torch.bench and bench_streaming at a reduced size
BENCH_ENV = {"PTTS_BENCH_BATCH": "16", "PTTS_BENCH_FRAMES": "16", "PTTS_BENCH_REPEATS": "1",
             "PTTS_BENCH_BATCHER_REQS": "64", "PTTS_BENCH_DEVICE_SLOTS": "64",
             "PTTS_BENCH_WARMUP_STEPS": "2", "PTTS_HTTP_REQS": "24", "PTTS_HTTP_CLIENTS": "4"}
BENCH_LEGS = ("eos_off_streams", "ragged_eos_streams", "ragged_bucketed_streams",
              "sustained_batcher_streams", "sustained_batcher_streams_pipelined_spec",
              "batcher_lowlat_streams", "batcher_device_streams", "batcher_device_spec_streams",
              "batcher_device_serial_streams", "sustained_batcher_streams_prepared",
              "http_reqs_per_s", "http_wav_reqs_per_s")
STREAMING_ARGS = ["--batch", "8", "--frames", "16", "--repeats", "1"]


def phase_bench(model_dir: str, smi: str) -> dict:
    """Phase 12 (b) and (c): the bench in its own process and the streaming
    bench through its main() in this one, on phase 4's checkpoint, at a
    reduced size (BENCH_ENV, STREAMING_ARGS)."""
    card = smi.splitlines()[0].rsplit(",", 1)[0].strip()
    env = {**os.environ, **BENCH_ENV, "PTTS_BENCH_MODEL_DIR": model_dir}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ptts_torch.bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=600)
    bench_s = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith(("[bench]", "[http")):
            print(f"  {line}")
    check(proc.returncode == 0, f"bench: rc {proc.returncode}; stderr {proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"bench: {len(lines)} stdout lines, expected one JSON line")
    r = json.loads(lines[0])
    d = r["detail"]
    check(r["metric"] == "concurrent_realtime_streams" and "vs_baseline" not in r,
          f"bench: metric {r['metric']}, keys {sorted(r)}")
    check(d["failed_legs"] == {}, f"bench: failed legs {d['failed_legs']}")
    for key in ("value",) + BENCH_LEGS:
        value = r["value"] if key == "value" else d.get(key)
        check(value is not None and value > 0, f"bench: {key} = {value}")
    check(d["http_stream_errors"] == 0 and d["http_wav_errors"] == 0,
          f"bench: HTTP errors {d['http_stream_errors']} / {d['http_wav_errors']}")
    check(d["platform"] == "gpu" and d["device"]["name"] == card,
          f"bench: device {d['device']} on {d['platform']}, phase 1 read {card!r}")
    for name in POCKET_KERNELS:
        check(d["kernels"]["launches"][name] > 0,
              f"bench: {name} was not launched in the bench's process")
    # the shapes launched in the bench's process and in its HTTP leg's
    shapes = {name: parse_shapes(d["kernels"]["shapes"])[name]
              + parse_shapes(d["http_kernels"]["shapes"])[name] for name in KERNELS}
    print(f"bench (b): {bench_s:.1f} s, {r['value']:.1f} streams/chip offline (B=16, 16 "
          f"frames), batcher {d['sustained_batcher_streams']:.1f} (first chunk p50 "
          f"{d['batcher_first_chunk_p50_ms']:.1f} ms), device-bound "
          f"{d['batcher_device_streams']:.1f}, HTTP {d['http_reqs_per_s']:.2f} req/s; "
          f"seconds by leg {d['leg_s']}; kernels {d['kernels']}; HTTP leg's kernels "
          f"{d['http_kernels']}")

    reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_streaming.main(STREAMING_ARGS)
    streaming_s = time.perf_counter() - t0
    streaming_launches = read_launches()
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"bench_streaming: rc {rc}, stdout {lines}")
    st = json.loads(lines[0])
    sd = st["detail"]
    check(st["metric"] == "p50_time_to_first_chunk_ms" and st["value"] > 0
          and sd["steady_frame_ms"] > 0 and sd["device"]["name"] == card,
          f"bench_streaming: {st}")
    check(streaming_launches["causal_attention_qkv"] > 0,
          f"bench_streaming: B1 was not launched ({streaming_launches})")
    print(f"bench (c): bench_streaming {streaming_s:.1f} s, first chunk {st['value']:.2f} ms, "
          f"{sd['steady_frame_ms']:.3f} ms per frame (B=8); launches {streaming_launches}, "
          f"by shape {read_shapes()}")
    return dict(bench=r, bench_s=bench_s, streaming=st, streaming_s=streaming_s, shapes=shapes,
                launches=d["kernels"]["launches"], streaming_launches=streaming_launches)


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jax_golden")
# the batcher sweep at 64 slots, K = 1 and 8, serial and pipelined, 100
# requests (the sweep's own floor, as in the JAX tool's, makes each point
# finish max(100 * 64 / 256, 200) = 200), at most 5 s a point
BATCHER_SWEEP = ["--slots", "64", "--k", "1,8", "--modes", "serial,pipe", "--reqs", "100",
                 "--max-seconds", "5"]
BATCH_SWEEP = (["16", "32"], {"PTTS_BENCH_FRAMES": "10", "PTTS_BENCH_REPEATS": "1"})


def json_lines(fn, *args) -> list:
    """fn(*args) with its standard output captured: rc 0, and each line a
    JSON object, printed again indented."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    check(rc == 0, f"{fn.__module__}: rc {rc}")
    rows = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    for row in rows:
        print(f"  {json.dumps(row)}")
    return rows


def trap_line(what: str, trap: dict, smi: str) -> str:
    return (f"tools (a): NaN trap {what} ({trap['dtype']}, graphs off): {trap['ops']} aten ops "
            f"and kernel wrapper calls {trap['kernel_calls']} checked in "
            f"{trap['seconds']:.3f} s (again: {trap['seconds_warm']:.3f} s), the same generate "
            f"warm and untrapped {trap['plain_seconds']:.3f} s; {smi.splitlines()[0]}")


def phase_tools(model_dir: str, smi: str) -> dict:
    """Phase 14: the port's tools on the card. (a) ptts_torch.tools.sanitize
    phases 1-4 at full width on phase 4's checkpoint, and phase 2 again on
    a bf16 engine; (b) flowlm_parity against the JAX package's full-width
    dumps (tests/data/jax_golden/, made from ``synth.write_model_dir(dir,
    seed=0)``, whose SHA-256 must match meta.json first): f32 taps within
    the card-against-CPU gates (latents 1e-3, cond and flow 1e-4 of max),
    the WAV within 33 LSB; (c) both sweeps at a reduced grid, in this
    process. Launch counts are set to 0 first and read after: both kernels
    must have launched (phase 1's raw launches do not count)."""
    reset_launches()
    card = smi.splitlines()[0]
    # (a)
    failures, res = sanitize.run_phases(model_dir, "cuda")
    check(not failures, f"sanitize: {failures} failed")
    guarded, trap = res[1], res[2]
    print(f"tools (a): guarded launches {guarded['cases']} cases (B1 and B2, f32 and bf16), "
          f"largest error against the plain version f32 {guarded['max_rel']['f32']:.3e}, bf16 "
          f"{guarded['max_rel']['bf16']:.3e} of max, {guarded['seconds']:.3f} s; {card}")
    print(trap_line("generate", trap, smi))
    ctx = api.load_dir(model_dir, device="cuda")
    trap_bf16 = sanitize.phase_nan_trap(ctx, torch.bfloat16, verbose=False)
    ctx.close()
    print(trap_line("generate", trap_bf16, smi))

    # (b)
    bad = flowlm_parity.meta_mismatch(GOLDEN, model_dir)
    check(bad is None, f"flowlm_parity: {bad}")
    with open(os.path.join(GOLDEN, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    env = {k: v for k, v in os.environ.items() if k != "PTTS_DTYPE"}
    with tempfile.TemporaryDirectory(prefix="ptts_parity_") as tmp, \
            mock.patch.dict(os.environ, env, clear=True):
        ours = flowlm_parity.run_ours(model_dir, meta["prompt"], meta["frames"], meta["seed"],
                                      tmp, device="cuda", wave=True)
    want = flowlm_parity.load_dumps(GOLDEN)
    parity = flowlm_parity.compare(ours, want, 0.0, flowlm_parity.CARD_GATES)
    scale = float(np.abs(want["latents"]).max())
    by_frame = [float(np.abs(g - w).max()) / scale for g, w in
                zip(ours["latents"].reshape(meta["frames"], -1),
                    want["latents"].reshape(meta["frames"], -1))]
    print("tools (b): card against the JAX package (f32, full width): "
          + ", ".join(f"{k} {v:.3e}" for k, v in parity["rel"].items())
          + f" of max; latents by frame {[f'{v:.2e}' for v in by_frame]}; WAV "
          f"{parity['wave_lsb']} LSB, clipped {parity['clipped']:.4f}; {card}")
    check(parity["ok"], f"flowlm_parity against {GOLDEN}: {parity}")

    # (c)
    with mock.patch.dict(os.environ, {"PTTS_BENCH_WARMUP_STEPS": "2",
                                      "PTTS_BENCH_MODEL_DIR": model_dir}):
        t0 = time.perf_counter()
        batcher = json_lines(bench_batcher_sweep.main, BATCHER_SWEEP)
        batcher_s = time.perf_counter() - t0
        with mock.patch.dict(os.environ, BATCH_SWEEP[1]):
            t0 = time.perf_counter()
            offline = json_lines(bench_batch_sweep.main, BATCH_SWEEP[0])
            offline_s = time.perf_counter() - t0
    check(len(batcher) == 4 and all(r["streams"] > 0 and r["finished"] > 0 for r in batcher),
          f"bench_batcher_sweep: {batcher}")
    check(len(offline) == 3 and offline[-1]["best"] in offline[-1]["sweep"]
          and all(r["streams_on"] > 0 for r in offline[:2]), f"bench_batch_sweep: {offline}")
    check(all(r["device"]["name"] == card.rsplit(",", 1)[0].strip()
              for r in batcher + offline[:2]), "sweeps: device name differs from phase 1's")
    launches, shapes = read_launches(), read_shapes()
    for name in POCKET_KERNELS:
        check(launches[name] > 0, f"{name} was not launched by the tools")
    print(f"tools (c): batcher sweep {batcher_s:.1f} s, offline sweep {offline_s:.1f} s; "
          f"launches {launches}; by shape {shapes}")
    return dict(guarded=guarded, trap=trap, trap_bf16=trap_bf16, parity=parity,
                latents_by_frame=by_frame, batcher_sweep=batcher, batcher_sweep_s=batcher_s,
                batch_sweep=offline, batch_sweep_s=offline_s, launches=launches)


PHASE_S = {}


def timed(label: str, fn, *args, **kw):
    """fn(*args, **kw), its wall seconds printed and kept in PHASE_S."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_S[label] = time.perf_counter() - t0
    print(f"phase {label}: {PHASE_S[label]:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = timed("1 device", phase_device)
    timed("2 build", phase_build)
    with tempfile.TemporaryDirectory(prefix="ptts_synth_") as tmp:
        os.environ["PTTS_PROFILE_DIR"] = os.path.join(tmp, "profile")
        t0 = time.perf_counter()
        model_dir = synth.write_model_dir(tmp, seed=0)
        print(f"synthetic full-size checkpoint: {time.perf_counter() - t0:.2f} s")
        offline = timed("12a bench offline", phase_bench_offline, model_dir)
        ctx, launches = timed("4 slice", phase_slice, model_dir)
        cpu_ctx = api.load_dir(model_dir, device="cpu")
        timed("5 parity", phase_parity, cpu_ctx, ctx)
        # the three kernels' plain versions on the card, by the switches alone
        plain_engine = TTSEngine(ctx, flags=KernelFlags(prefill_impl="plain",
                                                        window_impl="plain",
                                                        decode_impl="einsum"))
        stream = timed("6 stream", phase_stream, ctx, cpu_ctx, plain_engine)
        cli_launches = timed("7 cli", phase_cli, model_dir, ctx)
        serve = timed("8 serve", phase_serve, ctx, cpu_ctx)
        mesh = timed("9 mesh", phase_mesh, ctx, serve["pool_a"])
        flags = timed("10 flags", phase_flags, ctx, plain_engine, tmp)
        del plain_engine
        bf16 = timed("11 bf16", phase_bf16, model_dir, ctx, stream, serve)
        graphs_run = timed("13 graphs", phase_graphs, ctx, smi)
        ctx.close()
        cpu_ctx.close()
        bench_run = timed("12bc bench", phase_bench, model_dir, smi)
        tools = timed("14 tools", phase_tools, model_dir, smi)
    reset_launches()   # the last path's shapes into SEEN
    seen = {name: SEEN[name] + bench_run["shapes"][name] for name in KERNELS}
    results = timed("3 kernels", phase_kernels, seen)
    decode_cases = timed("3d decode", phase_decode, seen["decode_attention"])
    ssm_run = timed("3e ssm", phase_ssm, seen["ssm_step"])
    by_path = {name: {"slice": launches[name], "stream": stream["launches"][name],
                      "cli": cli_launches[name], "serve": serve["launches"][name],
                      "mesh": mesh["launches"][name],
                      "flags_plain": flags["plain_launches"][name],
                      "flags_blocked": flags["launches"][name], "bf16": bf16["launches"][name],
                      "bench_offline": offline["launches"][name],
                      "bench": bench_run["launches"][name],
                      "bench_streaming": bench_run["streaming_launches"][name],
                      "graphs": graphs_run["launches"][name],
                      "tools": tools["launches"][name]}
               for name in KERNELS}
    print(json.dumps({"stream": {k: stream[k] for k in ("ttfc_first_ms", "ttfc_warm_ms", "lsb",
                                                        "rates", "profile", "drift")}}))
    print(json.dumps({"serve": {k: serve[k] for k in ("lsb_a", "first_a", "rel_a", "lsb_b",
                                                      "first_b", "rel_b", "lsb_c", "equality_ms",
                                                      "http", "load", "launches")}}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"flags": flags}))
    print(json.dumps({"bf16": {k: v for k, v in bf16.items() if k != "shapes"}}))
    print(json.dumps({"bench": {"offline_shapes": offline["shapes"],
                                **{k: bench_run[k] for k in ("bench", "bench_s", "streaming",
                                                             "streaming_s")}}}))
    print(json.dumps({"graphs": graphs_run}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"phase_s": PHASE_S, "total_s": time.perf_counter() - t_start,
                      "profiler_lost": PROFILER_LOST}))

    kernels = []
    for name, replaces, headline in (("causal_attention_qkv", f"{PALLAS}:361", (8, 128)),
                                     ("window_attention_qkv", f"{PALLAS}:186", (2, 1024))):
        cases = results[name]
        f32 = [c for c in cases if c["dtype"] == "f32"]
        bf16 = [c for c in cases if c["dtype"] == "bf16"]
        top = next(c for c in f32 if (c["B"], c["T"]) == headline)
        launched = sorted(seen[name])
        held = {(c["dtype"], c["B"], c["T"]) for c in cases}
        check(set(launched) <= held, f"{name}: launched at {sorted(set(launched) - held)} "
              f"with no case in phase 3")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "launches_by_path": by_path[name],
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "library_computes": LIBRARY, "timed_shape": f"f32 B={top['B']} T={top['T']}",
            "max_rel_err_f32": max(c["max_rel_err"] for c in f32),
            "max_rel_err_bf16": max(c["max_rel_err"] for c in bf16),
            "launched_shapes": {f"{d} B={b} T={t}": seen[name][(d, b, t)]
                                for d, b, t in launched},
            "cases": cases,
        })
    print(json.dumps({"kernels": kernels}))
    # the decode attention on every path but flags (a)'s plain engine and (b)-(c)'s
    # einsum and blocked runs; a case for every launched shape
    decode_paths, launched = by_path["decode_attention"], sorted(seen["decode_attention"])
    print(json.dumps({"decode_kernel": {
        "launches_by_path": decode_paths,
        "launched_shapes": {f"{d} B={b} T={t}": seen["decode_attention"][(d, b, t)]
                            for d, b, t in launched},
        "cases": decode_cases}}))
    for path, n in decode_paths.items():
        check((n == 0) == path.startswith("flags"), f"decode_attention launched {n} times on "
              f"the {path} path")
    held = {(c["dtype"], c["B"], c["T"]) for c in decode_cases}
    check(set(launched) <= held, f"decode_attention: launched at {sorted(set(launched) - held)} "
          f"with no case in phase 3d")
    # the Mamba-2 frame step on phase 3e's hybrid path alone
    ssm_paths = dict(by_path["ssm_step"], hybrid=ssm_run["hybrid"]["launches"])
    print(json.dumps({"ssm_kernel": {"launches_by_path": ssm_paths,
                                     "hybrid": ssm_run["hybrid"], "cases": ssm_run["cases"]}}))
    for path, n in ssm_paths.items():
        check((n > 0) == (path == "hybrid"), f"ssm_step launched {n} times on the {path} path")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
