"""Streaming latency bench: time to the first 80 ms chunk and the per-frame
cost (port of tools/bench_streaming.py).

Measures the serving path of B lockstep streams: prefill, then one
runtime/streaming.fused_stream_step per frame (FlowLM frame + one
streaming-Mimi chunk), to the first PCM chunk landed on the host (where
audio could be shipped to a client). The steady per-frame cost is the
slope between two frame counts, each ended by a fence (synchronize, then a
scalar readback), so the fence's fixed cost cancels. Per-frame host
readback of every chunk is timed serial and pipelined (a non-blocking copy
into pinned host memory, waited for one frame later). On the card each frame
is one CUDA graph replay (runtime/graphs), captured in the warm-up run, over
state that every run refills in place; ``detail.graphs`` says so.

    python -m ptts_torch.tools.bench_streaming [--batch 256] [--frames 50]
        [--prefix 64] [--dtype bf16] [--repeats 5]

Prints one JSON line: metric p50_time_to_first_chunk_ms and a detail with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..bench import DTYPES, configs, device_info, device_weights, fence, require_card
from ..models import flowlm, mimi_stream
from ..runtime.graphs import GraphCache
from ..runtime.streaming import fused_stream_step


def run_streaming_bench(batch: int = 256, frames: int = 50, prefix: int = 64,
                        dtype_name: str = "bf16", repeats: int = 5, *, device="cuda",
                        flowlm_cfg=None, mimi_cfg=None) -> dict:
    """Time to first chunk (p50/p90 over ``repeats``), the steady per-frame
    slope, and the per-frame readback cost serial and pipelined, for
    ``batch`` streams of a ``prefix``-column prompt over ``frames`` frames
    (at least 2)."""
    cfg, mcfg = configs(flowlm_cfg, mimi_cfg)
    dt, dev = DTYPES[dtype_name], torch.device(device)
    B, T0, F = batch, prefix, frames
    fw, mw = device_weights(dt, dev, cfg, mcfg)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.standard_normal((B, T0, cfg.d_model)) * 0.02).to(dt).to(dev)
    lengths = torch.full((B,), T0, dtype=torch.int32, device=dev)
    # [B, F, latent]: each frame's row is gathered on the device at the frame index
    noise_all = (torch.from_numpy(rng.standard_normal((F, B, cfg.latent_dim)) * 0.8).to(dt)
                 .transpose(0, 1).contiguous().to(dev))
    eos_after = torch.zeros(B, dtype=torch.int32, device=dev)
    prefill_impl = flowlm.resolve_prefill_impl("auto", dev)
    graphs = GraphCache() if dev.type == "cuda" else None
    with torch.inference_mode():
        time_embs = flowlm.lsd_time_embeds(fw, 1, cfg)
        # the state every run refills in place: the graph's fixed addresses
        cache = flowlm.make_cache(cfg, B, T0 + F, dt, dev)
        state = mimi_stream.init_state(mw, mcfg, B, dt)
        x = torch.zeros(B, cfg.d_model, dtype=dt, device=dev)
        eos_step = torch.full((B,), -1, dtype=torch.int32, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        frame = torch.zeros((), dtype=torch.int32, device=dev)

    def start():
        _, x0 = flowlm.prefill(fw, cache, prompt, lengths, cfg, prefill_impl)
        x.copy_(x0)
        eos_step.fill_(-1)
        done.zero_()
        frame.zero_()
        mimi_stream.reset_state(state)

    def body():
        _, _, x1, pcm, _, eos1, done1 = fused_stream_step(
            fw, mw, cache, state, x, noise_all, time_embs, frame, eos_step, done, cfg, mcfg,
            False, -4.0, 1, eos_after)
        x.copy_(x1)
        eos_step.copy_(eos1)
        done.copy_(done1)
        frame.add_(1)
        return pcm

    def step():
        return body() if graphs is None else graphs.run("frame", dev, body)

    @torch.inference_mode()
    def run(n_frames: int, readback_first: bool) -> tuple:
        """(time to first chunk on the host or None, total), both from the
        start of the prefill, ended by a fence."""
        t_start = time.perf_counter()
        start()
        first = pcm = None
        for i in range(n_frames):
            pcm = step()
            if i == 0 and readback_first:
                pcm.cpu()  # the first chunk on the host (a synchronous copy)
                first = time.perf_counter() - t_start
        fence(pcm[:1, :8].float().sum())
        return first, time.perf_counter() - t_start

    @torch.inference_mode()
    def run_readback(n_frames: int, pipelined: bool) -> float:
        """Every chunk read back to the host. Pipelined: frame i's copy into
        pinned host memory is started without waiting and waited for after
        frame i + 1 is issued, so the device computes while the chunk
        crosses."""
        start()
        pend = None
        t_start = time.perf_counter()
        for i in range(n_frames):
            pcm = step()
            if not pipelined:
                pcm.cpu()
                continue
            pcm.to("cpu", non_blocking=True)
            ready = None
            if dev.type == "cuda":
                ready = torch.cuda.Event()
                ready.record()
            if pend is not None:
                pend.synchronize()
            pend = ready
        if pend is not None:
            pend.synchronize()
        return time.perf_counter() - t_start

    run(F, readback_first=False)  # warm-up (and kernel build on a fresh machine)
    firsts, slopes, rb_serial, rb_piped = [], [], [], []
    half = max(F // 2, 1)
    for _ in range(repeats):
        first, _ = run(1, readback_first=True)
        firsts.append(first * 1000)
        _, t_half = run(half, readback_first=False)
        _, t_full = run(F, readback_first=False)
        slopes.append((t_full - t_half) / (F - half) * 1000)
        rb_serial.append((run_readback(F, False) - run_readback(half, False))
                         / (F - half) * 1000)
        rb_piped.append((run_readback(F, True) - run_readback(half, True)) / (F - half) * 1000)

    steady = float(np.median(slopes))
    return {
        "metric": "p50_time_to_first_chunk_ms",
        "value": float(np.percentile(firsts, 50)),
        "unit": "ms",
        "detail": {
            "batch": B,
            "frames": F,
            "prefix": T0,
            "repeats": repeats,
            "p90_first_ms": float(np.percentile(firsts, 90)),
            "steady_frame_ms": steady,
            "readback_frame_serial_ms": float(np.median(rb_serial)),
            "readback_frame_pipelined_ms": float(np.median(rb_piped)),
            "streaming_streams_per_chip": B * 80.0 / steady,
            "realtime_budget_ms_per_frame": 80.0,
            "dtype": dtype_name,
            "graphs": graphs is not None,
            "device": device_info() if dev.type == "cuda" else {"name": dev.type},
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--prefix", type=int, default=64)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not require_card("ptts_torch.tools.bench_streaming"):
        return 2
    print(json.dumps(run_streaming_bench(args.batch, args.frames, args.prefix, args.dtype,
                                         args.repeats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
