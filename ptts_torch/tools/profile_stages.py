"""Device time per stage of the offline pipeline (port of
tools/profile_stages.py).

Each stage -- prefill, ar (the FlowLM frame loop), scale (latent scaling),
upsample (Mimi's quantizer projection and 12.5 -> 200 Hz upsample),
transformer (Mimi's windowed transformer, B2) and convstack (the SEANet
decoder) -- runs warm under utils/profiling.device_trace, on the offline
bench's inputs (ptts_torch.bench.bench_inputs); this prints the device-time
table (format_summary) and the device busy time (busy_us) of each, then
one JSON line with every stage's figures: busy_us and wall_us of its
profiled window (the host clock from the window's first call to the fence
after its last, profiler overhead included) and their ratio busy_share;
wall_unprofiled_us of one more warm pass with no profiler, and
busy_us / wall_unprofiled_us as busy_share_unprofiled. A stage's inputs
are made and waited for before each timed pass: the ar window holds
generate_latents_while alone, on a cache prefilled just before it, and
its per_frame_* figures divide by its frames. Windows stay
short: one pass per stage, and the ar stage over its first 8 frames
(exporting a large trace has brought a run down). On the card the ar stage
replays the frame loop as a CUDA graph (runtime/graphs), as the engine
does, captured in its warm-up passes; the JSON line says ``graphs``.

    python -m ptts_torch.tools.profile_stages [stage ...]     # default: all
Env: PTTS_BENCH_BATCH (256), PTTS_BENCH_FRAMES (50), PTTS_BENCH_DTYPE (bf16).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ..bench import (DTYPES, T0, bench_inputs, configs, device_info, device_weights, fence,
                     require_card)
from ..models import flowlm, mimi
from ..models.flowlm import _linear
from ..ops.conv import convtr1d_2s
from ..runtime.graphs import GraphCache
from ..utils import profiling

STAGES = ("prefill", "ar", "scale", "upsample", "transformer", "convstack")
AR_FRAMES = 8   # frames in the ar stage's profiled window
WARMUP = 2      # untraced passes of a stage before its traced one


@torch.inference_mode()
def run_profile_stages(stages=("all",), batch: int = 256, frames: int = 50,
                       dtype_name: str = "bf16", verbose: bool = True, *, device="cuda",
                       flowlm_cfg=None, mimi_cfg=None) -> dict:
    """{stage: {"busy_us", "wall_us", "busy_share", "wall_unprofiled_us",
    "busy_share_unprofiled", "device_events", "trace_dir"}} for each stage
    asked for ("all" for every one), and for ar also "frames" and
    "per_frame_{busy,wall,wall_unprofiled}_us"; each profiled window holds
    one warm pass of the stage, its inputs made and waited for before the
    window opens."""
    unknown = set(stages) - set(STAGES) - {"all"}
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}: expected {STAGES} or all")
    cfg, mcfg = configs(flowlm_cfg, mimi_cfg)
    dt, dev = DTYPES[dtype_name], torch.device(device)
    fw, mw = device_weights(dt, dev, cfg, mcfg)
    inp = bench_inputs(batch, frames, cfg, dt, dev)
    prefix, noise, lengths = inp["prefix"], inp["noise"], inp["lengths"]
    frame_bucket = noise.shape[1]
    max_len = T0 + frame_bucket
    pimpl = flowlm.resolve_prefill_impl("auto", dev)
    win = mimi.resolve_window_impl("auto", dev)
    graphs = GraphCache() if dev.type == "cuda" else None
    results = {}

    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def profiled(label, fn, *args, setup=None):
        """fn(*args, *setup()) warm, once timed with no profiler, then once
        in a profiled window; setup (fresh inputs for each call) runs and is
        waited for outside the timed passes."""
        if "all" not in stages and label not in stages:
            return None
        made = setup or (lambda: ())
        for _ in range(WARMUP):
            out = fn(*args, *made())
        fence(out.float().sum())
        extra = made()
        wait()
        t0 = time.perf_counter()
        out = fn(*args, *extra)
        fence(out.float().sum())
        unprofiled_us = 1e6 * (time.perf_counter() - t0)
        extra = made()
        wait()
        with profiling.device_trace(label, force=True) as trace_dir:
            t0 = time.perf_counter()
            out = fn(*args, *extra)
            fence(out.float().sum())
            wall_us = 1e6 * (time.perf_counter() - t0)
        ops = profiling.summarize_trace(trace_dir)
        busy = profiling.busy_us(trace_dir)
        results[label] = dict(busy_us=busy, wall_us=wall_us, busy_share=busy / wall_us,
                              wall_unprofiled_us=unprofiled_us,
                              busy_share_unprofiled=busy / unprofiled_us,
                              device_events=sum(v["count"] for v in ops.values()),
                              trace_dir=trace_dir)
        if verbose:
            r = results[label]
            print(f"\n=== {label}: device busy {busy:.1f} us of {wall_us:.1f} us wall "
                  f"(profiled; busy share {r['busy_share']:.3f}), {unprofiled_us:.1f} us wall "
                  f"unprofiled (busy share {r['busy_share_unprofiled']:.3f}), "
                  f"{r['device_events']} device events ===")
            print(profiling.format_summary(trace_dir, n=18))
        return out

    def prefilled():
        return flowlm.prefill_init(fw, prefix, lengths, cfg, max_len, pimpl, graphs=graphs)

    def generate(n_frames, cache, x0):
        return flowlm.generate_latents_while(
            fw, cache, x0, noise, cfg, max_frames=frame_bucket, num_steps=1,
            eos_threshold=1e9, eos_min_frames=1, eos_after=0,
            max_frames_per_stream=torch.full((batch,), n_frames, dtype=torch.int32,
                                             device=dev), graphs=graphs).latents

    # --- FlowLM ---
    profiled("prefill", lambda: prefilled()[1])
    ar_frames = min(frames, AR_FRAMES)
    profiled("ar", generate, ar_frames, setup=prefilled)
    if "ar" in results:
        r = results["ar"]
        r.update(frames=ar_frames, per_frame_busy_us=r["busy_us"] / ar_frames,
                 per_frame_wall_us=r["wall_us"] / ar_frames,
                 per_frame_wall_unprofiled_us=r["wall_unprofiled_us"] / ar_frames)
    lat = generate(frames, *prefilled())[:, :frames]
    scaled = flowlm.scale_latents(fw, lat)
    profiled("scale", flowlm.scale_latents, fw, lat)

    # --- Mimi, split as mimi.decode runs it ---
    def upsample(latents):
        x = _linear(mw.quant_w, None, latents)
        return convtr1d_2s(x, mw.upsample_w1, mw.upsample_w2, None,
                           stride=mcfg.upsample_stride, depthwise=True)

    x200 = upsample(scaled)
    profiled("upsample", upsample, scaled)
    xt = mimi.transformer(mw.transformer, x200, mcfg, win)
    profiled("transformer", mimi.transformer, mw.transformer, x200, mcfg, win)
    profiled("convstack", mimi.conv_stack, mw, xt, mcfg)
    return results


def main(argv=None) -> int:
    stages = (sys.argv[1:] if argv is None else argv) or ["all"]
    if not require_card("ptts_torch.tools.profile_stages"):
        return 2
    batch = int(os.environ.get("PTTS_BENCH_BATCH", "256"))
    frames = int(os.environ.get("PTTS_BENCH_FRAMES", "50"))
    dtype_name = os.environ.get("PTTS_BENCH_DTYPE", "bf16")
    results = run_profile_stages(stages, batch, frames, dtype_name)
    print(json.dumps({"batch": batch, "frames": frames, "dtype": dtype_name,
                      "ar_frames": min(frames, AR_FRAMES), "graphs": True, "stages": results,
                      "device": device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
