#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ptts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, in order; any failure raises, exits non-zero and prints no result:
  1. device  -- CUDA must be available; prints nvidia-smi's name and power limit
  2. build   -- nvcc builds the hand-written kernels from ptts_torch/csrc
  3. kernels -- each CUDA kernel against its plain PyTorch version on the same
                inputs at main-path shapes, f32 (gate 1e-4) and bf16 (5e-2),
                max error relative to the largest reference value; CUDA-event
                times of both. B1 also at the unrounded prefix lengths the
                streaming prefill gives it (T = 37, 100), B2 at T = 1 (--mimi-test)
  4. slice   -- a full-size synthetic checkpoint through ptts_torch.api:
                generate("Hello world!") and a 4-prompt batch_generate; PCM
                finite, frames_used * 1920 samples; both kernels launched
  5. parity  -- the same 8-frame f32 generate (EOS off) on the CPU (plain
                versions) and on the card (kernels): latents and PCM within
                1e-3, frames_used equal, first_cond/first_flow taps within 1e-4
  6. stream  -- Context.stream("Hello world!"): 1920 int16 samples per chunk,
                as many chunks as the offline frames_used, B1 launched; an
                8-frame StreamingSession (EOS off) on the card and the CPU
                within 1e-3; the streamed int16 within 8 LSB of the quantized
                offline PCM; time to first chunk (first call, warm), per-chunk
                wall time at B = 1 and B = 8, and a torch.profiler table of
                warm streaming steps (kernels per step, device busy share)
  7. cli     -- ptts_torch.cli.main on the card: --flow-test with the three
                dump taps (latents within 1e-5 of generate_full), --mimi-test,
                --mimi-wave (frames * 1920 samples), --tokens --verify; both
                kernels launched
Launch counts are set to 0 before each of phases 4, 6 and 7 and read after.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ptts_torch import api, cli, synth  # noqa: E402
from ptts_torch.ops.cuda import build  # noqa: E402
from ptts_torch.ops.cuda import fused_attention as fa  # noqa: E402
from ptts_torch.runtime.streaming import StreamingSession  # noqa: E402
from ptts_tpu.io.wav import load_wav, quantize_i16  # noqa: E402
from ptts_tpu.utils.timing import GLOBAL_STATS  # noqa: E402

SOURCE = "ptts_torch/csrc/fused_attention.cu"
PALLAS = "ptts_tpu/ops/pallas/fused_attention.py"
GATES = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
FRAME_SAMPLES = 1920
KERNELS = ("causal_attention_qkv", "window_attention_qkv")
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


def reset_launches() -> None:
    for name in KERNELS:
        getattr(fa, name).launches = 0


def read_launches() -> dict:
    return {name: getattr(fa, name).launches for name in KERNELS}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    return smi


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


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns per-kernel results."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    results = {"causal_attention_qkv": [], "window_attention_qkv": []}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for T in (64, 128, 37, 100):
            B, H, D = 4, 16, 64
            qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(np.float32))
            qkv = qkv.to(dev, dtype)
            lens_list = [T, T // 2 + 3, 1, T - 7]
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
            ms = cuda_ms(lambda: fa.causal_attention_qkv(qkv, lens, **kw))
            plain_ms = cuda_ms(lambda: fa.causal_attention_qkv_plain(qkv, lens, **kw))
            case = dict(dtype=tag, shape=f"B={B} T={T} H={H} D={D} lengths={lens_list}",
                        max_abs_err=max(abs_a, abs_k), max_rel_err=max(rel_a, rel_k),
                        ms=ms, plain_ms=plain_ms)
            results["causal_attention_qkv"].append(case)
            print(f"B1 causal_attention_qkv {tag} T={T}: attn rel {rel_a:.3e}, k_rot rel "
                  f"{rel_k:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            check(max(rel_a, rel_k) <= GATES[dtype], f"B1 {tag} T={T}: rel err "
                  f"{max(rel_a, rel_k):.3e} > {GATES[dtype]}")
        for T in (1024, 800, 1):
            B, H, D, ctx = 2, 8, 64, 250
            qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * H * D)).astype(np.float32))
            qkv = qkv.to(dev, dtype)
            kw = dict(num_heads=H, head_dim=D, context=ctx)
            got = fa.window_attention_qkv(qkv, **kw)
            want = fa.window_attention_qkv_plain(qkv, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"B2 {tag} T={T}: non-finite output")
            abs_e, rel_e = rel_err(got, want)
            ms = cuda_ms(lambda: fa.window_attention_qkv(qkv, **kw))
            plain_ms = cuda_ms(lambda: fa.window_attention_qkv_plain(qkv, **kw))
            case = dict(dtype=tag, shape=f"B={B} T={T} H={H} D={D} context={ctx}",
                        max_abs_err=abs_e, max_rel_err=rel_e, ms=ms, plain_ms=plain_ms)
            results["window_attention_qkv"].append(case)
            print(f"B2 window_attention_qkv {tag} T={T}: rel {rel_e:.3e}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
            check(rel_e <= GATES[dtype], f"B2 {tag} T={T}: rel err {rel_e:.3e} > {GATES[dtype]}")
    return results


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
    launches = read_launches()

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
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    stats = GLOBAL_STATS.summary()
    print(f"slice: generate {1e3 * (t1 - t0):.1f} ms (first call), generate_full "
          f"{1e3 * (t2 - t1):.1f} ms, batch_generate(4) {1e3 * (t3 - t2):.1f} ms; "
          f"frames_used {out.frames_used}; batch samples {[len(a.samples) for a in batch]}")
    for label in ("FlowLM latents", "Mimi decode"):
        s = stats[label]
        print(f"  span {label}: count {s['count']}, min {s['min_ms']} ms, "
              f"max {s['max_ms']} ms, total {s['total_ms']} ms")
    print(f"slice: kernel launches {launches}")
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
                max_ms=float(np.max(times)), first_ms=times[0])


def profile_steps(engine, steps: int = 8) -> dict:
    """torch.profiler over ``steps`` warm streaming steps at B = 1: prints
    key_averages(); returns kernels per step and the device busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sess = StreamingSession.start(engine, ["Hello world!"],
                                  params=api.Params(seed=5, num_frames=steps + 4,
                                                    eos_enabled=False))
    for _ in range(4):
        sess.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sess.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -float("inf")
    for a, b in spans:  # union of device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    check(len(kernels) > 0, "the profiler saw no device kernel")
    return dict(steps=steps, kernels_per_step=len(kernels) / steps,
                device_us_per_step=busy / steps, profiled_wall_us_per_step=wall_us / steps,
                busy_share=busy / wall_us)


def phase_stream(gpu_ctx, cpu_ctx) -> dict:
    engine = gpu_ctx.engine
    text = "Hello world!"
    p = api.Params(seed=1)
    reset_launches()
    t0 = time.perf_counter()
    gen = gpu_ctx.stream(text, params=p)
    first = next(gen)
    ttfc_first = 1e3 * (time.perf_counter() - t0)
    chunks = [first] + list(gen)
    launches = read_launches()
    used = engine.generate_full(text, params=p, decode_audio=False).frames_used
    for i, c in enumerate(chunks):
        check(c.pcm_i16.shape == (FRAME_SAMPLES,) and c.pcm_i16.dtype == np.int16,
              f"stream chunk {i}: {c.pcm_i16.shape} {c.pcm_i16.dtype}")
    check(len(chunks) == used, f"stream: {len(chunks)} chunks, offline frames_used {used}")
    check(launches["causal_attention_qkv"] > 0, "B1 was not launched by the stream")
    print(f"stream: {len(chunks)} chunks of {FRAME_SAMPLES} int16 (offline frames_used {used}); "
          f"launches {launches}")

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
    gpu = session_pcm(engine, [text8], p8)
    cpu = session_pcm(cpu_ctx.engine, [text8], p8)
    _, rel = rel_err(torch.from_numpy(gpu), torch.from_numpy(cpu))
    print(f"stream: 8-frame session, card vs CPU f32 view rel {rel:.3e} (gate 1e-3)")
    check(gpu.shape == cpu.shape == (1, 8 * FRAME_SAMPLES), f"session shapes {gpu.shape} {cpu.shape}")
    check(rel <= 1e-3, f"stream card vs CPU: {rel:.3e} > 1e-3")

    streamed = np.concatenate([c.pcm_i16 for c in gpu_ctx.stream(text8, params=p8)])
    offline = engine.generate(text8, params=p8).samples
    lsb = int(np.abs(streamed.astype(np.int32) - quantize_i16(offline).astype(np.int32)).max())
    clipped = float(np.mean(np.abs(offline) > 1.0))
    print(f"stream: int16 vs quantized offline PCM, max {lsb} LSB (gate 8); offline |pcm| max "
          f"{np.abs(offline).max():.4f}, share clipped {clipped:.4f}")
    if lsb > 8:
        # only a clipping waveform may fall back to the f32 views at 1e-3 of max
        check(clipped > 0, f"stream vs offline: {lsb} LSB > 8 with no clipping")
        _, rel = rel_err(torch.from_numpy(streamed / np.float32(32767.0)),
                         torch.from_numpy(np.clip(offline, -1.0, 1.0)))
        print(f"stream: PCM clips; f32 views rel {rel:.3e} (gate 1e-3)")
        check(rel <= 1e-3, f"stream vs offline f32 views: {rel:.3e} > 1e-3")

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
                lsb=lsb, rates=rates, profile=prof)


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
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched by the CLI modes")
    print(f"cli: --flow-test dumps {sizes} bytes, latents vs generate_full rel {rel:.3e}; "
          f"--mimi-wave {n} samples; --tokens --verify ok; launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    results = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="ptts_synth_") as tmp:
        t0 = time.perf_counter()
        model_dir = synth.write_model_dir(tmp, seed=0)
        print(f"synthetic full-size checkpoint: {time.perf_counter() - t0:.2f} s")
        ctx, launches = phase_slice(model_dir)
        cpu_ctx = api.load_dir(model_dir, device="cpu")
        phase_parity(cpu_ctx, ctx)
        stream = phase_stream(ctx, cpu_ctx)
        cli_launches = phase_cli(model_dir, ctx)
        ctx.close()
        cpu_ctx.close()
    by_path = {name: {"slice": launches[name], "stream": stream["launches"][name],
                      "cli": cli_launches[name]} for name in KERNELS}
    print(json.dumps({"stream": {k: stream[k] for k in ("ttfc_first_ms", "ttfc_warm_ms", "lsb",
                                                        "rates", "profile")}}))

    kernels = []
    for name, replaces in (("causal_attention_qkv", f"{PALLAS}:361"),
                           ("window_attention_qkv", f"{PALLAS}:186")):
        cases = results[name]
        f32 = [c for c in cases if c["dtype"] == "f32"]
        bf16 = [c for c in cases if c["dtype"] == "bf16"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "launches_by_path": by_path[name],
            "max_abs_err": max(c["max_abs_err"] for c in f32),
            "ms": f32[0]["ms"], "plain_ms": f32[0]["plain_ms"],
            "timed_shape": f32[0]["shape"] + " f32",
            "max_rel_err_f32": max(c["max_rel_err"] for c in f32),
            "max_rel_err_bf16": max(c["max_rel_err"] for c in bf16),
            "cases": cases,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
