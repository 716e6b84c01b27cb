#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ptts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, in order; any failure raises, exits non-zero and prints no result:
  1. device  -- CUDA must be available; prints nvidia-smi's name and power limit
  2. build   -- nvcc builds the hand-written kernels from ptts_torch/csrc
  3. kernels -- each CUDA kernel against its plain PyTorch version on the same
                inputs at main-path shapes, f32 (gate 1e-4) and bf16 (5e-2),
                max error relative to the largest reference value; CUDA-event
                times of both
  4. slice   -- a full-size synthetic checkpoint through ptts_torch.api:
                generate("Hello world!") and a 4-prompt batch_generate; PCM
                finite, frames_used * 1920 samples; both kernels launched
  5. parity  -- the same 8-frame f32 generate (EOS off) on the CPU (plain
                versions) and on the card (kernels): latents and PCM within
                1e-3, frames_used equal, first_cond/first_flow taps within 1e-4
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ptts_torch import api, synth  # noqa: E402
from ptts_torch.ops.cuda import build  # noqa: E402
from ptts_torch.ops.cuda import fused_attention as fa  # noqa: E402
from ptts_tpu.utils.timing import GLOBAL_STATS  # noqa: E402

SOURCE = "ptts_torch/csrc/fused_attention.cu"
PALLAS = "ptts_tpu/ops/pallas/fused_attention.py"
GATES = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
FRAME_SAMPLES = 1920


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke FAILED: {msg}")


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, max abs error / max |want|), in f32."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


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
        for T in (64, 128):
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
        for T in (1024, 800):
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

    fa.causal_attention_qkv.launches = 0
    fa.window_attention_qkv.launches = 0
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
    launches = {"causal_attention_qkv": fa.causal_attention_qkv.launches,
                "window_attention_qkv": fa.window_attention_qkv.launches}

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


def phase_parity(model_dir: str, gpu_ctx) -> None:
    p = api.Params(seed=3, num_frames=8, eos_enabled=False)
    text = "Hello world, this is the card against the CPU."
    cpu = api.load_dir(model_dir, device="cpu").engine.generate_full(text, params=p)
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
        phase_parity(model_dir, ctx)
        ctx.close()

    kernels = []
    for name, replaces in (("causal_attention_qkv", f"{PALLAS}:361"),
                           ("window_attention_qkv", f"{PALLAS}:186")):
        cases = results[name]
        f32 = [c for c in cases if c["dtype"] == "f32"]
        bf16 = [c for c in cases if c["dtype"] == "bf16"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name],
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
