"""Golden end-to-end regression of the port: "Hello world!" against the
reference WAV (port of tools/hello_world_test.py; the same metrics and
gates):

  * lag-aligned cross-correlation (search +-2000 samples), corr >= 0
  * log-magnitude STFT MSE (1024 FFT / 256 hop) <= 1.0
  * duration difference <= 0.5 s
  * RMS ratio and peak ratio in [0.3, 3.0]

    python -m ptts_torch.tools.hello_world_test --model-dir MODELDIR \\
        --ref pocket-tts-hello-world.wav [--gen WAV] [--device cuda]

Generates through ptts_torch.api.load_dir(MODELDIR, device=...) with voice
alba, 17 frames and seed 123. Needs the real model assets (weights,
tokenizer, the alba voice) and the golden WAV (``--ref``, default
$PTTS_HELLO_REF); exits 77 (skip) when either is missing.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

GOLDEN_PROMPT = "Hello world!"
GOLDEN_FRAMES = 17
GOLDEN_SEED = 123


def stft_logmag(x: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    window = np.hanning(n_fft)
    frames = 1 + (len(x) - n_fft) // hop
    out = np.empty((frames, n_fft // 2 + 1), np.float32)
    for i in range(frames):
        seg = x[i * hop : i * hop + n_fft] * window
        out[i] = np.log(np.abs(np.fft.rfft(seg)) + 1e-6)
    return out


def align_by_xcorr(a: np.ndarray, b: np.ndarray, max_lag: int = 2000):
    """Find the lag of b relative to a maximizing correlation; returns
    (a_aligned, b_aligned, lag, corr)."""
    n = min(len(a), len(b))
    a = a[:n].astype(np.float64)
    b = b[:n].astype(np.float64)
    best = (-np.inf, 0)
    for lag in range(-max_lag, max_lag + 1, 25):
        if lag >= 0:
            x, y = a[lag:], b[: n - lag]
        else:
            x, y = a[: n + lag], b[-lag:]
        if len(x) < 1000:
            continue
        denom = np.linalg.norm(x) * np.linalg.norm(y)
        c = float(np.dot(x, y) / denom) if denom > 0 else 0.0
        if c > best[0]:
            best = (c, lag)
    corr, lag = best
    if lag >= 0:
        return a[lag:], b[: n - lag], lag, corr
    return a[: n + lag], b[-lag:], lag, corr


def compare(gen: np.ndarray, ref: np.ndarray, sample_rate: int = 24000) -> dict:
    dur_diff = abs(len(gen) - len(ref)) / sample_rate
    rms_gen = float(np.sqrt(np.mean(gen**2)) + 1e-9)
    rms_ref = float(np.sqrt(np.mean(ref**2)) + 1e-9)
    peak_gen = float(np.abs(gen).max() + 1e-9)
    peak_ref = float(np.abs(ref).max() + 1e-9)
    ga, ra, lag, corr = align_by_xcorr(gen, ref)
    n = min(len(ga), len(ra))
    mse = float(np.mean((stft_logmag(ga[:n]) - stft_logmag(ra[:n])) ** 2))
    return {
        "duration_diff_s": dur_diff,
        "rms_ratio": rms_gen / rms_ref,
        "peak_ratio": peak_gen / peak_ref,
        "lag": lag,
        "corr": corr,
        "stft_logmag_mse": mse,
    }


def gates_pass(m: dict) -> bool:
    return (
        m["stft_logmag_mse"] <= 1.0
        and m["duration_diff_s"] <= 0.5
        and 0.3 <= m["rms_ratio"] <= 3.0
        and 0.3 <= m["peak_ratio"] <= 3.0
        and m["corr"] >= 0.0
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", default=os.environ.get("PTTS_MODEL_DIR", ""))
    ap.add_argument("--ref", default=os.environ.get("PTTS_HELLO_REF", ""),
                    help="the golden pocket-tts-hello-world.wav")
    ap.add_argument("--gen", default="", help="pre-generated WAV (skip synth)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..io.wav import load_wav

    if not args.ref or not os.path.isfile(args.ref):
        print(f"SKIP: golden reference {args.ref or '(none; set --ref or PTTS_HELLO_REF)'} "
              f"not found", file=sys.stderr)
        return 77
    ref = load_wav(args.ref)

    if args.gen:
        gen = load_wav(args.gen)
    else:
        if not args.model_dir or not os.path.isdir(args.model_dir):
            print("SKIP: model dir not found (set --model-dir or PTTS_MODEL_DIR)",
                  file=sys.stderr)
            return 77
        from .. import api

        ctx = api.load_dir(args.model_dir, device=args.device)
        params = api.Params(num_frames=GOLDEN_FRAMES, seed=GOLDEN_SEED)
        gen = ctx.generate(GOLDEN_PROMPT, voice="alba", params=params)

    m = compare(np.asarray(gen.samples), np.asarray(ref.samples))
    for k, v in m.items():
        print(f"{k}: {v:.4f}")
    if gates_pass(m):
        print("GOLDEN TEST PASSED")
        return 0
    print("GOLDEN TEST FAILED", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
