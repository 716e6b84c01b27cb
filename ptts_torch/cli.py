"""Command line for the PyTorch port, with the flags, modes, messages and
exit codes of ptts_tpu.cli, plus ``--device`` (default cuda).

    python -m ptts_torch.cli -d MODEL_DIR -p "Hello world!" -o out.wav [options]
    python -m ptts_torch.cli -d MODEL_DIR --info --list --find TEXT --verify
    python -m ptts_torch.cli -d MODEL_DIR -p "Hi" --tokens
    python -m ptts_torch.cli -d MODEL_DIR -p "Hi" --flow-test --latent-out lat.f32 \\
        --cond-out cond.f32 --flow-out flow.f32
    python -m ptts_torch.cli -d MODEL_DIR -p "Hi" --mimi-test --mimi-wave mimi.wav
    python -m ptts_torch.cli --dummy -p "Hi" -o out.wav
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys
from typing import Optional

import numpy as np
import torch

from . import api
from .io.wav import Audio, save_wav
from .text import estimate_frames, prepare_text

QUIET, NORMAL, VERBOSE = 0, 1, 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ptts-torch",
                                description="Pocket-TTS on PyTorch/CUDA")
    # accept scientific-notation negatives ("--eos-threshold -1e9")
    p._negative_number_matcher = re.compile(r"^-\d+$|^-\d*\.\d+$|^-\d+\.?\d*[eE][-+]?\d+$")
    p.add_argument("-d", "--dir", help="Model directory or .safetensors file")
    p.add_argument("-p", "--prompt", help="Text to synthesize")
    p.add_argument("-o", "--output", help="Output WAV path")
    p.add_argument("--voice", default=None,
                   help="Voice embedding name or .safetensors path (default: alba)")
    # introspection
    p.add_argument("--info", action="store_true", help="Print model info")
    p.add_argument("--list", action="store_true", help="List tensors in weights file")
    p.add_argument("--find", metavar="TEXT", help="List tensors whose names contain TEXT")
    p.add_argument("--verify", action="store_true",
                   help="Verify weights against expected shapes")
    p.add_argument("--tokens", action="store_true", help="Print token IDs for the prompt")
    # debug/analysis
    p.add_argument("--flow-test", action="store_true",
                   help="Run a single FlowLM step and print latent stats")
    p.add_argument("--mimi-test", action="store_true",
                   help="Run FlowLM + Mimi decoder transformer stats")
    p.add_argument("--mimi-wave", metavar="PATH",
                   help="Write Mimi decode WAV to PATH (frames * 80ms)")
    p.add_argument("--frames", type=int, default=0,
                   help="Number of FlowLM/Mimi frames (default: auto)")
    p.add_argument("--latent-out", metavar="PATH",
                   help="Write raw FlowLM latents (32 floats per frame)")
    p.add_argument("--cond-out", metavar="PATH",
                   help="Write first FlowLM condition vector (1024 floats)")
    p.add_argument("--flow-out", metavar="PATH",
                   help="Write first FlowLM flow vector (32 floats)")
    p.add_argument("--dummy", action="store_true",
                   help="Generate placeholder audio (no model)")
    # generation
    p.add_argument("-S", "--seed", type=int, default=-1, help="Random seed (-1 for random)")
    p.add_argument("-t", "--temp", type=float, default=0.7,
                   help="Noise temperature for FlowLM")
    p.add_argument("--noise-clamp", type=float, default=0.0,
                   help="Clamp noise to [-F, F] (default: 0, off)")
    p.add_argument("--eos-threshold", type=float, default=-4.0,
                   help="Stop early if eos_logit >= F (default: -4.0)")
    p.add_argument("--eos-min-frames", type=int, default=1,
                   help="Minimum frames before EOS stop")
    p.add_argument("--eos-after", type=int, default=0,
                   help="Frames to keep after EOS (default: auto)")
    p.add_argument("-r", "--rate", type=int, default=24000,
                   help="Sample rate for dummy generator")
    p.add_argument("-s", "--steps", type=int, default=1, help="Flow matching steps")
    p.add_argument("-q", "--quiet", action="store_true", help="Less output")
    p.add_argument("-v", "--verbose", action="store_true", help="More output")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def _params_from_args(args) -> api.Params:
    return api.Params(
        sample_rate=args.rate,
        num_steps=args.steps,
        num_frames=max(args.frames, 0),
        seed=args.seed,
        temp=args.temp,
        noise_clamp=args.noise_clamp,
        eos_enabled=True,
        eos_threshold=args.eos_threshold,
        eos_min_frames=max(args.eos_min_frames, 1),
        eos_after=max(args.eos_after, 0),
    )


def _print_tokens(ctx: api.Context, prompt: str, level: int) -> int:
    prepared, _, _ = prepare_text(prompt)
    ids = ctx.tokenize(prepared)
    if level >= VERBOSE:
        print(f"Prepared text: {prepared}", file=sys.stderr)
    print(f"Tokens ({len(ids)}):" + "".join(f" {i}" for i in ids))
    if level >= VERBOSE:
        for i in ids:
            piece = ctx.token_piece(i) or b""
            shown = "".join(
                chr(c) if 32 <= c <= 126 and c != 0x5C else f"\\\\x{c:02X}" for c in piece
            )
            print(f"{i}: {shown}")
    return 0


@torch.inference_mode()
def _mimi_debug(ctx: api.Context, args, out, level: int) -> None:
    """--mimi-test (one frame through the Mimi transformer) and --mimi-wave
    (the offline Mimi decode of exactly the generated frames)."""
    from .models import flowlm, mimi

    engine = ctx.engine
    latents = torch.from_numpy(out.latents).to(engine.device, engine.dtype)
    scaled = flowlm.scale_latents(engine.fw, latents)                  # [F, latent]
    if args.mimi_test:
        x = flowlm._linear(engine.mw.quant_w, None, scaled[:1])         # [1, d]
        emb = mimi.transformer(engine.mw.transformer, x[None], engine.mimi_cfg,
                               engine.window_impl)[0, 0]
        emb = emb.float().cpu().numpy()
        print("Mimi decode (transformer) stats: mean=%.6f min=%.6f max=%.6f"
              % (emb.mean(), emb.min(), emb.max()))
    if args.mimi_wave:
        pcm = engine.decode_audio_batch(scaled[None])[0]
        n = out.frames_used * engine.mimi_cfg.frame_samples
        audio = Audio(sample_rate=api.DEFAULT_SAMPLE_RATE, channels=1,
                      samples=pcm[:n].astype(np.float32))
        save_wav(audio, args.mimi_wave)
        if level >= VERBOSE:
            print(f"Wrote Mimi WAV to {args.mimi_wave} ({out.frames_used} frames, "
                  f"{n} samples)", file=sys.stderr)


def _flow_test(ctx: api.Context, args, params: api.Params, level: int) -> int:
    """--flow-test / --mimi-test / --mimi-wave with the raw-f32 dump taps."""
    _, word_count, _ = prepare_text(args.prompt)
    gen_frames = params.num_frames
    if gen_frames <= 0:
        gen_frames = estimate_frames(word_count) if (args.mimi_wave or args.mimi_test) else 1
    p = dataclasses.replace(params, num_frames=gen_frames)
    out = ctx.engine.generate_full(args.prompt, voice=args.voice, params=p,
                                   decode_audio=False)

    lat0 = out.latents[0]
    print("FlowLM step: eos_logit=%.4f, latent mean=%.6f min=%.6f max=%.6f"
          % (out.first_eos_logit, lat0.mean(), lat0.min(), lat0.max()))
    if args.cond_out:
        out.first_cond.astype("<f4").tofile(args.cond_out)
        if level >= VERBOSE:
            print(f"Wrote FlowLM cond to {args.cond_out}", file=sys.stderr)
    if args.flow_out:
        out.first_flow.astype("<f4").tofile(args.flow_out)
        if level >= VERBOSE:
            print(f"Wrote FlowLM flow to {args.flow_out}", file=sys.stderr)
    if args.latent_out:
        out.latents.astype("<f4").tofile(args.latent_out)
        if level >= VERBOSE:
            print(f"Wrote {out.frames_used} latent frame(s) to {args.latent_out}",
                  file=sys.stderr)
    if args.mimi_test or args.mimi_wave:
        _mimi_debug(ctx, args, out, level)
    return 0


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    level = QUIET if args.quiet else (VERBOSE if args.verbose else NORMAL)
    params = _params_from_args(args)

    introspect = (args.info or args.list or args.tokens or args.find
                  or args.verify or args.flow_test or args.mimi_test or args.mimi_wave)

    if introspect:
        if not args.dir:
            print("Error: --dir is required for introspection/debug modes", file=sys.stderr)
            return 1
        try:
            ctx = api.load_dir(args.dir, device=args.device)
        except api.PttsError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if args.info:
            print(ctx.info())
        if args.list:
            print(ctx.list_tensors())
        if args.find:
            for line in ctx.find_tensors(args.find):
                print(line)
        if args.verify:
            report = ctx.verify_weights()
            if report.errors:
                if level >= VERBOSE:
                    print(report.format(), file=sys.stderr)
                print("Error: weight verification failed", file=sys.stderr)
                return 1
        if args.tokens:
            if not args.prompt:
                print("Error: --prompt is required for --tokens", file=sys.stderr)
                return 1
            try:
                _print_tokens(ctx, args.prompt, level)
            except api.PttsError as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
        if args.flow_test or args.mimi_test or args.mimi_wave:
            if not args.prompt:
                print("Error: --prompt is required for --flow-test/--mimi-test/"
                      "--mimi-wave", file=sys.stderr)
                return 1
            try:
                return _flow_test(ctx, args, params, level)
            except api.PttsError as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
        return 0

    if not args.prompt:
        print("Error: --prompt is required", file=sys.stderr)
        return 1
    if not args.output:
        print("Error: --output is required", file=sys.stderr)
        return 1

    if args.dummy:
        if level >= NORMAL:
            print("Generating dummy audio...", file=sys.stderr)
        audio = api.generate_dummy(args.prompt, params)
    else:
        if not args.dir:
            print("Error: --dir is required unless --dummy is used", file=sys.stderr)
            return 1
        try:
            ctx = api.load_dir(args.dir, device=args.device)
            audio = ctx.generate(args.prompt, voice=args.voice, params=params)
        except api.PttsError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    save_wav(audio, args.output)
    if level >= NORMAL:
        print(f"Saved {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
