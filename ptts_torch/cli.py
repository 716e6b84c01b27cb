"""Command line for the PyTorch port: text -> WAV.

    python -m ptts_torch.cli -d MODEL_DIR -p "Hello world!" -o out.wav \
        [--voice NAME] [--seed N] [--frames N] [--steps N] [--device cuda]

The generate mode of ptts_tpu.cli with the same flag names; its
introspection and debug modes are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from ptts_tpu.io.wav import save_wav

from . import api


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ptts-torch",
                                description="Pocket-TTS on PyTorch/CUDA")
    p.add_argument("-d", "--dir", required=True, help="Model directory or .safetensors file")
    p.add_argument("-p", "--prompt", required=True, help="Text to synthesize")
    p.add_argument("-o", "--output", required=True, help="Output WAV path")
    p.add_argument("--voice", default=None,
                   help="Voice embedding name or .safetensors path (default: alba)")
    p.add_argument("-S", "--seed", type=int, default=-1, help="Random seed (-1 for random)")
    p.add_argument("--frames", type=int, default=0,
                   help="Number of FlowLM frames (default: auto)")
    p.add_argument("-s", "--steps", type=int, default=1, help="Flow matching steps")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("-q", "--quiet", action="store_true", help="Less output")
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    params = api.Params(num_steps=args.steps, num_frames=max(args.frames, 0), seed=args.seed)
    try:
        ctx = api.load_dir(args.dir, device=args.device)
        audio = ctx.generate(args.prompt, voice=args.voice, params=params)
    except api.PttsError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    save_wav(audio, args.output)
    if not args.quiet:
        print(f"Saved {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
