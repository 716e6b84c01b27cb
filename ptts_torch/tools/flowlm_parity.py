"""Cross-implementation parity harness of the port (port of
tools/flowlm_parity.py, same report format and exit codes).

Runs ``ptts_torch.cli --flow-test`` at temp 0 on ``--device`` and reports
the max/mean/RMS abs diff of its three dump taps -- N latent frames, the
first 1024-d condition vector and the first 32-d flow vector -- against one
comparison source:

  1. --c-binary PATH:   the reference C binary's --flow-test dumps.
  2. --torch:           the upstream PyTorch pocket_tts package, stepped
                        frame by frame (77 when it cannot be imported).
  3. --other-dumps DIR: pre-generated raw-f32 dumps (latents.f32, cond.f32,
                        flow.f32) from any source, e.g. the JAX package's
                        full-width dumps in tests/data/jax_golden/. When DIR
                        also holds mimi.wav, the port writes --mimi-wave in
                        the same run and the WAVs are compared in int16
                        (largest LSB difference, the reference's clipped
                        share) within WAVE_LSB; when DIR holds a meta.json,
                        the model dir's .safetensors must hash to it first.

    python -m ptts_torch.tools.flowlm_parity --model-dir DIR \\
        --other-dumps tests/data/jax_golden --tolerance-rel latents=1e-3,cond=1e-4,flow=1e-4

Gates: ``--tolerance`` (default 1e-3) on the largest abs diff of any tap,
or ``--tolerance-rel``, which gates each tap against its largest reference
value (one number for every tap, or ``tap=value`` pairs; CARD_GATES are
the card-against-CPU gates). Exit 0 within the gates, 1 beyond them (or on
a checkpoint that does not match meta.json), 77 with no model dir or no
comparison source.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np

PROMPT_DEFAULT = "Hello world!"
TAPS = ("latents", "cond", "flow")
CARD_GATES = {"latents": 1e-3, "cond": 1e-4, "flow": 1e-4}
WAVE_LSB = 33   # 1e-3 of int16 full scale: the reference's CUDA-against-CPU gate
I16_FULL = 32767


def report(name: str, a: np.ndarray, b: np.ndarray) -> float:
    n = min(a.size, b.size)
    d = np.abs(a.flat[:n] - b.flat[:n])
    print(f"{name}: max={d.max():.6e} mean={d.mean():.6e} "
          f"rms={np.sqrt((d**2).mean()):.6e} (n={n})")
    return float(d.max())


def checkpoint_sha256(model_dir: str) -> dict:
    """{file name: SHA-256 hex} of every .safetensors file in ``model_dir``
    and its embeddings/ directory (names relative to ``model_dir``)."""
    out = {}
    for sub in ("", "embeddings"):
        d = os.path.join(model_dir, sub)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith(".safetensors"):
                h = hashlib.sha256()
                with open(os.path.join(d, name), "rb") as f:
                    for block in iter(lambda: f.read(1 << 20), b""):
                        h.update(block)
                out[os.path.join(sub, name) if sub else name] = h.hexdigest()
    return out


def meta_mismatch(dumps_dir: str, model_dir: str) -> Optional[str]:
    """None when ``dumps_dir`` has no meta.json or the model dir's
    checkpoint hashes to it; else what differs."""
    path = os.path.join(dumps_dir, "meta.json")
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        want = json.load(f)["sha256"]
    got = checkpoint_sha256(model_dir)
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if not bad:
        return None
    return (f"the checkpoint in {model_dir} does not match {path}: "
            + "; ".join(f"{k}: {g} != {w}" for k, (g, w) in sorted(bad.items())))


def run_ours(model_dir: str, prompt: str, frames: int, seed: int, outdir: str,
             device: str = "cuda", wave: bool = False) -> dict:
    """The port's --flow-test dumps on ``device`` ({tap: f32 array}; with
    ``wave`` also "wave", the --mimi-wave int16 samples of the same run)."""
    from .. import cli

    paths = {k: os.path.join(outdir, f"ours_{k}.f32") for k in TAPS}
    argv = ["-d", model_dir, "-p", prompt, "--flow-test",
            "--frames", str(frames), "-S", str(seed), "-t", "0",
            "--latent-out", paths["latents"], "--cond-out", paths["cond"],
            "--flow-out", paths["flow"], "-q", "--device", device]
    if wave:
        argv += ["--mimi-wave", os.path.join(outdir, "ours_mimi.wav")]
    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError("engine --flow-test failed")
    out = {k: np.fromfile(v, dtype="<f4") for k, v in paths.items()}
    if wave:
        out["wave"] = wav_i16(os.path.join(outdir, "ours_mimi.wav"))
    return out


def wav_i16(path: str) -> np.ndarray:
    """A 16-bit WAV's samples as int32 counts of one LSB."""
    from ..io.wav import load_wav

    return np.rint(load_wav(path).samples * I16_FULL).astype(np.int32)


def run_c_binary(binary: str, model_dir: str, prompt: str, frames: int,
                 seed: int, outdir: str) -> dict:
    paths = {k: os.path.join(outdir, f"c_{k}.f32") for k in TAPS}
    subprocess.run(
        [binary, "-d", model_dir, "-p", prompt, "--flow-test",
         "--frames", str(frames), "-S", str(seed), "-t", "0",
         "--latent-out", paths["latents"],
         "--cond-out", paths["cond"],
         "--flow-out", paths["flow"], "-q"],
        check=True,
    )
    return {k: np.fromfile(v, dtype="<f4") for k, v in paths.items()}


def run_torch(model_dir: str, prompt: str, frames: int, steps: int = 4,
              seed: int = 123) -> Optional[dict]:
    """The upstream PyTorch pocket-tts (the reference's parity oracle),
    stepped through: the upstream ``TTSModel`` flow-LM one frame at a time
    at temp=0 (each Euler solve starts from x0=0, so no RNG enters the
    latent path) and collects the taps the port's --flow-test dumps: N
    latent frames, the BOS-position backbone output (``cond``) and one
    flow_net evaluation at (s=0, t=1/steps, x0=0) (``flow``).

    Returns None when pocket_tts is not importable or the model dir lacks
    its files, so the caller reports no comparison source."""
    try:
        import torch
        from pocket_tts.models.tts_model import (  # type: ignore
            TTSModel, prepare_text_prompt)
        from pocket_tts.modules.stateful_module import init_states  # type: ignore
        from pocket_tts.utils.config import load_config  # type: ignore
    except ImportError:
        return None

    cfg_path = os.path.join(model_dir, "config.yaml")
    weights = None
    for name in sorted(os.listdir(model_dir)):
        if name.startswith("tts_") and name.endswith(".safetensors"):
            weights = os.path.join(model_dir, name)
    if weights is None or not os.path.isfile(cfg_path):
        print("SKIP: --torch needs config.yaml + tts_*.safetensors in model dir",
              file=sys.stderr)
        return None

    cfg = load_config(cfg_path)
    cfg.weights_path = weights
    cfg.weights_path_without_voice_cloning = weights
    # temp=0, no noise clamp: the deterministic regime of --flow-test
    model = TTSModel._from_pydantic_config_with_weights(cfg, 0.0, steps, None, 1e9)
    model.eval()
    torch.manual_seed(seed)

    text, _ = prepare_text_prompt(prompt)
    prepared = model.flow_lm.conditioner.prepare(text)
    state = init_states(model.flow_lm, batch_size=1, sequence_length=1000)
    model._run_flow_lm_and_increment_step(model_state=state,
                                          text_tokens=prepared.tokens)

    # cond/flow taps on a cloned state so the latent walk below is unaffected
    probe = {mk: {sk: sv.clone() for sk, sv in mv.items()}
             for mk, mv in state.items()}
    ldim, dim = model.flow_lm.ldim, model.flow_lm.dim
    bos = model.flow_lm.bos_emb.reshape(1, 1, ldim).to(model.flow_lm.dtype)
    h = model.flow_lm.backbone(
        model.flow_lm.input_linear(bos),
        torch.empty((1, 0, dim), dtype=model.flow_lm.dtype), bos,
        model_state=probe,
    ).to(torch.float32)[:, -1]
    cond = h[0].detach().cpu().numpy().astype(np.float32)
    flow = model.flow_lm.flow_net(
        h, torch.zeros((1, 1), dtype=h.dtype),
        torch.full((1, 1), 1.0 / max(steps, 1), dtype=h.dtype),
        torch.zeros((1, ldim), dtype=h.dtype),
    )[0].detach().cpu().numpy().astype(np.float32)

    nan_in = torch.full((1, 1, ldim), float("nan"), dtype=model.flow_lm.dtype)
    latents, back_in = [], nan_in  # NaN input == BOS frame upstream
    with torch.no_grad():
        for _ in range(frames):
            latent, _eos = model._run_flow_lm_and_increment_step(
                model_state=state, backbone_input_latents=back_in)
            latents.append(latent[0, 0].cpu().numpy().astype(np.float32))
            back_in = latent
    return {"latents": np.concatenate(latents), "cond": cond, "flow": flow}


def load_dumps(dumps_dir: str) -> dict:
    """{tap: f32 array} of ``dumps_dir`` and, when it holds mimi.wav,
    "wave": its int16 samples."""
    out = {k: np.fromfile(os.path.join(dumps_dir, f"{k}.f32"), dtype="<f4") for k in TAPS}
    wave = os.path.join(dumps_dir, "mimi.wav")
    if os.path.isfile(wave):
        out["wave"] = wav_i16(wave)
    return out


def parse_rel_gates(spec: str) -> dict:
    """``--tolerance-rel``: one number for every tap, or ``tap=value``
    pairs separated by commas (taps left out are not gated)."""
    if "=" not in spec:
        return dict.fromkeys(TAPS, float(spec))
    gates = {}
    for item in spec.split(","):
        tap, value = item.split("=")
        if tap.strip() not in TAPS:
            raise ValueError(f"--tolerance-rel: unknown tap {tap!r} (taps: {', '.join(TAPS)})")
        gates[tap.strip()] = float(value)
    return gates


def compare(ours: dict, other: dict, tolerance: float, rel_gates: Optional[dict]) -> dict:
    """Print each tap's report line (and the WAV's when both have one);
    returns {"ok", "worst", "rel": {tap: max diff / max |other|}, "wave_lsb",
    "clipped"}."""
    worst, rel, ok = 0.0, {}, True
    for tap in TAPS:
        d = report(tap, ours[tap], other[tap])
        worst = max(worst, d)
        rel[tap] = d / max(float(np.abs(other[tap]).max()), 1e-30)
        if rel_gates is not None and tap in rel_gates:
            print(f"{tap}: {rel[tap]:.6e} of max (gate {rel_gates[tap]:.0e})")
            ok = ok and rel[tap] <= rel_gates[tap]
    if rel_gates is None:
        ok = worst <= tolerance
    res = {"ok": ok, "worst": worst, "rel": rel, "wave_lsb": None, "clipped": None}
    if "wave" in ours and "wave" in other:
        a, b = ours["wave"], other["wave"]
        if a.shape != b.shape:
            print(f"mimi.wav: {a.size} samples against {b.size}")
            res["ok"] = False
            return res
        lsb = int(np.abs(a - b).max())
        clipped = float(np.mean(np.abs(b) >= I16_FULL))
        print(f"mimi.wav: max_lsb={lsb} clipped={clipped:.4f} (n={b.size}; gate {WAVE_LSB} LSB)")
        res.update(ok=res["ok"] and lsb <= WAVE_LSB, wave_lsb=lsb, clipped=clipped)
    return res


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", default=os.environ.get("PTTS_MODEL_DIR", ""))
    ap.add_argument("--prompt", default=PROMPT_DEFAULT)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--c-binary", default="", help="path to the reference ptts binary")
    ap.add_argument("--other-dumps", default="",
                    help="dir with latents.f32/cond.f32/flow.f32 to compare against")
    ap.add_argument("--torch", action="store_true",
                    help="compare against the upstream pocket_tts package")
    ap.add_argument("--tolerance", type=float, default=1e-3)
    ap.add_argument("--tolerance-rel", default="",
                    help="gate each tap against its largest reference value: one number, "
                    "or tap=value pairs (e.g. latents=1e-3,cond=1e-4,flow=1e-4)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rel_gates = parse_rel_gates(args.tolerance_rel) if args.tolerance_rel else None

    if not args.model_dir or not os.path.isdir(args.model_dir):
        print("SKIP: model dir not available", file=sys.stderr)
        return 77
    if args.other_dumps:
        bad = meta_mismatch(args.other_dumps, args.model_dir)
        if bad:
            print(f"PARITY FAILED: {bad}", file=sys.stderr)
            return 1

    with tempfile.TemporaryDirectory() as tmp:
        other = None
        if args.c_binary:
            other = run_c_binary(args.c_binary, args.model_dir, args.prompt,
                                 args.frames, args.seed, tmp)
        elif args.other_dumps:
            other = load_dumps(args.other_dumps)
        elif args.torch:
            other = run_torch(args.model_dir, args.prompt, args.frames, seed=args.seed)
        if other is None:
            print("SKIP: no comparison source (use --c-binary / --other-dumps / --torch)",
                  file=sys.stderr)
            return 77
        ours = run_ours(args.model_dir, args.prompt, args.frames, args.seed, tmp,
                        device=args.device, wave="wave" in other)
        res = compare(ours, other, args.tolerance, rel_gates)

    gate = (f"<= {args.tolerance:.0e}" if rel_gates is None
            else "each tap within its gate of max")
    if res["ok"]:
        print(f"PARITY OK (max abs diff {res['worst']:.2e} {gate})")
        return 0
    print(f"PARITY FAILED (max abs diff {res['worst']:.2e})", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
