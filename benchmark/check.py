"""How ``correct`` is decided: the timed path's own outputs against the plain
reference (reference/model.py), computed once the window has closed. Each
traffic kind gathers its outputs and hands them to ``judge`` here
(serving.readings, traffic/offline_batch.readings).

For a sample of the requests (serving) or utterances (offline) that the
window finished, drawn from the seed with the longest among them:

  * ``lat_gap``: FlowLM teacher-forced. At every frame the reference
    computes the latent from the prompt, the frame's noise and the
    program's own earlier latents; the gap is the frame's error in the
    flow velocity (latent minus noise), as a share of the request's RMS
    velocity times sqrt(latent); the widest frame of the sample. It covers
    the prefill, the frame step with the decode attention over the cache,
    the flow sampler and the latent scaling.
  * ``eos_gap``: the EOS head's logit at every frame, the widest error as
    a share of the request's RMS logit.
  * ``pcm_gap``: the Mimi decoder. The reference decodes the program's
    latents over the whole utterance; the gap is a chunk's (80 ms) error
    as a share of the utterance's RMS, the widest chunk of the sample. The
    serving cells compare the int16 chunks the host received with the
    reference quantized the same way; the offline cell the float PCM.
  * ``pcm_gap_bf16``: a request's pcm_gap over the pcm_gap of the
    reference itself with its operands rounded to bfloat16, on the same
    latents; the widest of the sample. How far a rounding carries through
    the decoder changes with each seed's random weights (the bf16 cells'
    pcm_gap swings about 5x from seed to seed, the fp8 control's with it,
    at about 3x the program's); in units of the seed's own bf16 yardstick
    the program and the control part.
  * ``missing``, ``frames_bad``, ``noise_bad``: exact counts (limit 0): a
    sampled request whose frames the tap did not record whole or whose PCM
    did not come back; a request or utterance of the window whose frame
    count or PCM length is not its budget, or that never finished; a
    sampled frame whose noise is not the noise the benchmark gave.

The reference follows the program frame by frame from the program's own
latents (random weights amplify rounding about 2x per frame, so two free
runs part after a few frames); frame 0, computed from the prompt and noise
alone, is the start checked by itself.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np
import torch

from .reference.model import Reference, quantize_i16

HERE = os.path.dirname(os.path.abspath(__file__))


def frame_gap(prog: torch.Tensor, ref: torch.Tensor, width: int) -> float:
    """Widest row error of prog vs ref [frames, width] as a share of
    sqrt(width) times the RMS of ref over all rows."""
    prog, ref = prog.double().reshape(-1, width), ref.double().reshape(-1, width)
    rms = float(ref.pow(2).mean().sqrt()) or 1.0
    return float((prog - ref).norm(dim=1).max()) / (math.sqrt(width) * rms)


def value_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    prog, ref = prog.double().flatten(), ref.double().flatten()
    rms = float(ref.pow(2).mean().sqrt()) or 1.0
    return float((prog - ref).abs().max()) / rms


class Readings:
    """The compared numbers of one candidate (the program or a control)."""

    def __init__(self):
        self.v = {"lat_gap": 0.0, "eos_gap": 0.0, "pcm_gap": 0.0, "pcm_gap_bf16": 0.0}

    def add(self, name: str, value: float) -> None:
        self.v[name] = max(self.v[name], value)


def judge(refs: Dict[str, Reference], prompt, noise, scaled_p, eos_p, pcm_p, frame_samples,
           quantized: bool, out: Dict[str, Readings]) -> None:
    base = refs["f32"]
    raw_p = base.unscale(scaled_p.to(base.device))
    noise = noise.to(base.device)
    L = noise.shape[1]
    lat_r, eos_r = base.teacher_forced(prompt, noise, raw_p)
    pcm_r = base.decode(scaled_p)
    if quantized:
        pcm_r = quantize_i16(pcm_r).float()
    pcm_p = torch.as_tensor(np.asarray(pcm_p, np.float32), device=base.device)
    if pcm_p.numel() != pcm_r.numel():
        raise ValueError(f"PCM of {pcm_p.numel()} samples, expected {pcm_r.numel()}")
    vr = lat_r - noise
    pcm_y = refs["bf16"].decode(scaled_p)
    if quantized:
        pcm_y = quantize_i16(pcm_y).float()
    yard = max(frame_gap(pcm_y, pcm_r, frame_samples), 1e-30)
    out["program"].add("lat_gap", frame_gap(raw_p - noise, vr, L))
    out["program"].add("eos_gap", value_gap(eos_p.to(base.device), eos_r))
    gap = frame_gap(pcm_p, pcm_r, frame_samples)
    out["program"].add("pcm_gap", gap)
    out["program"].add("pcm_gap_bf16", gap / yard)
    for name, ref in refs.items():
        if name in ("f32", "bf16"):
            continue
        lat_c, eos_c = ref.teacher_forced(prompt, noise, raw_p)
        pcm_c = ref.decode(scaled_p)
        if quantized:
            pcm_c = quantize_i16(pcm_c).float()
        out[name].add("lat_gap", frame_gap(lat_c - noise, vr, L))
        out[name].add("eos_gap", value_gap(eos_c, eos_r))
        gap = frame_gap(pcm_c, pcm_r, frame_samples)
        out[name].add("pcm_gap", gap)
        out[name].add("pcm_gap_bf16", gap / yard)


def references(system, cfg: dict, controls):
    """The reference, its bf16 yardstick and the controls, over the
    benchmark's weights; one Readings per candidate."""
    refs = {p: Reference(system.weights, cfg, p)
            for p in dict.fromkeys(("f32", "bf16") + tuple(controls))}
    out = {"program": Readings()}
    out.update({p: Readings() for p in controls})
    return refs, out


def frame_samples(cfg: dict) -> int:
    n = cfg["mimi"]["upsample_stride"]
    for r in cfg["mimi"]["ratios"]:
        n *= r
    return n


def numbers(out: Dict[str, Readings], counts: dict) -> dict:
    """Each candidate's numbers; the program's with the exact counts."""
    return {name: dict(r.v, **counts) if name == "program" else dict(r.v)
            for name, r in out.items()}


def limits(workload: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def decide(numbers: dict, lim: dict) -> tuple:
    """(correct, [[name, value, limit]]): every compared number at or under
    its limit; a number that could not be read fails."""
    rows, ok = [], True
    for name, limit in lim.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        rows.append([name, v, limit])
    return ok, rows
