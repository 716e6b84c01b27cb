"""Closed-loop serving of the hybrid configuration (benchmark/hybrid.py):
traffic/closed_loop_serve.py's traffic and feeder over a system with
Granite 4.0-H's Mamba-2/GQA stack as FlowLM's backbone.

The run is serving.drive's: the port's ContinuousBatcher under
serving.ServeRun, the queue topped up to the mix's backlog before every
step, system.FrameTap on the sampled requests, check.judge on them. What
differs is the model's: the system is built by hybrid.build, the FLOPs of
the audio delivered are counted by hybrid.stream_flops, and the check's
reference is reference/hybrid.HybridReference. Besides, the run reads the
bytes the Mamba mixers move a pool frame (step.ssm_roofline_pct) and the
program's ``ssm.*`` counters for its info line.

On a port without the hybrid backbone the configuration is refused at once
(TypeError from FlowLMConfig), before any weight is made.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from .. import check, hybrid as H, system as S
from ..serving import FRAME_S, ServeRun, p95, quantiles_ms
from .closed_loop_serve import Feeder


def drive(cell) -> dict:
    cfg = H.expand(cell.cfg)
    H.model_configs(cfg)                     # fails fast on a port without the backbone
    mix, dev = cell.mix, cell.device
    on_card = dev.type == "cuda"
    sysm = H.build(cfg, cell.seed, dev, mix["voices"])
    run = ServeRun(sysm, mix, cell.seed, cell.seconds, cell.trace)
    feeder = Feeder(run, mix, cfg, cell.seed, cell.seconds)
    bc = mix["batcher"]
    tap = S.FrameTap(cfg["flowlm"]["latent_dim"], feeder.watch_slots,
                     bc["max_len"] - bc["prefix_budget"])
    tap.bind(run.b.shards)
    run.tap = tap
    tap.install()
    try:
        res = run.run(feeder)
    finally:
        tap.uninstall()
    t_start, t_end = run.t_start, run.t_end
    peaks = [torch.cuda.max_memory_allocated(d) for d in run.devices] if on_card else [0]
    window = [r for r in feeder.window_rids if run.specs[r].due is not None]
    chunks, gaps, _ = run.landed_in(t_start, t_end)
    e2e = {"audio_s_per_s": chunks * FRAME_S / cell.seconds,
           "chunk_gap_p95_ms": (p95(gaps) or float("nan")) * 1e3}
    h_end = res["host_t_end"]
    _, _, deliv = run.landed_in(t_start, h_end)
    f = cfg["flowlm"]
    rows = sum(sh.rows for sh in run.b.shards)
    obs = dict(sub=res["sub"], sub_info=res["sub_info"], host_phase_s=res["host_phase_s"],
               host_steps=res["host_steps"],
               delivered_flops=sum(H.stream_flops(f, cfg["mimi"], p, a, z) for p, a, z in deliv),
               flops_window_s=h_end - t_start,
               ssm_bytes_per_frame=H.ssm_bytes_per_frame(f, rows, cfg["dtype"]))
    counters = _counters()
    si = res["sub_info"]
    info = dict(requests=len(window), chunks=chunks,
                sub_b1_launches=si.get("b1_launches"), sub_admit_groups=si.get("admit_groups"),
                captures_in_window=res["captured_in_window"], drained_s=run.t_drained - t_end,
                tap_bytes=tap.nbytes, gap_ms_q=quantiles_ms(gaps),
                step_ms_q=quantiles_ms(np.diff([t for t, _ in run.backlog
                                                if t_start <= t < t_end])),
                phase_ms_per_step={k: v * 1e3 / max(res["host_steps"], 1)
                                   for k, v in res["host_phase_s"].items()},
                ssm_state_bytes=counters.get("ssm.state_bytes"),
                ssm_state_bytes_counted=H.state_bytes(f, rows, cfg["dtype"]),
                ssm_state_resets=counters.get("ssm.state_resets"),
                params=H.n_params(cfg))
    sample = feeder.sample_rids()
    records = tap.find([{"key": r, "frames": run.specs[r].frames} for r in sample])
    info["sample_shards"] = sorted({rec["shard"] for rec in records.values()})
    failed = sum(1 for r in window if run.frames_out.get(r) != run.specs[r].frames)
    run.b = None
    sysm.engine = None
    del tap
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return dict(t_start=t_start, e2e=e2e, obs=obs, info=info, peaks=peaks,
                attempted=len(window), failed=failed,
                numbers=readings(run, feeder, sample, records, sysm, cell.controls))


def _counters() -> dict:
    """The program tracer's counters; {} where it keeps none."""
    from ptts_torch.utils import timing
    counters = getattr(timing, "counters", None)
    return {} if counters is None else counters()


def readings(run, feeder, sample, records, system, controls=()) -> dict:
    """serving.readings against the hybrid reference."""
    cfg = system.cfg
    fs = check.frame_samples(cfg)
    refs, out = H.references(system, cfg, controls)
    counts = {"missing": feeder.unsampled, "frames_bad": 0, "noise_bad": 0}
    window = [r for r in feeder.window_rids if run.specs[r].due is not None]
    counts["frames_bad"] = sum(1 for r in window if run.frames_out.get(r) != run.specs[r].frames)
    for rid in sample:
        spec, rec = run.specs[rid], records.get(rid)
        if rec is None or rid not in run.pcm:
            counts["missing"] += 1
            continue
        noise = torch.from_numpy(spec.noise)
        counts["noise_bad"] += int((rec["noise2"] != noise[:, :2]).any(dim=1).sum())
        prompt = refs["f32"].prompt(spec.ids.tolist(), system.voices[spec.voice])
        check.judge(refs, prompt, noise, rec["scaled"], rec["eos"], run.pcm[rid], fs, True, out)
    return check.numbers(out, counts)
