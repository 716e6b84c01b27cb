"""The open-loop knee sweep of a serving cell, run once on the chip to fix
the cell's offered rate.

    python3 benchmark/sweep.py --workload bf16-serve-short --seed N --seconds 8 \\
        --rates 100,150,200

One process, one model; for each rate a fresh batcher runs the cell's own
traffic (priming, warm-up, a window of ``--seconds``) and one JSON row is
printed: offered and achieved audio-s/s, how fast the backlog of
outstanding requests grew over the window's second half (requests/s), the
first-audio p95 and the generator's lateness. The knee is the highest rate
whose backlog does not grow; the cell runs at four fifths of it.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.run import load_bench, load_json, power_limit  # noqa: E402


def sweep(workload: str, seed: int, seconds: float, rates, device="cuda", cfg=None, mix=None):
    import numpy as np
    import torch

    from benchmark import system as S
    from benchmark.serving import ServeRun, p95
    from benchmark.traffic import open_loop_serve

    bench = load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = cfg or json.load(open(os.path.join(
        os.path.dirname(HERE), next(c for c in bench["configs"]
                                    if c["name"] == cell["config"])["file"])))
    mix = mix or load_json("traffic", f"{cell['traffic']}.json")
    sysm = S.build(cfg, seed, torch.device(device), mix["voices"])
    rows = []
    for rate in rates:
        m = copy.deepcopy(mix)
        m["rate_rps"] = float(rate)
        m["drain_s"] = 5.0
        bc = m["batcher"]
        run = ServeRun(sysm, m, seed, seconds, False)
        feeder = open_loop_serve.Feeder(run, m, cfg, seed, seconds)
        # the cell's frame tap, so that each rate runs the cell's own step
        run.tap = tap = S.FrameTap(cfg["flowlm"]["latent_dim"], feeder.watch_slots,
                                   bc["max_len"] - bc["prefix_budget"])
        tap.bind(run.b.shards)
        tap.install()
        try:
            run.run(feeder)
        finally:
            tap.uninstall()
        t0, t1 = run.t_start, run.t_end
        chunks, _, _ = run.landed_in(t0, t1)
        offered = sum(run.specs[r].frames for r in feeder.window_rids) / 12.5 / seconds
        half = [(t, n) for t, n in run.backlog if t0 + seconds / 2 <= t < t1]
        growth = (float(np.polyfit([t for t, _ in half], [n for _, n in half], 1)[0])
                  if len(half) > 2 else float("nan"))
        fa = p95(run.first_audio(feeder.window_rids))
        row = {"rate_rps": rate, "offered_audio_s_per_s": offered,
               "achieved_audio_s_per_s": chunks / 12.5 / seconds,
               "backlog_growth_per_s": growth,
               "backlog_end": run.backlog[-1][1] if run.backlog else 0,
               "first_audio_p95_ms": fa * 1e3 if fa is not None else None,
               "lateness_max_ms": max(run.lateness) * 1e3 if run.lateness else 0.0,
               "unfinished": sum(1 for r in feeder.window_rids if r not in run.frames_out)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del run, feeder, tap
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="bf16-serve-short")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    print(json.dumps({"card": power_limit()}), flush=True)
    sweep(args.workload, args.seed, args.seconds, [float(r) for r in args.rates.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
