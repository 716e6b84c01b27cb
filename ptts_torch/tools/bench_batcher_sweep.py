"""Sustained-batcher operating-point sweep on the card (port of
tools/bench_batcher_sweep.py).

Grid-sweeps the ContinuousBatcher bench (ptts_torch.bench.run_batcher_bench)
over

    slots  x  frames_per_step (K)  x  mode

where mode is serial or pipelined (dispatch step N+1 before collecting N,
overlapping the done-flag readback with device compute), in device-bound
collection (PCM stays on the card; only done flags are read back -- the
co-located serving regime) unless ``--collect-pcm``. Each point targets
max(reqs * slots / 256, 200) finished requests (requests average ~30
frames), within ``--max-seconds``. The checkpoint is uploaded once for the
whole grid; PTTS_BENCH_WARMUP_STEPS (default 12) sets each point's untimed
steps, as in the bench.

    python -m ptts_torch.tools.bench_batcher_sweep                  # default grid
    python -m ptts_torch.tools.bench_batcher_sweep --slots 256,512 --k 8,16 --modes pipe
    PTTS_BENCH_DTYPE=f32 python -m ptts_torch.tools.bench_batcher_sweep --reqs 1200

Prints one JSON line per grid point (with the card's name and power limit)
and a final summary table to stderr. On the card only: with no card it
prints no result and exits non-zero; a point that raises fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .. import bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", default="256,384,512")
    ap.add_argument("--k", default="4,8,16")
    ap.add_argument("--modes", default="serial,pipe", help="comma list of serial|pipe")
    ap.add_argument("--reqs", type=int, default=1200)
    ap.add_argument("--dtype", default=os.environ.get("PTTS_BENCH_DTYPE", "bf16"))
    ap.add_argument("--collect-pcm", action="store_true",
                    help="read PCM back per step instead of device-bound")
    ap.add_argument("--max-seconds", type=float, default=60.0)
    args = ap.parse_args(argv)
    if not bench.require_card("ptts_torch.tools.bench_batcher_sweep"):
        return 2

    slots_list = [int(s) for s in args.slots.split(",")]
    k_list = [int(k) for k in args.k.split(",")]
    modes = args.modes.split(",")
    warmup = int(os.environ.get("PTTS_BENCH_WARMUP_STEPS", "12"))
    device = bench.device_info()
    weights = bench.device_weights(bench.DTYPES[args.dtype], torch.device("cuda"),
                                   *bench.configs())

    rows = []
    for slots in slots_list:
        for k in k_list:
            for mode in modes:
                # the target scales with slots so each point runs a
                # comparable number of steps
                reqs = max(args.reqs * slots // 256, 200)
                streams, p50, fin, wall = bench.run_batcher_bench(
                    slots, args.dtype, reqs, max_seconds=args.max_seconds,
                    frames_per_step=k, collect_pcm=args.collect_pcm,
                    pipeline=mode == "pipe", label=f"sweep {mode}", warmup_steps=warmup,
                    weights=weights)
                row = {"slots": slots, "k": k, "mode": mode,
                       "streams": round(streams, 1),
                       "first_chunk_p50_ms": round(p50, 1),
                       "finished": fin, "wall_s": round(wall, 1), "device": device}
                rows.append(row)
                print(json.dumps(row), flush=True)

    best = max(rows, key=lambda r: r["streams"])
    print("\n[sweep] slots  K  mode    streams  p50_ms", file=sys.stderr)
    for r in rows:
        star = " *" if r is best else ""
        print(f"[sweep] {r['slots']:>5} {r['k']:>2}  {r['mode']:<7}"
              f"{r['streams']:>8.1f} {r['first_chunk_p50_ms']:>7.1f}{star}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
