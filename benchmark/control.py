"""Readings that set the limits of ``correct``: a cell run on several seeds
in one process, each run's compared numbers for the program and for the
controls, the reference computed in the next precision below the
configuration's (fp8 for bf16, TF32 for float32) and put in the program's
place on the same prompts, noise and history.

    python3 benchmark/control.py --workload bf16-serve-short --seeds 1,2,3 \\
        --seconds 5 --controls fp8

One JSON row per seed. The benchmark's own runs never compute a control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark.run import power_limit, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", default="fp8")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    print(json.dumps({"card": power_limit()}), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(args.workload, seed, args.seconds, False,
                       controls=tuple(args.controls.split(",")), t_process=t)
        print(json.dumps({"seed": seed, "correct": out["correct"], "readings": out["readings"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "run_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
