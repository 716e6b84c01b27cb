"""Offline batch-size sweep on the card (port of tools/bench_batch_sweep.py):
does the offline bench's value scale past B = 256?

Runs ptts_torch.bench.run_bench (bf16, modes "on" and "ragged") at each
batch size.

    python -m ptts_torch.tools.bench_batch_sweep [B ...]     # default 256 384 512
Env: PTTS_BENCH_FRAMES (50), PTTS_BENCH_REPEATS (2).

Prints one JSON line per batch size (with the card's name and power limit)
plus a summary line {"sweep": rows, "best": row}. On the card only: with no
card it prints no result and exits non-zero; a batch size that raises fails
the run.
"""

from __future__ import annotations

import json
import os
import sys

from .. import bench


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not bench.require_card("ptts_torch.tools.bench_batch_sweep"):
        return 2
    sizes = [int(a) for a in argv] or [256, 384, 512]
    frames = int(os.environ.get("PTTS_BENCH_FRAMES", "50"))
    repeats = int(os.environ.get("PTTS_BENCH_REPEATS", "2"))
    device = bench.device_info()
    rows = []
    for b in sizes:
        r = bench.run_bench(b, frames, "bf16", repeats, modes=("on", "ragged"))
        row = {"batch": b,
               "streams_on": r["value"],
               "ragged": r["detail"]["ragged_eos_streams"],
               "wall_s": r["detail"]["wall_s"],
               "compile_s": r["detail"]["compile_s"],
               "device": device}
        rows.append(row)
        print(json.dumps(row), flush=True)
    best = max(rows, key=lambda r: r["streams_on"])
    print(json.dumps({"sweep": rows, "best": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
