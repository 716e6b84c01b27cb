"""The benchmark of ptts_torch, the PyTorch and CUDA port of Pocket-TTS.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the CUDA cards of this machine: builds
the configuration's model from the seed, warms up the cell's shapes, drives
the cell's traffic for ``--seconds``, checks the timed path's outputs
against the plain reference, and prints one JSON line last: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics read from a
profiled stretch (``--trace 1``), with the numbers compared for
``correct`` beside their limits under "check". Everything a cell needs is
found by name: configs/<config>.json, traffic/<traffic>.json (whose "kind"
names the traffic module that drives the run and gathers what the check
reads), metrics/<metric>.py, limits/<workload>.json. The kernel is built
once into the program's own compile cache in the checkout
(ptts_torch/_build/), which later runs there find.
With no CUDA card, or fewer than the cell asks for, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "ptts_tpu")


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell_metrics(bench: dict, group: str, workload: str) -> list:
    return [m for m in bench[group] if workload in m.get("workloads", [workload])]


def e2e_value(e2e: dict, name: str) -> float:
    """An end-to-end metric's value from the drive's readings: its own, or
    for a metric split off by kind of cell (``<base>.<kind>``, the same
    quantity under a bound of its own) its base's."""
    return e2e[name] if name in e2e else e2e[name.rsplit(".", 1)[0]]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def read_metric(name: str, obs: dict):
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"),
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             cfg: dict = None, mix: dict = None, controls=(), limits: dict = None,
             t_process: float = None) -> dict:
    """One run of a cell; returns the result line's object (with
    "readings" holding every candidate's compared numbers). The traffic
    mix's "kind" names the module under traffic/ whose ``drive`` runs it.
    ``cfg``, ``mix`` and ``limits`` replace the cell's files (the CPU tests
    run a cell at a tiny size); ``controls``: lower precisions of the
    reference to read beside the program (control.py)."""
    import torch

    from benchmark import check

    t_process = T_PROCESS if t_process is None else t_process
    bench = load_bench()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = cfg or json.load(open(os.path.join(ROOT, cfg_entry["file"])))
    mix = mix or load_json("traffic", f"{cell['traffic']}.json")
    lim = limits or check.limits(workload)
    kind = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()           # the allocators of every card, before their peaks reset
        for i in range(cell["chips"]):
            torch.cuda.reset_peak_memory_stats(i)
    r = kind.drive(types.SimpleNamespace(cfg=cfg, mix=mix, seed=seed, seconds=seconds,
                                         trace=trace, device=dev, controls=tuple(controls)))
    correct, rows = check.decide(r["numbers"]["program"], lim)
    out = {"correct": correct, "attempted": r["attempted"], "failed": r["failed"]}
    info = dict({"workload": workload, "seed": seed, "seconds": seconds, "trace": int(trace)},
                **r["info"])
    obs = dict(r["obs"], cfg=cfg, mix=mix, dtype=cfg["dtype"], chips=cell["chips"])
    info["memory_peak_bytes_per_card"] = [int(p) for p in r["peaks"]]
    if trace:
        sub = obs.get("sub")
        obs["sub_summary"] = sub.summary() if sub is not None else None
        if obs["sub_summary"]:
            info["busy_s_per_card"] = obs["sub_summary"]["busy_by_card"]
        metrics = {}
        for m in cell_metrics(bench, "per_layer", workload):
            v = read_metric(m["name"], obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        info["per_layer_missing"] = [m["name"] for m in cell_metrics(bench, "per_layer", workload)
                                     if m["name"] not in metrics]
    else:
        e2e = dict(r["e2e"], setup_s=r["t_start"] - t_process)
        metrics = {m["name"]: {"value": e2e_value(e2e, m["name"]), "unit": m["unit"]}
                   for m in cell_metrics(bench, "end_to_end", workload)}
    devinfo = {"platform": "gpu" if on_card else dev.type,
               "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
               "count": len(r["peaks"]) if on_card else 1,
               "memory_peak_bytes": int(max(r["peaks"]))}
    if trace:
        s = obs.get("sub_summary") or {"busy_s": 0.0, "window_s": 0.0}
        devinfo.update(busy_s=s["busy_s"], window_s=s["window_s"])
    out.update(metrics=metrics, device=devinfo)
    if trace and obs.get("sub_summary"):
        out["breakdown"] = {"device_ops": obs["sub_summary"]["device_ops"],
                            "idle_gaps": obs["sub_summary"]["idle_gaps"]}
    out["check"] = {name: {"value": v, "limit": lv} for name, v, lv in rows}
    out["readings"] = r["numbers"]
    out["info"] = info
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_bench()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"this cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {', '.join(bad)}: the benchmark runs without JAX",
              file=sys.stderr)
        return 3
    print(json.dumps({"info": out.pop("info"), "readings": out.pop("readings"),
                      "card": power_limit()}), flush=True)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
