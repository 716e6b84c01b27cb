"""Each cell's run driven end to end on the CPU at a tiny size, with the
cell's own limits: a sound run comes out correct; a run whose timed path
is broken underneath comes out not correct, once for each fault the cell
can have; the lower-precision control comes out not correct; a traced run
reads the per-layer metrics that exist off the card. The search for a
card is skipped here (run_cell takes the device); the CLI refuses to run
without one."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import tiny
from benchmark import check
from benchmark.run import run_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [("bf16-serve-short", "serve-short-open"), ("bf16-serve-long", "serve-long-saturated"),
         ("f32-offline-long", "offline-long-batch"),
         ("bf16-serve-long", "serve-long-saturated-4card")]
SERVING = [c for c in CELLS if c[0] != "f32-offline-long"]
CONTROL = {"bf16": "fp8", "f32": "tf32"}


def _run(workload, mixname, seed=20250, trace=False, controls=()):
    torch.set_num_threads(2)
    dtype = "f32" if workload.startswith("f32") else "bf16"
    # the program runs its tiny model in float32 here: the faults and the
    # control are held to the cell's own limits
    return run_cell(workload, seed, 1.0, trace, device="cpu", cfg=tiny.cfg("f32"),
                    mix=tiny.mix(mixname), limits=check.limits(workload),
                    controls=controls, t_process=time.perf_counter()), dtype


@pytest.mark.parametrize("workload,mixname", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(workload, mixname):
    out, dtype = _run(workload, mixname, controls=(CONTROL[dtype_of(workload)],))
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    ctl = out["readings"][CONTROL[dtype]]
    ok, rows = check.decide(dict(out["readings"]["program"], **ctl), check.limits(workload))
    assert not ok, rows
    assert list(out)[-3:] == ["check", "readings", "info"]


def dtype_of(workload):
    return "f32" if workload.startswith("f32") else "bf16"


def _state_unchanged(orig):
    def frame_step(w, cache, x, *a, **k):
        out = orig(w, cache, x, *a, **k)
        return (out[0], x) + tuple(out[2:])
    return frame_step


def _half_batch(orig):
    def frame_step(*a, **k):
        out = list(orig(*a, **k))
        # every other row left out, the mean taken over the rest: a pool
        # filled from its low rows (a tiny open-loop run) still has rows in
        # each half
        lat = out[2].clone()
        lat[1::2] = lat[0::2].mean(0, keepdim=True)
        out[2] = lat
        return tuple(out)
    return frame_step


def _token_altered(orig):
    def frame_step(w, cache, x, noise, time_embs, i, *a, **k):
        out = list(orig(w, cache, x, noise, time_embs, i, *a, **k))
        hit = (torch.as_tensor(i) == 2).reshape(-1, 1)
        out[2] = torch.where(hit, out[2] + 0.5, out[2])
        return tuple(out)
    return frame_step


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _token_altered],
                         ids=["state_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("workload,mixname", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, workload, mixname, fault):
    from ptts_torch.models import flowlm
    monkeypatch.setattr(flowlm, "frame_step", fault(flowlm.frame_step))
    out, _ = _run(workload, mixname)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("workload,mixname", SERVING)
def test_altered_chunk_is_not_correct(monkeypatch, workload, mixname):
    from ptts_torch.runtime import streaming
    orig = streaming.quantize_i16_device
    # each chunk's samples come out in reverse order
    monkeypatch.setattr(streaming, "quantize_i16_device", lambda pcm: orig(pcm.flip(-1)))
    out, _ = _run(workload, mixname)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("workload,mixname", CELLS)
def test_traced_run_reads_its_layers(workload, mixname):
    out, _ = _run(workload, mixname, trace=True)
    assert out["correct"]
    bench = json.load(open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")))
    host = {"batcher.queue_wait_p95_ms", "batcher.admit_ms_per_step", "model.admit_mfu_pct",
            "model.mfu_pct", "batcher.dispatch_ms_per_step"}
    want = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]} & host
    assert want <= set(out["metrics"]), out["metrics"]
    assert "busy_s" in out["device"] and "breakdown" in out


def test_cli_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "bf16-serve-short", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_pool_over_four_cards_shards_the_cell(monkeypatch):
    """The four-card mix's pool is four shards of its slots on a mesh of
    the CPU repeated, and the sampled requests' frames are found on every
    shard."""
    from benchmark import serving
    seen = {}
    orig = serving.ServeRun.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        seen["rows"] = [sh.n_slots for sh in self.b.shards]

    monkeypatch.setattr(serving.ServeRun, "__init__", init)
    out, _ = _run("bf16-serve-long", "serve-long-saturated-4card")
    assert seen["rows"] == [4, 4, 4, 4]
    assert out["correct"] and out["check"]["missing"]["value"] == 0, out["check"]
    assert set(out["metrics"]) == {"audio_s_per_s", "chunk_gap_p95_ms", "setup_s"}
    assert out["metrics"]["audio_s_per_s"]["value"] > 0
    assert out["info"]["sample_shards"] == [0, 1, 2, 3]


@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_fault_in_one_shard_is_not_correct(monkeypatch, shard):
    """A fault confined to one shard of the four-card mix's pool (its frame
    step's latents altered, the other shards sound) is caught: the check
    draws its sample from every shard."""
    from benchmark import serving
    from ptts_torch.models import flowlm
    bad = {}
    orig_init = serving.ServeRun.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        bad["k"] = self.b.shards[shard].cache.k.data_ptr()

    orig = flowlm.frame_step

    def frame_step(w, cache, *a, **k):
        out = list(orig(w, cache, *a, **k))
        if cache.k.data_ptr() == bad.get("k"):
            out[2] = out[2] + 0.5
        return tuple(out)

    monkeypatch.setattr(serving.ServeRun, "__init__", init)
    monkeypatch.setattr(flowlm, "frame_step", frame_step)
    out, _ = _run("bf16-serve-long", "serve-long-saturated-4card")
    assert not out["correct"], out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted({c[0] for c in CELLS}))
def test_cell_runs_correct_on_the_card(workload):
    bench = json.load(open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")))
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", workload,
                        "--seed", "3000000077", "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu", out["check"]
    assert out["device"]["count"] == chips
