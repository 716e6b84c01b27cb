"""The readers of the program's own tracing (metrics/ that read the
tracer's ring or the marker kernels) against hand counts on synthetic
observations, with nothing to read (an empty ring, no markers, a program
without a ring: each gives None), and on a traced CPU run of each cell."""

import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

import tiny
from benchmark import check, spans
from benchmark.run import run_cell
from benchmark.trace import SubWindow

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = ["batcher.admit_to_first_chunk_p95_ms", "batcher.admit_fill_pct",
       "step.flowlm_device_ms_per_frame", "step.mimi_device_ms_per_frame",
       "model.mimi_wall_pct", "step.replay_idle_pct"]


def metric(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_at(t0, window_s=1.0, events=()):
    sub = SubWindow()
    sub.t0, sub.t1, sub.events = t0, t0 + window_s, list(events)
    return sub


def use_ring(monkeypatch, recs):
    monkeypatch.setattr(spans, "tracer_records", lambda: list(recs))


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def on_card(event, card):
    return dict(event, args={"device": card, "stream": 7})


# one card's stretch of 1 ms: kernels a, b, c; the host launching in the
# first gap, nothing of its own in the second
CARD0 = [kernel("a", 0, 100), kernel("b", 300, 100), kernel("c", 450, 50),
         host("bench.step", 0, 600),
         {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 100, "dur": 200}]


@pytest.mark.parametrize("cards", [None, [0]], ids=["cards_from_events", "card_given"])
@pytest.mark.parametrize("named", [False, True], ids=["no_device_arg", "device_0"])
def test_one_card_summary_is_the_union_of_its_events(cards, named):
    """On one card the summary is what it was before cards were told
    apart: the busy union of every device event, the kernel sums, the idle
    gaps by the host's doing."""
    events = [on_card(e, 0) if named and e["cat"] == "kernel" else e for e in CARD0]
    sub = SubWindow(cards)
    sub.t0, sub.t1, sub.events = 0.0, 1000e-6, events
    s = sub.summary()
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["busy_by_card"] == [[0, pytest.approx(250e-6)]]
    assert s["device_ops"] == [["a", pytest.approx(1e-4)], ["b", pytest.approx(1e-4)],
                               ["c", pytest.approx(5e-5)]]
    assert s["idle_gaps"] == [["bench.step:cudaLaunchKernel", pytest.approx(200e-6)],
                              ["bench.step:no host op", pytest.approx(50e-6)]]
    obs = {"sub_summary": s}
    assert metric("device.idle_pct")(obs) == pytest.approx(75.0)


def test_cards_are_summarized_apart_over_one_stretch():
    """Two cards: each card's own union, their mean as busy_s, kernel time
    summed over both, each idle gap named by its card; a card given that
    ran nothing reads idle throughout."""
    events = [on_card(e, 0) if e["cat"] == "kernel" else e for e in CARD0]
    events.append(on_card(kernel("a", 0, 500), 1))
    sub = SubWindow([0, 1])
    sub.t0, sub.t1, sub.events = 0.0, 1000e-6, events
    s = sub.summary()
    assert s["busy_by_card"] == [[0, pytest.approx(250e-6)], [1, pytest.approx(500e-6)]]
    assert s["busy_s"] == pytest.approx(375e-6)
    assert s["device_ops"] == [["a", pytest.approx(6e-4)], ["b", pytest.approx(1e-4)],
                               ["c", pytest.approx(5e-5)]]
    assert s["idle_gaps"] == [["cuda:0 bench.step:cudaLaunchKernel", pytest.approx(200e-6)],
                              ["cuda:0 bench.step:no host op", pytest.approx(50e-6)]]
    obs = {"sub_summary": s}
    assert metric("device.idle_pct")(obs) == pytest.approx(62.5)
    sub.cards = [0, 1, 2]
    s = sub.summary()
    assert s["busy_s"] == pytest.approx(750e-6 / 3)
    assert s["busy_by_card"][2] == [2, 0.0]


def test_dispatch_per_step_reads_the_batchers_dispatch_phase():
    read = metric("batcher.dispatch_ms_per_step")
    obs = {"host_phase_s": {"admit": 0.5, "dispatch": 0.12, "collect": 2.0}, "host_steps": 40}
    assert read(obs) == pytest.approx(3.0)
    assert read({"host_phase_s": {}, "host_steps": 40}) is None
    assert read({"host_phase_s": {"dispatch": 0.1}, "host_steps": 0}) is None


def test_model_mfu_counts_every_chip_of_the_cell():
    """The model's share of the peak is over every chip the cell asks for
    (one where the observations name none)."""
    obs = {"delivered_flops": 2e12, "flops_window_s": 1.0, "dtype": "bf16"}
    one = metric("model.mfu_pct")(obs)
    assert metric("model.mfu_pct")(dict(obs, chips=1)) == one
    assert metric("model.mfu_pct")(dict(obs, chips=4)) == pytest.approx(one / 4)


# a serving window: the profiler starts at 100.0; the last record before it
# ends at 99.5, and the host window is the 10 s before that
SERVE = [
    ("event", "ptts.enqueue", 80.0, 80.0, 0, 0, {"rid": 1}),
    ("span", "ptts.admit_group", 89.0, 89.01, 5, 4, {"rids": (1,), "lengths": (50,),
                                                      "shape": (32, 64)}),
    ("event", "ptts.first_chunk", 89.03, 89.03, 0, 0, {"rid": 1}),   # before the window
    ("span", "ptts.admit_group", 90.0, 90.01, 7, 6, {"rids": (2, 3), "lengths": (45, 57),
                                                      "shape": (32, 64)}),
    ("count", "admit.positions", 90.0, 90.0, 0, 7, 102),
    ("count", "admit.launched_positions", 90.0, 90.0, 0, 7, 2048),
    ("event", "ptts.first_chunk", 90.02, 90.02, 0, 0, {"rid": 2}),
    ("event", "ptts.first_chunk", 90.05, 90.05, 0, 0, {"rid": 3}),
    ("span", "ptts.admit_group", 95.0, 95.01, 9, 8, {"rids": (2,), "lengths": (40,),
                                                      "shape": (32, 64)}),   # rid 2 again
    ("count", "admit.positions", 95.0, 95.0, 0, 9, 40),
    ("count", "admit.launched_positions", 95.0, 95.0, 0, 9, 2048),
    ("event", "ptts.first_chunk", 95.04, 95.04, 0, 0, {"rid": 2}),
    ("span", "ptts.collect", 99.4, 99.5, 10, 0, None),
    ("count", "admit.positions", 100.5, 100.5, 0, 0, 999),   # in the profiled stretch
    ("event", "ptts.first_chunk", 100.6, 100.6, 0, 0, {"rid": 3}),
]


def test_admit_to_first_chunk_is_the_p95_of_each_requests_own_stamps(monkeypatch):
    use_ring(monkeypatch, SERVE)
    obs = {"sub": sub_at(100.0), "flops_window_s": 10.0}
    assert spans.host_window(obs, SERVE) == pytest.approx((89.5, 99.5))
    waits = [0.02, 0.05, 0.04]             # rid 2, rid 3, rid 2 from its newest admission
    assert metric(NEW[0])(obs) == pytest.approx(float(np.percentile(waits, 95)) * 1e3)


def test_admit_fill_is_positions_over_launched(monkeypatch):
    use_ring(monkeypatch, SERVE)
    obs = {"sub": sub_at(100.0), "flops_window_s": 10.0}
    assert metric(NEW[1])(obs) == pytest.approx((102 + 40) / 4096 * 100)


OFFLINE = [
    ("span", "ptts.prompts", 1.0, 1.1, 2, 1, None),
    ("span", "ptts.frame_loop", 1.1, 3.0, 4, 3, None),
    ("span", "ptts.mimi_decode", 3.0, 3.5, 5, 3, None),
    ("span", "ptts.group", 1.1, 3.5, 3, 1, {"B": 16, "frames": 375}),
    ("span", "ptts.batch_generate", 1.0, 3.6, 1, 0, {"texts": 64}),        # warm-up
    ("span", "ptts.mimi_decode", 5.0, 5.8, 15, 13, None),
    ("span", "ptts.group", 4.0, 5.8, 13, 11, {"B": 16, "frames": 375}),
    ("span", "ptts.mimi_decode", 6.0, 6.2, 16, 14, None),
    ("span", "ptts.group", 5.8, 6.2, 14, 11, {"B": 16, "frames": 200}),
    ("span", "ptts.batch_generate", 4.0, 6.5, 11, 0, {"texts": 64}),
    ("span", "ptts.mimi_decode", 7.0, 7.5, 25, 23, None),
    ("span", "ptts.group", 6.5, 7.5, 23, 21, {"B": 16, "frames": 375}),
    ("span", "ptts.batch_generate", 6.5, 8.5, 21, 0, {"texts": 64}),
    ("span", "ptts.prompts", 8.5, 8.52, 32, 31, None),                   # the traced pass
]


def test_mimi_wall_reads_the_window_passes_only(monkeypatch):
    use_ring(monkeypatch, OFFLINE)
    # the window: passes 2 and 3, 4.5 s; the traced pass's prompts end last
    obs = {"sub": sub_at(9.0), "flops_window_s": 4.5}
    want = ((5.8 - 5.0) + (6.2 - 6.0) + (7.5 - 7.0)) / ((6.5 - 4.0) + (8.5 - 6.5)) * 100
    assert metric(NEW[4])(obs) == pytest.approx(want)


def step_trace(t, k_flow, k_mimi):
    """One replayed step at t: markers around FlowLM and Mimi kernels."""
    ev = [kernel("ptts_mark_flowlm", t, 2)]
    ev += [kernel("gemv", t + 5 + 10 * i, 8) for i in range(k_flow)]
    m = t + 5 + 10 * k_flow
    ev.append(kernel("ptts_mark_mimi", m, 2))
    ev += [kernel("conv", m + 5 + 10 * i, 8) for i in range(k_mimi)]
    e = m + 5 + 10 * k_mimi
    ev.append(kernel("ptts_mark_end", e, 2))
    ev.append(kernel("copy", e + 5, 3))
    return ev


def test_flowlm_and_mimi_device_time_per_frame():
    events = step_trace(1000, 3, 2) + step_trace(2000, 3, 2) + [kernel("admit", 500, 50)]
    obs = {"sub": sub_at(0.0, events=events), "sub_info": {"frames": 2}}
    # FlowLM: marker 2 + 3 x 8 per step; Mimi: marker 2 + 2 x 8 (us), per frame in ms
    assert metric(NEW[2])(obs) == pytest.approx(2 * (2 + 24) / 2 * 1e-3)
    assert metric(NEW[3])(obs) == pytest.approx(2 * (2 + 16) / 2 * 1e-3)


def test_markers_pair_on_each_card():
    """Four cards replay their steps at nearly the same time, so their
    marker kernels interleave in the trace: each card's markers are paired
    with its own, and the cards' times averaged, as busy_s is."""
    events = []
    for c in range(4):
        k = 3 + c                                   # card c runs 3 + c FlowLM kernels
        events += [on_card(e, c) for e in step_trace(1000 + c, k, 2) + step_trace(2000 + c, k, 2)]
    obs = {"sub": sub_at(0.0, events=events), "sub_info": {"frames": 2}}
    flow = [2 * (2 + 8 * (3 + c)) / 2 * 1e-3 for c in range(4)]
    assert metric(NEW[2])(obs) == pytest.approx(sum(flow) / 4)
    assert metric(NEW[3])(obs) == pytest.approx(2 * (2 + 16) / 2 * 1e-3)
    one = [e for e in events if e["args"]["device"] == 1]
    assert metric(NEW[2])({"sub": sub_at(0.0, events=one),
                           "sub_info": {"frames": 2}}) == pytest.approx(flow[1])


def test_replay_idle_counts_the_gaps_inside_replays():
    events = [kernel("a", 0, 100), kernel("b", 300, 100), kernel("c", 450, 50),
              kernel("d", 1000, 100), host("ptts.graph.replay", 120, 250),
              host("ptts.graph.replay", 600, 100), host("bench.frame_loop", 0, 2000)]
    # gaps: 100-300 (mid 200, in the first replay), 400-450 (mid 425: none),
    # 500-1000 (mid 750: past the second replay's end 700)
    obs = {"sub": sub_at(0.0, window_s=2000e-6, events=events)}
    assert metric(NEW[5])(obs) == pytest.approx(200 / 2000 * 100)
    events[-2] = host("ptts.graph.replay", 600, 200)                # now 750 is inside
    obs = {"sub": sub_at(0.0, window_s=2000e-6, events=events)}
    assert metric(NEW[5])(obs) == pytest.approx(700 / 2000 * 100)


@pytest.mark.parametrize("recs", [[], None], ids=["empty_ring", "no_ring"])
@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(monkeypatch, name, recs):
    """An empty ring, or a program without one (the parent of this
    tracing), and a trace without markers or replay ranges: None."""
    monkeypatch.setattr(spans, "tracer_records", lambda: None if recs is None else list(recs))
    read = metric(name)
    plain = [kernel("gemv", 10, 5), host("bench.step", 0, 100)]
    obs = {"sub": sub_at(100.0, events=plain), "flops_window_s": 10.0,
           "sub_info": {"frames": 4}}
    assert read(obs) is None
    assert read({"sub": None, "flops_window_s": 10.0, "sub_info": {}}) is None


def test_a_program_without_a_ring_gives_none(monkeypatch):
    from ptts_torch.utils import timing
    monkeypatch.delattr(timing, "records")
    assert spans.tracer_records() is None


CELLS = [("bf16-serve-short", "serve-short-open", ["batcher.admit_to_first_chunk_p95_ms",
                                                   "batcher.admit_fill_pct"]),
         ("f32-offline-long", "offline-long-batch", ["model.mimi_wall_pct"])]


@pytest.mark.parametrize("workload,mixname,names", CELLS)
def test_traced_cpu_run_reads_the_host_spans(workload, mixname, names):
    torch.set_num_threads(2)
    out = run_cell(workload, 3000000041, 1.0, True, device="cpu", cfg=tiny.cfg("f32"),
                   mix=tiny.mix(mixname), limits=check.limits(workload),
                   t_process=time.perf_counter())
    assert out["correct"]
    bench = json.load(open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")))
    listed = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]}
    assert set(names) <= listed and set(names) <= set(out["metrics"]), out["metrics"]
    v = {n: out["metrics"][n]["value"] for n in names}
    assert all(x > 0 for x in v.values()), v
    if "batcher.admit_fill_pct" in v:
        assert v["batcher.admit_fill_pct"] <= 100.0
    if "model.mimi_wall_pct" in v:
        assert v["model.mimi_wall_pct"] < 100.0
