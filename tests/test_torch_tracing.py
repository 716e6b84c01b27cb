"""The port's tracer (ptts_torch/utils/timing.py) and the spans, events and
counts the program records with it (tiny configs, CPU):

* the tracer: nesting and parents, the ring's bound, aggregates that do
  not grow with the calls, profiler ranges only while a profiler records;
* the batcher: one ptts.admit_group span per admitted request with its rid
  and its prompt length, admit.* counters equal to a hand count, the step's
  phases the spans that phase_s sums;
* the offline engine: one ptts.group span per length group, nested under
  ptts.batch_generate, with ptts.frame_loop and ptts.mimi_decode inside;
* the serving frame body launches the three marker kernels in order;
* counts made while a graph is captured count again at every replay.

The card's part (markers in a profiled graph replay, B2 launches counted
at each replay) is in tests/test_torch_tracing_cuda.py.
"""

import collections
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch.ops.cuda import build, decode_attention  # noqa: E402
from ptts_torch.ops.cuda import fused_attention as fa  # noqa: E402
from ptts_torch.ops.cuda import markers  # noqa: E402
from ptts_torch.runtime import graphs, streaming  # noqa: E402
from ptts_torch.runtime.batching import ContinuousBatcher  # noqa: E402
from ptts_torch.text import prepare_text  # noqa: E402
from ptts_torch.utils import timing  # noqa: E402

Params = tapi.Params


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("tracemodel"), seed=6)
    return tapi.Context(path, flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI, device="cpu")


@pytest.fixture
def ring():
    """An empty ring and empty counters for the test."""
    timing.clear()
    yield
    timing.clear()


def spans_named(name, recs=None):
    return [r for r in (recs or timing.records()) if r[timing.KIND] == timing.SPAN
            and r[timing.NAME] == name]


# -- the tracer ------------------------------------------------------------------


def test_nesting_parents_and_attributes(ring):
    with timing.span("ptts.outer", rid=7) as outer:
        with timing.span("ptts.inner") as inner:
            timing.event("ptts.mark", rid=7)
            timing.count("things", 3)
        with timing.span("ptts.inner"):
            pass
    recs = timing.records()
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r[timing.NAME]].append(r)
    (o,) = by_name["ptts.outer"]
    assert o[timing.PARENT] == 0 and o[timing.DATA] == {"rid": 7}
    assert [r[timing.PARENT] for r in by_name["ptts.inner"]] == [outer.sid, outer.sid]
    assert by_name["ptts.mark"][0][timing.PARENT] == inner.sid
    assert by_name["things"][0][timing.DATA] == 3 and timing.counters() == {"things": 3}
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert (o[timing.T0], o[timing.T1]) == (outer.t0, outer.t1)
    # records come in the order they were written: each span at its end
    assert [r[timing.NAME] for r in recs] == ["ptts.mark", "things", "ptts.inner",
                                              "ptts.inner", "ptts.outer"]


def test_parents_are_per_thread(ring):
    import threading

    seen = {}

    def other():
        with timing.span("ptts.other") as s:
            seen["parent"] = s.parent

    with timing.span("ptts.main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen["parent"] == 0


@pytest.mark.parametrize("writes", [3, 8, 21])
def test_ring_keeps_the_newest(monkeypatch, writes):
    monkeypatch.setattr(timing, "_ring", timing._Ring(8))
    for i in range(writes):
        timing.event("ptts.e", i=i)
    got = [r[timing.DATA]["i"] for r in timing.records()]
    assert got == list(range(max(0, writes - 8), writes))


def test_aggregates_are_bounded():
    st = timing.Stats(max_labels=2)
    for i in range(1000):
        st.record("a", float(i % 7))
    st.record("b", 2.0)
    st.record("c", 1.0)              # past max_labels: not aggregated
    s = st.summary()
    assert set(s) == {"a", "b"} and len(st._agg) == 2
    assert s["a"] == {"count": 1000, "total_ms": float(sum(i % 7 for i in range(1000))),
                      "min_ms": 0.0, "max_ms": 6.0,
                      "mean_ms": round(sum(i % 7 for i in range(1000)) / 1000, 3)}
    assert all(len(a) == 4 for a in st._agg.values())


def test_profiler_range_only_while_recording(ring):
    from torch.profiler import ProfilerActivity, profile

    with timing.span("ptts.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("ptts.during"):
            torch.ones(3).sum()
        with timing.span("FlowLM latents"):
            pass
    with timing.span("ptts.after"):
        pass
    names = {e.name for e in prof.events()}
    assert {"ptts.during", "ptts.FlowLM latents"} <= names
    assert not {"ptts.before", "ptts.after"} & names
    assert len(spans_named("ptts.during")) == 1


def test_counts_held_in_a_capture_count_at_each_replay(ring, monkeypatch):
    """GraphCache takes a capture's counts (the tracer's and the kernel
    wrappers') back off, then adds them at every replay."""
    for fn in build.WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "shapes", collections.Counter(fn.shapes))
    w = fa.window_attention_qkv
    n0, s0 = w.launches, collections.Counter(w.shapes)
    c0 = fa.causal_attention_qkv.launches
    entry = graphs._Entry()
    before = graphs._launch_counts()
    with timing.capture_counts() as held:
        timing.count("in.body", 2)
        w.launches += 1                               # what a launch in the body counts
        w.shapes[("bf16", 2, 1024)] += 1
    entry.launches = graphs._held_launches(before)
    assert (w.launches, w.shapes) == (n0, s0) and timing.counters() == {}
    entry.graph, entry.counts = type("G", (), {"replay": lambda self: None})(), dict(held)
    for _ in range(3):
        graphs._replay(entry)
    assert w.launches == n0 + 3 and w.shapes[("bf16", 2, 1024)] == s0[("bf16", 2, 1024)] + 3
    assert timing.counters() == {"in.body": 6}
    assert fa.causal_attention_qkv.launches == c0


def test_decode_attention_launches_in_a_capture_count_at_each_replay(monkeypatch):
    """The decode attention's wrapper is counted like B1's and B2's: a
    launch in a captured body counts once per replay, by its shape."""
    d = decode_attention.decode_attention
    assert build.WRAPPERS["decode_attention"] is d
    for fn in build.WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "shapes", collections.Counter(fn.shapes))
    n0, shape = d.launches, ("bf16", 256, 544)
    s0 = d.shapes[shape]
    entry = graphs._Entry()
    before = graphs._launch_counts()
    d.launches += 6                                   # one per layer in the body
    d.shapes[shape] += 6
    entry.launches = graphs._held_launches(before)
    assert d.launches == n0 and d.shapes[shape] == s0
    entry.graph = type("G", (), {"replay": lambda self: None})()
    for _ in range(4):
        graphs._replay(entry)
    assert d.launches == n0 + 24 and d.shapes[shape] == s0 + 24


# -- the program's spans ---------------------------------------------------------


def test_batcher_admit_groups_and_counters(ctx, ring):
    b = ContinuousBatcher(ctx.engine, slots=3, max_len=96, admit_chunk=2, prefix_budget=32)
    texts = ["hello world", "how low", "who who hello", "world", "hello"]
    rids = [b.submit(t, params=Params(num_frames=3, num_steps=1, seed=2, eos_enabled=False))
            for t in texts]
    res = b.drain()
    assert sorted(res) == rids
    recs = timing.records()
    groups = spans_named("ptts.admit_group", recs)
    rid_spans = collections.Counter(rid for g in groups for rid in g[timing.DATA]["rids"])
    assert rid_spans == {rid: 1 for rid in rids}
    # voice frames (3) + ids + 1: the prompt admit_slots_ids builds, and the
    # rows of the engine's host prefix
    cond, _ = ctx.engine._voice_cond(None)
    want = {}
    for rid, text in zip(rids, texts):
        ids = ctx.tokenize(prepare_text(text)[0])
        want[rid] = 3 + len(ids) + 1
        assert want[rid] == len(ctx.engine._build_prefix(ids, cond))
    for g in groups:
        d = g[timing.DATA]
        assert [want[r] for r in d["rids"]] == list(d["lengths"]) and d["shape"] == (2, 32)
    c = timing.counters()
    assert c["admit.positions"] == sum(want.values())
    assert c["admit.launched_positions"] == len(groups) * 2 * 32 == b.n_admit_groups * 64
    # one first chunk per request, after its admission; one stamp per enqueue
    events = [r for r in recs if r[timing.KIND] == timing.EVENT]
    first = {r[timing.DATA]["rid"]: r[timing.T0] for r in events
             if r[timing.NAME] == "ptts.first_chunk"}
    admitted = {rid: g[timing.T0] for g in groups for rid in g[timing.DATA]["rids"]}
    assert set(first) == set(rids) and all(first[r] > admitted[r] for r in rids)
    assert first == {rid: res[rid].first_chunk_t for rid in rids}
    assert sorted(r[timing.DATA]["rid"] for r in events
                  if r[timing.NAME] == "ptts.enqueue") == rids


def test_batcher_phases_are_the_step_spans(ctx, ring):
    """phase_s sums the step spans' own clock reads: admit + admit_wait is
    the ptts.admit spans' time, dispatch and collect run from one span's end
    to the next's; the admit groups' time is phase_s admit."""
    b = ContinuousBatcher(ctx.engine, slots=2, max_len=96, admit_chunk=2, prefix_budget=32)
    for t in ["hello world", "how low", "world"]:
        b.submit(t, params=Params(num_frames=4, num_steps=1, seed=3, eos_enabled=False))
    b.drain()
    recs = timing.records()
    dur = {n: sum(r[timing.T1] - r[timing.T0] for r in spans_named(n, recs))
           for n in ("ptts.admit", "ptts.admit_group", "ptts.collect")}
    ph = b.phase_s
    assert ph["admit"] + ph["admit_wait"] == pytest.approx(dur["ptts.admit"], rel=1e-9)
    assert ph["admit"] == pytest.approx(dur["ptts.admit_group"], rel=1e-9)
    assert ph["collect"] >= dur["ptts.collect"] > 0
    assert len(spans_named("ptts.admit", recs)) == b.n_steps
    waits = spans_named("ptts.collect.wait", recs)
    collects = {r[timing.SID] for r in spans_named("ptts.collect", recs)}
    assert waits and all(r[timing.PARENT] in collects for r in waits)


def test_batch_generate_spans(ctx, ring):
    texts = ["hello world how", "who", "hello hello world world who", "low",
             "world who hello how low", "how"]
    p = Params(num_steps=1, seed=4, eos_enabled=False)
    out = ctx.engine.batch_generate(texts, params=p, length_buckets=3)
    assert len(out) == len(texts)
    recs = timing.records()
    (bg,) = spans_named("ptts.batch_generate", recs)
    (prompts,) = spans_named("ptts.prompts", recs)
    groups = spans_named("ptts.group", recs)
    assert len(groups) == 3 and prompts[timing.PARENT] == bg[timing.SID]
    assert all(g[timing.PARENT] == bg[timing.SID] and g[timing.DATA]["B"] == 2 for g in groups)
    ids = [g[timing.SID] for g in groups]
    for name in ("ptts.frame_loop", "ptts.mimi_decode"):
        assert [r[timing.PARENT] for r in spans_named(name, recs)] == ids
    for g in groups:
        inner = [r for r in recs if r[timing.PARENT] == g[timing.SID]]
        assert [r[timing.NAME] for r in inner] == ["ptts.frame_loop", "ptts.mimi_decode"]
        assert g[timing.T0] <= inner[0][timing.T0] <= inner[1][timing.T1] <= g[timing.T1]
    # each group runs to its longest budget: (words + 2 s) x 12.5 frames
    assert sorted(g[timing.DATA]["frames"] for g in groups) == [37, 62, 87]
    assert bg[timing.DATA] == {"texts": len(texts)}
    # the offline loop's host checks are spans of their own (eager: one per frame)
    assert len(spans_named("ptts.loop.check", recs)) > 0


def test_engine_stats_list_the_new_aggregates(ctx, ring):
    ctx.engine.batch_generate(["hello", "world"], params=Params(num_frames=2, num_steps=1,
                                                                seed=1))
    s = ctx.engine.stats()
    assert {"ptts.batch_generate", "ptts.group", "ptts.frame_loop",
            "ptts.mimi_decode"} <= set(s)
    assert set(s["ptts.group"]) == {"count", "total_ms", "min_ms", "max_ms", "mean_ms"}
    assert isinstance(s["counters"], dict)


@pytest.mark.parametrize("k", [1, 3])
def test_frame_body_marks_flowlm_mimi_end(ctx, monkeypatch, k):
    """fused_stream_steps, at k = 1 and at k = 3, launches the markers
    before the FlowLM frames, before the Mimi decode and at the end."""
    calls = []
    monkeypatch.setattr(markers, "device_mark", lambda which, like: calls.append(
        ("mark", which)))
    orig_flow, orig_mimi = streaming.flow_frame_step, streaming.mimi_stream.decode_stream

    def flow(*a, **kw):
        calls.append("flowlm")
        return orig_flow(*a, **kw)

    def mimi(*a, **kw):
        calls.append("mimi")
        return orig_mimi(*a, **kw)

    monkeypatch.setattr(streaming, "flow_frame_step", flow)
    monkeypatch.setattr(streaming.mimi_stream, "decode_stream", mimi)
    b = ContinuousBatcher(ctx.engine, slots=2, max_len=96, admit_chunk=2, prefix_budget=32,
                          frames_per_step=k)
    b.submit("hello world", params=Params(num_frames=3, num_steps=1, seed=5,
                                          eos_enabled=False))
    b.drain()
    code = {("mark", markers.FLOWLM): "F", "flowlm": "f", ("mark", markers.MIMI): "M",
            "mimi": "m", ("mark", markers.END): "E"}
    # each body: the FlowLM marker, its frames (k, or 1 and k - 1 where it
    # admits), the Mimi marker, the decode, the end marker
    assert re.fullmatch(r"(Ff{1,%d}MmE)+" % k, "".join(code[c] for c in calls)), calls


def test_markers_do_nothing_on_the_cpu():
    x = torch.zeros(2)
    for which in (markers.FLOWLM, markers.MIMI, markers.END, markers.SSM_IN, markers.SSM_OUT):
        assert markers.device_mark(which, x) is None
    assert markers.KERNELS == ("ptts_mark_flowlm", "ptts_mark_mimi", "ptts_mark_end",
                               "ptts_mark_ssm_in", "ptts_mark_ssm_out")
    # the benchmark pairs markers by prefix: no name may start another
    assert not any(a != b and b.startswith(a) for a in markers.KERNELS for b in markers.KERNELS)
    assert np.all(x.numpy() == 0)
