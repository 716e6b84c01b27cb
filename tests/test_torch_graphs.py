"""The port's device-resident frame state and its captured loops on the CPU
(tiny configs, f32), against the JAX package and against the port's own
eager loops.

* The FlowLM KV cursor, the Mimi ring cursor ``wc`` and the streaming frame
  index are 0-d device tensors: decode_step and decode_stream are held
  against the JAX package across ring wraps (1e-4 of max for values; cursors,
  masks and positions equal).
* The offline loop in chunks of N frames, one host check per chunk: against
  JAX's while_loop (frame counts and EOS steps equal, values 1e-4 of max)
  and bit-equal to the per-frame loop, frames after the end zero.
* CUDA graph replay, rehearsed here: ReplayOnCPU gives runtime/graphs'
  GraphCache its replay semantics on the CPU. The first warm-up calls
  run the body eagerly, the next traces it into an FX graph of aten ops
  (make_fx runs it once: that is the call's step), and later calls replay
  that graph without running any Python of the body, so a Python value that
  the body reads is baked in, as a CUDA graph bakes it, and a replay adds
  the kernel launches the trace counted, as runtime/graphs does. The offline loop, the
  streaming session and the batcher's k = 1 and k = K steps through it are
  bit-equal to their eager runs past both rings' wraps. The card runs the
  real graphs in tests/test_torch_cuda.py and chip_smoke.py phase 13.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch import convert  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.models import mimi_stream as tms  # noqa: E402
from ptts_torch.ops.cuda import build  # noqa: E402
from ptts_torch.parallel import mesh as pmesh  # noqa: E402
from ptts_torch.runtime import batching, graphs, streaming  # noqa: E402
from ptts_torch.runtime.batching import ContinuousBatcher  # noqa: E402
from ptts_torch.runtime.engine import TTSEngine  # noqa: E402
from ptts_tpu.models import flowlm as jfl  # noqa: E402
from ptts_tpu.models import mimi as jmi  # noqa: E402
from ptts_tpu.models import mimi_stream as jms  # noqa: E402

FC, MC = TINY_FLOWLM, TINY_MIMI
Params = tapi.Params


def close(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


class _Traced:
    """A traced body in the place of a CUDA graph: replay() runs it."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.outputs = self.fn()


class ReplayOnCPU(graphs.GraphCache):
    """GraphCache.run with a CUDA graph's semantics on the CPU (see the
    module docstring): ``warmup`` eager calls, then a trace, then
    replays, which add the kernel launches counted in the traced body as
    runtime/graphs does. ``calls`` counts the calls by kind."""

    def __init__(self):
        super().__init__()
        self.seen = {}
        self.traced = {}
        self.calls = {"eager": 0, "trace": 0, "replay": 0}

    def __len__(self):
        return len(self.traced)

    def run(self, key, device, body, warmup=graphs.WARMUP):
        if key in self.traced:
            self.calls["replay"] += 1
            graphs._replay(self.traced[key])
            return self.traced[key].graph.outputs
        self.seen[key] = self.seen.get(key, 0) + 1
        if self.seen[key] <= warmup:
            self.calls["eager"] += 1
            return body()
        outs = []

        def traced():
            outs.append(body())
            return outs[-1]

        entry = self.traced[key] = graphs._Entry()
        before = graphs._launch_counts()
        entry.graph = _Traced(make_fx(traced)())
        # the trace ran the body once: its launches count for this call
        entry.launches = graphs._held_launches(before)
        for fn, n, shapes in entry.launches:
            fn.launches += n
            fn.shapes.update(shapes)
        self.calls["trace"] += 1
        return outs[0]


@pytest.fixture(scope="module")
def flow_weights():
    host = jfl.random_weights(FC, seed=3, scale=0.3)
    return jfl.to_device(host, jnp.float32, FC), convert.flowlm_weights(host, FC)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("graphsmodel"), seed=6)
    return path


@pytest.fixture(scope="module")
def ctx(model_dir):
    return tapi.Context(model_dir, flowlm_cfg=FC, mimi_cfg=MC, device="cpu")


def replaying_engine(ctx) -> TTSEngine:
    """A CPU engine whose frame loops go through ReplayOnCPU."""
    eng = TTSEngine(ctx)
    eng._graphs_on, eng._graphs = True, ReplayOnCPU()
    return eng


# -- device cursors against the JAX package -------------------------------------


def test_decode_step_device_cursor_across_ring_matches_jax(flow_weights):
    """21 decode steps through a 5-column ring (it wraps four times), with
    streams 1 and 2 admitted afresh at cursors 7 and 12 (start = cursor, as
    the batcher admits): each step's output, the cursor, the write column,
    the positions and the validity mask equal the JAX package's."""
    jw, tw = flow_weights
    rng = np.random.default_rng(31)
    B, T, R = 3, 4, 5
    x = (rng.standard_normal((B, T, FC.d_model)) * 0.5).astype(np.float32)
    lens = np.array([4, 2, 3], np.int32)
    jc, _ = jfl.prefill_init(jw, jnp.asarray(x), jnp.asarray(lens), FC, T + R)
    tc, _ = tfl.prefill_init(tw, torch.from_numpy(x), torch.from_numpy(lens), FC, T + R)
    assert tc.cursor.shape == () and tc.cursor.dtype == torch.int32
    admit = {7: 1, 12: 2}
    for step in range(4 * R + 1):
        cursor = T + step
        if cursor in admit:
            b = admit[cursor]
            jc = jc._replace(start=jc.start.at[b].set(jc.cursor))
            tc.start[b] = tc.cursor
        assert int(tc.write_col) == int(jc.write_col) == T + (cursor - T) % R
        np.testing.assert_array_equal(tc.valid_mask().numpy(), np.asarray(jc.valid_mask()))
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
        inp = (rng.standard_normal((B, FC.d_model)) * 0.5).astype(np.float32)
        cursor_tensor = tc.cursor
        jc, jx = jfl.decode_step(jw, jc, jnp.asarray(inp), FC)
        tc, tx = tfl.decode_step(tw, tc, torch.from_numpy(inp), FC)
        close(tx, jx)
        assert tc.cursor is cursor_tensor  # advanced in place
        assert int(tc.cursor) == int(jc.cursor) == tc.cursor_host == cursor + 1
    close(tc.k, jc.k)
    close(tc.v, jc.v)


def test_decode_step_gate_keeps_the_cache(flow_weights):
    """live=False (the chunked loop's frames after the end): the cursor
    stays and the column keeps its old K/V."""
    _, tw = flow_weights
    rng = np.random.default_rng(32)
    x = torch.from_numpy((rng.standard_normal((2, 5, FC.d_model)) * 0.5).astype(np.float32))
    tc, _ = tfl.prefill_init(tw, x, torch.tensor([5, 3], dtype=torch.int32), FC, 9)
    k0, v0 = tc.k.clone(), tc.v.clone()
    inp = torch.from_numpy((rng.standard_normal((2, FC.d_model)) * 0.5).astype(np.float32))
    dead, _ = tfl.decode_step(tw, tc, inp, FC, live=torch.tensor(False))
    assert int(dead.cursor) == 5 and dead.cursor_host is None
    assert torch.equal(tc.k, k0) and torch.equal(tc.v, v0)
    live, _ = tfl.decode_step(tw, tc, inp, FC, live=torch.tensor(True))
    assert int(live.cursor) == 6 and not torch.equal(tc.k, k0)


def test_blocked_decode_needs_the_host_mirror(flow_weights):
    """The blocked decode attention reads the cursor's host mirror; a cache
    without one (a graph-driven cache) refuses it."""
    _, tw = flow_weights
    from ptts_torch.config import KernelFlags

    x = torch.zeros(2, 4, FC.d_model)
    tc, _ = tfl.prefill_init(tw, x, torch.tensor([4, 4], dtype=torch.int32), FC, 8)
    tc = dataclasses.replace(tc, cursor_host=None)
    with pytest.raises(ValueError, match="host mirror"):
        tfl.decode_step(tw, tc, torch.zeros(2, FC.d_model), FC, KernelFlags(decode_impl="blocked"))


@pytest.mark.parametrize("chunk,ring", [(2, 12), (3, 12), (3, 16), (5, 16)])
def test_mimi_ring_cursor_past_wraps_matches_jax(chunk, ring, monkeypatch):
    """decode_stream in chunks of Tc = 2 * chunk positions through a ring of
    12 or 16 slots, Tc dividing the ring (4 | 12, 6 | 12) or not (6, 10 in
    16): PCM within 1e-4 of max of the JAX decode_stream and the device
    cursor wc equal to JAX's after every chunk, over 40 frames."""
    monkeypatch.setattr(jms, "RING", ring)
    monkeypatch.setattr(tms, "RING", ring)
    host = jmi.random_weights(MC, seed=5, scale=0.3)
    jw, tw = jmi.to_device(host, cfg=MC), convert.mimi_weights(host, MC)
    B, frames = 2, 40
    lat = np.random.default_rng(33).standard_normal((B, frames, MC.latent_dim)).astype(np.float32)
    jstate, tstate = jms.init_state(jw, MC, B), tms.init_state(tw, MC, B)
    wc = tstate["ring"]["wc"]
    assert wc.shape == () and wc.dtype == torch.int32
    wraps = 0
    for f0 in range(0, frames, chunk):
        before = int(wc)
        jstate, jp = jms.decode_stream(jw, jstate, jnp.asarray(lat[:, f0:f0 + chunk]), MC)
        tstate, tp = tms.decode_stream(tw, tstate, torch.from_numpy(lat[:, f0:f0 + chunk]), MC)
        close(tp, jp)
        assert tstate["ring"]["wc"] is wc and int(wc) == int(jstate["ring"]["wc"])
        wraps += int(wc) <= before
        np.testing.assert_array_equal(tstate["ring"]["kpos"].numpy(),
                                      np.asarray(jstate["ring"]["kpos"]))
    assert wraps >= 2


def test_reset_state_restores_init_state(monkeypatch):
    """mimi_stream.reset_state returns a used state to init_state's values
    in place (bench_streaming refills its captured state with it)."""
    monkeypatch.setattr(tms, "RING", 12)
    tw = convert.mimi_weights(jmi.random_weights(MC, seed=5, scale=0.3), MC)
    state = tms.init_state(tw, MC, 2)
    fresh = tms.init_state(tw, MC, 2)
    for _ in range(3):  # 18 positions through 12 slots
        tms.decode_stream(tw, state, torch.ones(2, 3, MC.latent_dim), MC)
    ptr = state["ring"]["k"].data_ptr()
    tms.reset_state(state)
    flat = lambda s: [s["up"], s["dec_in"], s["dec_out"], *s["ring"].values(),  # noqa: E731
                      *(c for st in s["stages"] for c in st.values())]
    for got, want in zip(flat(state), flat(fresh)):
        assert torch.equal(got, want)
    assert state["ring"]["k"].data_ptr() == ptr


# -- the chunked offline loop --------------------------------------------------


def prefilled(tw, jw, B, T, F, seed, graphs=None):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, FC.d_model)) * 0.5).astype(np.float32)
    lens = np.array([T, 2, 4, 5][:B], np.int32)
    noise = rng.standard_normal((B, F, FC.latent_dim)).astype(np.float32)
    jc, jx0 = jfl.prefill_init(jw, jnp.asarray(x), jnp.asarray(lens), FC, T + F)
    tc, tx0 = tfl.prefill_init(tw, torch.from_numpy(x), torch.from_numpy(lens), FC, T + F,
                               graphs=graphs)
    return (jc, jx0), (tc, tx0), noise


WHILE_KW = dict(num_steps=2, eos_threshold=-0.5, eos_min_frames=2)


@pytest.mark.parametrize("chunk", [1, 3, 8, 16])
def test_chunked_while_loop_matches_jax(flow_weights, chunk, monkeypatch):
    """generate_latents_while with one host check per GRAPH_CHUNK = ``chunk``
    frames, replayed through ReplayOnCPU (1: the eager loop), ragged budgets
    and EOS that end the last stream after 12 of the 16 frames, mid-chunk
    for chunks of 8 and 16: frame counts and EOS steps equal JAX's
    while_loop, latents, EOS logits and taps within 1e-4 of max; every
    output bit-equal to the per-frame loop's; frames after the end zero; at
    most ceil(F / chunk) + 1 host checks."""
    monkeypatch.setattr(tfl, "GRAPH_CHUNK", chunk)
    graphs = ReplayOnCPU() if chunk > 1 else None
    jw, tw = flow_weights
    B, T, F = 4, 6, 16
    budgets = np.array([16, 3, 16, 5], np.int32)
    eos_after = np.array([4, 0, 5, 1], np.int32)
    kw = dict(max_frames=F, eos_after=eos_after, **WHILE_KW)
    (jc, jx0), (tc, tx0), noise = prefilled(tw, jw, B, T, F, 34, graphs)
    want = jfl.generate_latents_while(jw, jc, jx0, jnp.asarray(noise), FC,
                                      max_frames_per_stream=jnp.asarray(budgets), **kw)
    _, (tc1, tx1), _ = prefilled(tw, jw, B, T, F, 34)
    per_frame = tfl.generate_latents_while(tw, tc1, tx1, torch.from_numpy(noise), FC,
                                           max_frames_per_stream=torch.from_numpy(budgets), **kw)
    checks = tfl.HOST_CHECKS
    got = tfl.generate_latents_while(tw, tc, tx0, torch.from_numpy(noise), FC,
                                     max_frames_per_stream=torch.from_numpy(budgets),
                                     graphs=graphs, **kw)
    checks = tfl.HOST_CHECKS - checks
    used = got.frames_used.numpy()
    np.testing.assert_array_equal(used, np.asarray(want.frames_used))
    np.testing.assert_array_equal(got.eos_step.numpy(), np.asarray(want.eos_step))
    assert used.tolist() == [9, 3, 12, 5]  # every stream ended before the last frame
    for name in ("latents", "eos_logits", "first_cond", "first_flow"):
        close(getattr(got, name), getattr(want, name))
    for name in ("latents", "eos_logits", "first_cond", "first_flow", "frames_used", "eos_step",
                 "done", "x"):
        assert torch.equal(getattr(got, name), getattr(per_frame, name)), name
    assert torch.equal(got.cache.k, per_frame.cache.k) and torch.equal(got.cache.v,
                                                                       per_frame.cache.v)
    assert int(got.cache.cursor) == int(per_frame.cache.cursor) == T + used.max()
    assert (got.latents[:, used.max():] == 0).all() and (got.eos_logits[:, used.max():] == 0).all()
    assert checks <= math.ceil(F / chunk) + 1
    if chunk == 1:
        assert checks == used.max() + 1


def test_graph_loop_refuses_a_foreign_cache(flow_weights):
    """With graphs the loop reads the cache that prefill_init(graphs=) keeps:
    another cache is refused, not silently replaced."""
    jw, tw = flow_weights
    _, (tc, tx0), noise = prefilled(tw, jw, 2, 5, 8, 36)
    with pytest.raises(ValueError, match="prefill_init"):
        tfl.generate_latents_while(tw, tc, tx0, torch.from_numpy(noise), FC, max_frames=8,
                                   num_steps=1, graphs=ReplayOnCPU())


def test_chunked_fixed_loop_equals_per_frame(flow_weights, monkeypatch):
    """generate_latents (every frame runs, no host check) in replayed chunks
    of 4 (11 frames: 4 + 4 + 3) equals the per-frame loop bit for bit, and
    JAX's scan within 1e-4."""
    monkeypatch.setattr(tfl, "GRAPH_CHUNK", 4)
    jw, tw = flow_weights
    B, T, F = 3, 6, 11
    graphs = ReplayOnCPU()
    (jc, jx0), (tc, tx0), noise = prefilled(tw, jw, B, T, F, 35)
    kw = dict(max_frames=F, num_steps=1, eos_threshold=-0.4, eos_min_frames=1,
              eos_after=np.array([1, 0, 2], np.int32))
    want = jfl.generate_latents(jw, jc, jx0, jnp.asarray(noise), FC, **kw)
    one = tfl.generate_latents(tw, tc, tx0, torch.from_numpy(noise), FC, **kw)
    for _ in range(2):  # chunks of 4 run eager, traced, then replayed; the 3 eager, traced
        _, (tc2, tx2), _ = prefilled(tw, jw, B, T, F, 35, graphs)
        checks = tfl.HOST_CHECKS
        got = tfl.generate_latents(tw, tc2, tx2, torch.from_numpy(noise), FC, graphs=graphs, **kw)
        assert tfl.HOST_CHECKS == checks
        for name in ("latents", "eos_logits", "first_cond", "first_flow", "frames_used", "done",
                     "x"):
            assert torch.equal(getattr(got, name), getattr(one, name)), name
    assert graphs.calls == {"eager": 2, "trace": 2, "replay": 2}
    close(got.latents, want.latents)


# -- where graphs run ----------------------------------------------------------


def test_cpu_engine_runs_eagerly(ctx):
    """A CPU engine reports graphs off and keeps no captured loop; asking
    for graphs on the CPU raises, as GraphCache.run on a CPU device does."""
    eng = ctx.engine
    assert eng.graphs is False
    out = eng.generate_full("hello world", params=Params(num_frames=4, num_steps=1, seed=1))
    assert out.frames_used >= 1 and len(eng._graphs) == 0
    with pytest.raises(ValueError, match="CUDA"):
        TTSEngine(ctx, graphs=True)
    assert TTSEngine(ctx, graphs=False).graphs is False
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GraphCache().run("k", "cpu", lambda: None)


def test_graphs_follow_the_flags(ctx):
    """engine.graphs is read from the flags at each call: the blocked
    decode attention and validate mode turn it off."""
    from ptts_torch.config import KernelFlags

    eng = replaying_engine(ctx)
    assert eng.graphs
    for change in (dict(decode_impl="blocked"), dict(validate=True)):
        eng.flags = dataclasses.replace(KernelFlags(), **change)
        assert not eng.graphs, change
    eng.flags = KernelFlags()
    assert eng.graphs


# -- replay against eager (ReplayOnCPU) ------------------------------------------


def test_offline_replay_equals_eager(ctx):
    """generate_full and a ragged batch_generate through the replayed loop
    (chunks of flowlm.GRAPH_CHUNK, the prompt in the kept cache, calls of
    other inputs reusing the graph) bit-equal to the eager engine: EOS on
    with ragged budgets, and EOS off."""
    eager, eng = ctx.engine, replaying_engine(ctx)
    texts = ["hello world", "how low", "who who hello", "world"]
    for p in (Params(num_frames=21, num_steps=2, seed=3, eos_threshold=-2.0, eos_min_frames=3),
              Params(num_frames=19, num_steps=1, seed=4, eos_enabled=False)):
        for text in texts[:2]:
            a, b = eng.generate_full(text, params=p), eager.generate_full(text, params=p)
            assert a.frames_used == b.frames_used
            for name in ("latents", "first_cond", "first_flow"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            np.testing.assert_array_equal(a.audio.samples, b.audio.samples)
        for a, b in zip(eng.batch_generate(texts, params=p), eager.batch_generate(texts, params=p)):
            np.testing.assert_array_equal(a.samples, b.samples)
    assert eng._graphs.calls["replay"] > 0 and eng._graphs.calls["trace"] > 0


def test_offline_warmup_captures(ctx):
    """TTSEngine.warmup runs EOS off, so every chunk of its bucket runs and
    the chunk's graph is captured there, as the JAX warm-up compiles."""
    eng = replaying_engine(ctx)
    eng.warmup(batch_sizes=(2,), decode_audio=False)
    # 8 chunks of a 64-frame bucket: one eager, one traced, six replays
    assert eng._graphs.calls == {"eager": 1, "trace": 1, "replay": 6}


@pytest.mark.parametrize("B", [1, 3])
def test_session_replay_equals_eager(ctx, monkeypatch, B):
    """StreamingSession: 32 frames with the Mimi ring cut to 16 slots (it
    wraps every 8 frames here; 384 slots at 16 positions per frame wrap
    every 24 at full width), EOS off and EOS on: every chunk bit-equal to
    the eager session's; the frame counter is a device tensor advanced by
    the replay."""
    monkeypatch.setattr(tms, "RING", 16)
    monkeypatch.setattr(streaming, "GraphCache", ReplayOnCPU)
    eager, eng = ctx.engine, replaying_engine(ctx)
    texts = ["hello world", "how low", "who who"][:B]
    for p in (Params(num_frames=32, num_steps=1, seed=8, eos_enabled=False),
              Params(num_frames=32, num_steps=2, seed=9, eos_threshold=-1.0, eos_min_frames=4)):
        got = streaming.StreamingSession.start(eng, texts, params=p)
        want = streaming.StreamingSession.start(eager, texts, params=p)
        assert got._graphs is not None and want._graphs is None
        a, b = list(got), list(want)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.pcm_i16, y.pcm_i16)
            np.testing.assert_array_equal(x.active, y.active)
            np.testing.assert_array_equal(x.eos_logits, y.eos_logits)
        assert int(got._frame_dev) == got.frame >= len(a)
        assert got._graphs.calls["replay"] == got.frame - graphs.WARMUP - 1


def serve(engine, mesh=None, n=14, **kw):
    """``n`` requests of 9-14 frames (two with forced EOS) through 4 slots of
    a pool whose decode ring is 16 columns: 14 lap it twice."""
    b = ContinuousBatcher(engine, slots=4, max_len=48, admit_chunk=2, prefix_budget=32,
                          mesh=mesh, **kw)
    eos = dict(eos_enabled=True, eos_threshold=-1e9, eos_min_frames=2, eos_after=3)
    rids = []
    for i in range(n):
        extra = eos if i in (3, 7) else dict(eos_enabled=False)
        p = Params(num_frames=9 + i % 6, num_steps=1 + i % 2, seed=40 + i, temp=0.4, **extra)
        rids.append(b.submit(["hello world", "how low", "who who"][i % 3], params=p))
    return b, rids, b.drain()


@pytest.mark.parametrize("kw", [dict(frames_per_step=1),
                                dict(frames_per_step=4, split_admit=True),
                                dict(frames_per_step=4, pipeline=True),
                                dict(frames_per_step=3, collect_pcm=False, pipeline=True)],
                         ids=["k1", "k4_split", "k4_pipelined", "k3_device_bound"])
def test_batcher_replay_equals_eager(ctx, monkeypatch, kw):
    """The batcher's k-frame shard step replayed: results (PCM, frames)
    bit-equal to the eager batcher's, past the 16-column FlowLM ring and
    the Mimi ring cut to 16 slots; k = 1 and k = K each captured once."""
    monkeypatch.setattr(tms, "RING", 16)
    monkeypatch.setattr(batching, "GraphCache", ReplayOnCPU)
    eng = replaying_engine(ctx)
    b, rids, got = serve(eng, **kw)
    _, _, want = serve(ctx.engine, **kw)
    R = b.max_len - b.prefix_budget
    assert int(b.shards[0].cache.cursor) - b.prefix_budget > 2 * R
    assert int(b.shards[0].mimi_state["ring"]["wc"]) < 16
    for rid in rids:
        assert got[rid].frames == want[rid].frames > 0
        np.testing.assert_array_equal(got[rid].pcm_i16, want[rid].pcm_i16)
    assert b._graphs.calls["replay"] > 0
    assert {key[1] for key in b._graphs.traced} <= {1, kw["frames_per_step"] - 1,
                                                     kw["frames_per_step"]}


def test_replay_counts_a_kernel_registered_anywhere(monkeypatch):
    """A wrapper registered with ops/cuda/build.kernel, here inside the
    test, is counted at every replay of a body that launched it: the
    replay reads the registry, not a list of kernels."""
    monkeypatch.setattr(build, "WRAPPERS", dict(build.WRAPPERS))
    monkeypatch.setattr(build, "SIGNATURES", dict(build.SIGNATURES))

    @build.kernel("ptts_registered_in_a_test", [])
    def doubled(x):
        doubled.launches += 1                       # what build.launch counts on the card
        doubled.shapes[("f32", x.shape[0], 1)] += 1
        return x * 2

    assert build.WRAPPERS["doubled"] is doubled
    cache, x = ReplayOnCPU(), torch.ones(3)
    outs = [cache.run("doubled", "cpu", lambda: doubled(x)) for _ in range(graphs.WARMUP + 4)]
    assert cache.calls == {"eager": graphs.WARMUP, "trace": 1, "replay": 3}
    assert all(torch.equal(o, 2 * x) for o in outs)
    assert doubled.launches == graphs.WARMUP + 4
    assert doubled.shapes == {("f32", 3, 1): graphs.WARMUP + 4}


def test_sharded_batcher_replay_equals_eager(ctx, monkeypatch):
    """The 2 x 2 rehearsal mesh (2 host groups x 2 shards, all on the CPU):
    every shard's step replayed, results bit-equal to the eager pool's."""
    monkeypatch.setattr(batching, "GraphCache", ReplayOnCPU)
    hm = pmesh.make_multihost_mesh(2, ["cpu"] * 4)
    b, rids, got = serve(replaying_engine(ctx), mesh=hm, n=6)
    _, _, want = serve(ctx.engine, mesh=hm, n=6)
    for rid in rids:
        assert got[rid].frames == want[rid].frames
        np.testing.assert_array_equal(got[rid].pcm_i16, want[rid].pcm_i16)
    assert {key[0] for key in b._graphs.traced} == {0, 1, 2, 3}
    assert len({int(sh.cache.cursor.data_ptr()) for sh in b.shards}) == 4


def test_launch_calls_count_the_host_launches(tmp_path):
    """utils/profiling.launch_calls reads a trace's CUDA runtime and driver
    events: kernel launches, graph launches and copies apart; device
    events and host ops are not launches."""
    import gzip
    import json

    from ptts_torch.utils import profiling

    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 3.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 6.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 9.0, "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 15.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync", "ts": 17.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 19.0, "dur": 9.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 30.0},
    ]
    with gzip.open(tmp_path / "trace_1.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert profiling.launch_calls(str(tmp_path)) == {"kernel": 3, "graph": 1, "copy": 2}
