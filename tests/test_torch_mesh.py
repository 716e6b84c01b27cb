"""The port's mesh (ptts_torch/parallel/mesh.py), the batcher sharded over it,
the dry run (ptts_torch/dryrun.py) and ptts_torch/utils/profiling.py, on the
CPU at tiny sizes. A mesh here repeats the CPU device, as the JAX tests use
8 virtual CPU devices (tests/conftest.py).

Gates: sharded offline generation within 1e-4 of the JAX package's
unsharded run on the same weights (the models tests' bound) and within 2e-5
of the port's unsharded run (tests/test_sharding.py's bound); stream
independence bit-exact; the sharded batcher's frames equal to the JAX
sharded batcher's and its int16 PCM within 8 LSB of it (the port-vs-JAX
batcher bound) and within 1 LSB of the port's unsharded batcher (a late
admission decodes over other ring columns, whose float sum order differs;
tests/test_batching.py allows the same); the profiling summaries exact.
"""

import dataclasses
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch import convert, dryrun  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.parallel import mesh as pmesh  # noqa: E402
from ptts_torch.runtime import batching  # noqa: E402
from ptts_torch.runtime.batching import ContinuousBatcher  # noqa: E402
from ptts_torch.utils import profiling  # noqa: E402
from ptts_tpu import api as japi  # noqa: E402
from ptts_tpu.models import flowlm as jfl  # noqa: E402
from ptts_tpu.models import mimi as jmi  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FC, MC = TINY_FLOWLM, TINY_MIMI
Params = japi.Params
CPU8 = ["cpu"] * 8


def max_lsb(a, b) -> int:
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    assert a.shape == b.shape
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.fixture(scope="module")
def mesh8():
    return pmesh.make_mesh(CPU8)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("tmeshmodel"), seed=6)
    return path


@pytest.fixture(scope="module")
def ctx(model_dir):
    return tapi.Context(model_dir, flowlm_cfg=FC, mimi_cfg=MC, device="cpu")


# -- the mesh -------------------------------------------------------------------


def test_mesh_setup(mesh8):
    assert mesh8.size == 8
    assert mesh8.axis_names == (pmesh.BATCH_AXIS,)
    assert mesh8.shape == {pmesh.BATCH_AXIS: 8}
    assert mesh8.device_list == [torch.device("cpu")] * 8
    assert pmesh.pad_batch_to_mesh(13, mesh8) == 16
    assert pmesh.num_host_groups(mesh8) == 1
    hmesh = pmesh.make_multihost_mesh(2, CPU8)
    assert hmesh.axis_names == (pmesh.DCN_AXIS, pmesh.BATCH_AXIS)
    assert tuple(hmesh.shape.values()) == (2, 4) and hmesh.shape[pmesh.DCN_AXIS] == 2
    assert len(hmesh.devices) == 2 and all(len(row) == 4 for row in hmesh.devices)
    assert pmesh.num_host_groups(hmesh) == 2
    with pytest.raises(ValueError, match="host groups"):
        pmesh.make_multihost_mesh(3, CPU8)
    with pytest.raises(ValueError, match="one device type"):
        pmesh.make_mesh(["cpu", "cuda:0"])


def test_make_mesh_raises_without_a_gpu(monkeypatch):
    """No CUDA device and no explicit list: make_mesh raises rather than
    quietly building a CPU mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_multihost_mesh(2)


def test_cuda_devices_get_an_index(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert pmesh.normalize_device("cuda") == torch.device("cuda", 3)
    assert pmesh.normalize_device("cuda:1") == torch.device("cuda", 1)
    assert pmesh.make_mesh(["cuda"] * 2).device_list == [torch.device("cuda", 3)] * 2


def test_shard_weights_copies_once_per_device(mesh8):
    """A repeated device gets one copy; tensors already on it are shared,
    and a None buffer stays None."""
    host = jmi.random_weights(MC, seed=4, scale=0.3)
    w = convert.mimi_weights(host, MC)
    per_dev = pmesh.shard_weights(mesh8, w)
    assert list(per_dev) == [torch.device("cpu")]
    got = per_dev[torch.device("cpu")]
    assert got is not w
    assert got.quant_w.data_ptr() == w.quant_w.data_ptr()
    assert got.transformer.in_proj.data_ptr() == w.transformer.in_proj.data_ptr()
    assert got.stages[1].up_w1.data_ptr() == w.stages[1].up_w1.data_ptr()
    assert (got.transformer.ls1 is None) == (w.transformer.ls1 is None)


def test_batch_pieces_split_and_gather(mesh8):
    """shard_batch_array / shard_cache / shard_mimi_stream_state cut at the
    batch dims of the JAX layout into independent copies; gather_batch
    restores the original exactly."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 3, 5)).astype(np.float32))
    parts = pmesh.shard_batch_array(mesh8, x)
    assert [tuple(p.shape) for p in parts] == [(2, 3, 5)] * 8
    assert all(p.is_contiguous() and p.data_ptr() != x.data_ptr() for p in parts)
    assert torch.equal(pmesh.gather_batch(parts), x)
    with pytest.raises(ValueError, match="divide"):
        pmesh.shard_batch_array(mesh8, x[:12])

    cache = tfl.make_cache(FC, 16, 12)
    cache.k.copy_(torch.arange(cache.k.numel(), dtype=torch.float32).view_as(cache.k))
    cache.prefix_len.copy_(torch.arange(16, dtype=torch.int32))
    cache = tfl.seek(cache, 9, 7)
    caches = pmesh.shard_cache(mesh8, cache)
    assert all(int(c.cursor) == 9 and c.t0 == 7 and c.cursor_host == 9 for c in caches)
    # each position advances its own device cursor
    assert len({c.cursor.data_ptr() for c in caches} | {cache.cursor.data_ptr()}) == 9
    assert all(c.k.shape == (FC.num_layers, 2, 12, FC.num_heads, FC.head_dim) for c in caches)
    assert torch.equal(pmesh.gather_batch([c.k for c in caches], batch_dim=1), cache.k)
    assert [c.prefix_len.tolist() for c in caches][3] == [6, 7]

    from ptts_torch.models import mimi_stream

    state = mimi_stream.init_state(convert.mimi_weights(jmi.random_weights(MC, seed=1), MC), MC,
                                   16)
    state["ring"]["kpos"].copy_(torch.arange(16, dtype=torch.int32)[:, None])
    state["ring"]["wc"].fill_(5)
    states = pmesh.shard_mimi_stream_state(mesh8, state)
    assert len(states) == 8 and all(int(s["ring"]["wc"]) == 5 for s in states)
    assert len({s["ring"]["wc"].data_ptr() for s in states}) == 8
    assert states[2]["ring"]["k"].shape[1] == 2 and states[2]["up"].shape[0] == 2
    assert states[2]["ring"]["kpos"][:, 0].tolist() == [4, 5]
    assert len(states[0]["stages"]) == len(MC.ratios)
    assert states[7]["stages"][0]["res1"].shape[0] == 2


# -- sharded offline generation --------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    return jfl.random_weights(FC, seed=9, scale=0.3), jmi.random_weights(MC, seed=4, scale=0.3)


def test_sharded_generation_matches_jax_and_unsharded(mesh8, weights):
    """Prefill, generate_latents and mimi.decode over 8 positions, 2 streams
    each, against the JAX package's unsharded run on the same weights (1e-4)
    and the port's unsharded run (2e-5)."""
    fhost, mhost = weights
    B, T0, FRAMES = 16, 4, 3
    rng = np.random.default_rng(0)
    prefix = (rng.standard_normal((B, T0, FC.d_model)) * 0.3).astype(np.float32)
    lengths = np.full((B,), T0, np.int32)
    noise = (rng.standard_normal((B, FRAMES, FC.latent_dim)) * 0.5).astype(np.float32)

    jw = jfl.to_device(fhost, cfg=FC)
    jcache, jx0 = jfl.prefill(jw, jfl.make_cache(FC, B, T0 + FRAMES), jnp.asarray(prefix),
                              jnp.asarray(lengths), FC)
    jres = jfl.generate_latents(jw, jcache, jx0, jnp.asarray(noise), FC, max_frames=FRAMES,
                                num_steps=1, eos_enabled=True)
    jpcm = jmi.decode(jmi.to_device(mhost, cfg=MC), jfl.scale_latents(jw, jres.latents), MC)

    tw, tm = convert.flowlm_weights(fhost, FC), convert.mimi_weights(mhost, MC)
    args = (torch.from_numpy(prefix), torch.from_numpy(lengths), torch.from_numpy(noise), FC,
            MC, FRAMES)
    one = pmesh.make_mesh(["cpu"])
    base, base_pcm = dryrun.sharded_generate(one, {one.device_list[0]: tw},
                                             {one.device_list[0]: tm}, *args)
    res, pcm = dryrun.sharded_generate(mesh8, pmesh.shard_weights(mesh8, tw),
                                       pmesh.shard_weights(mesh8, tm), *args)
    assert len(res) == len(pcm) == 8
    latents = pmesh.gather_batch([r.latents for r in res])
    eos = pmesh.gather_batch([r.eos_logits for r in res])
    pcm = pmesh.gather_batch(pcm)
    np.testing.assert_allclose(latents.numpy(), np.asarray(jres.latents), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(eos.numpy(), np.asarray(jres.eos_logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pcm.numpy(), np.asarray(jpcm), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(latents.numpy(), base[0].latents.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(eos.numpy(), base[0].eos_logits.numpy(), atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(pcm.numpy(), base_pcm[0].numpy(), atol=2e-5, rtol=2e-5)


def test_stream_independence(mesh8, weights):
    """Changing one stream's prompt changes that stream only: every other
    stream is bit-equal (no coupling across rows or positions)."""
    B, T0, FRAMES = 8, 3, 2
    rng = np.random.default_rng(3)
    prefix = (rng.standard_normal((B, T0, FC.d_model)) * 0.3).astype(np.float32)
    noise = torch.from_numpy((rng.standard_normal((B, FRAMES, FC.latent_dim)) * 0.5)
                             .astype(np.float32))
    lengths = torch.full((B,), T0, dtype=torch.int32)
    fws = pmesh.shard_weights(mesh8, convert.flowlm_weights(weights[0], FC))

    def run(px):
        res, _ = dryrun.sharded_generate(mesh8, fws, None, torch.from_numpy(px), lengths, noise,
                                         FC, MC, FRAMES)
        return pmesh.gather_batch([r.latents for r in res]).numpy()

    a = run(prefix)
    mutated = prefix.copy()
    mutated[5] += 1.0
    b = run(mutated)
    for s in range(B):
        if s == 5:
            assert np.abs(a[s] - b[s]).max() > 1e-6
        else:
            np.testing.assert_array_equal(a[s], b[s], err_msg=f"stream {s} leaked")


# -- the sharded batcher ---------------------------------------------------------

SPECS = [  # tests/test_batching.py::test_sharded_batcher_matches_unsharded
    ("hello world", Params(num_frames=3, num_steps=1, seed=31, temp=0.5, eos_enabled=False)),
    ("how low can it go", Params(num_frames=5, num_steps=2, seed=32, temp=0.7, eos_enabled=True,
                                 eos_threshold=-1e9, eos_min_frames=2, eos_after=1)),
    ("hello hello", Params(num_frames=2, num_steps=1, seed=33, temp=0.4, eos_enabled=False)),
    ("more text here", Params(num_frames=4, num_steps=1, seed=34, temp=0.6, eos_enabled=False)),
    ("last one", Params(num_frames=3, num_steps=2, seed=35, temp=0.8, eos_enabled=False)),
]
POOL = dict(slots=4, max_len=64, admit_chunk=2, prefix_budget=32, max_num_steps=2)


def hmesh4():
    return pmesh.make_multihost_mesh(2, ["cpu"] * 4)


def run_specs(b, specs):
    rids = [b.submit(t, params=p) for t, p in specs]
    return rids, b.drain()


def test_pool_layout_over_a_host_mesh(ctx):
    """One shard per position, each with its usable rows then its own trash
    row; host groups own contiguous global rows; every shard's tensors on
    its device. slots split as evenly as they go."""
    b = ContinuousBatcher(ctx.engine, mesh=hmesh4(), **POOL)
    assert [(sh.host, sh.row0, sh.n_slots) for sh in b.shards] == [
        (0, 0, 1), (0, 2, 1), (1, 4, 1), (1, 6, 1)]
    assert b.B1 == 8 and b.n_hosts == 2
    assert b._host_slots == [[0, 2], [4, 6]] and b._host_trash == [[1, 3], [5, 7]]
    assert b.slot_rows.tolist() == [0, 2, 4, 6]
    for sh in b.shards:
        for t in (sh.cache.k, sh.x, sh.done, sh.noise_tab, sh.mimi_state["ring"]["k"],
                  sh.cond_bank, *sh.params_dev):
            assert t.device == sh.device and t.shape[0 if t.dim() < 5 else 1] in (2, 8)
    uneven = ContinuousBatcher(ctx.engine, slots=5, max_len=64, admit_chunk=2, prefix_budget=32,
                               mesh=pmesh.make_mesh(["cpu"] * 2))
    assert [sh.n_slots for sh in uneven.shards] == [3, 2] and uneven.B1 == 7
    assert uneven._host_slots == [[0, 1, 2, 4, 5]] and uneven._trash_rows.tolist() == [3, 6]
    with pytest.raises(ValueError, match="host groups"):
        ContinuousBatcher(ctx.engine, slots=5, max_len=64, prefix_budget=32, mesh=hmesh4())


def test_a_mesh_wider_than_the_pool_is_refused(ctx):
    """Every shard holds at least one slot: an empty shard would still run a
    full frame step on every step and serve nothing."""
    with pytest.raises(ValueError, match="without a slot"):
        ContinuousBatcher(ctx.engine, mesh=pmesh.make_multihost_mesh(2, CPU8), **POOL)
    b = ContinuousBatcher(ctx.engine, mesh=pmesh.make_mesh(["cpu"] * 4), **POOL)
    assert [sh.n_slots for sh in b.shards] == [1, 1, 1, 1]


def test_mesh_of_another_device_type_is_refused(ctx):
    """No hidden fallback: a CPU engine is not served on a CUDA mesh (and a
    CUDA engine not on a CPU one)."""
    with pytest.raises(ValueError, match="device type"):
        ContinuousBatcher(ctx.engine, mesh=pmesh.make_mesh(["cuda:0", "cuda:1"]), **POOL)


def test_sharded_batcher_matches_jax_and_unsharded(ctx, model_dir):
    """The 5 requests through a 2x2 host mesh against the JAX batcher on its
    2x4 host mesh (frames equal, int16 within 8 LSB) and the port's
    unsharded batcher (within 1 LSB)."""
    from ptts_tpu.parallel import mesh as jmesh
    from ptts_tpu.runtime.batching import ContinuousBatcher as JaxBatcher

    jctx = japi.Context(model_dir, flowlm_cfg=FC, mimi_cfg=MC)
    jb = JaxBatcher(jctx.engine, mesh=jmesh.make_multihost_mesh(num_hosts=2,
                                                                devices=jax.devices()[:8]),
                    **POOL)
    jrids, want = run_specs(jb, SPECS)
    rids_u, res_u = run_specs(ContinuousBatcher(ctx.engine, **POOL), SPECS)
    bs = ContinuousBatcher(ctx.engine, mesh=hmesh4(), **POOL)
    rids, got = run_specs(bs, SPECS)
    assert rids == rids_u == jrids
    assert all(bs._host_slots[h] for h in range(bs.n_hosts))
    for rid, (text, p) in zip(rids, SPECS):
        assert got[rid].frames == want[rid].frames == res_u[rid].frames, text
        assert got[rid].frames == (3 if p.eos_enabled else p.num_frames), text
        assert max_lsb(got[rid].pcm_i16, want[rid].pcm_i16) <= 8, text
        assert max_lsb(got[rid].pcm_i16, res_u[rid].pcm_i16) <= 1, text


def test_sharded_device_bound_combined_flags(ctx):
    """collect_pcm=False over the mesh: each shard's [k+1, rows] flags join
    in row order; frame counts equal the unsharded run's, PCM empty."""
    p = Params(num_frames=5, num_steps=1, seed=21, temp=0.5, eos_enabled=True,
               eos_threshold=-1e9, eos_min_frames=2, eos_after=1)
    texts = ["hello world", "how low", "who who", "more text here"]
    out = {}
    for name, mesh in (("unsharded", None), ("sharded", hmesh4())):
        b = ContinuousBatcher(ctx.engine, slots=4, max_len=64, admit_chunk=2, prefix_budget=32,
                              frames_per_step=3, pipeline=True, collect_pcm=False, mesh=mesh)
        out[name] = run_specs(b, [(t, p) for t in texts])
    (rids_u, res_u), (rids_s, res_s) = out["unsharded"], out["sharded"]
    assert rids_u == rids_s
    for rid, text in zip(rids_u, texts):
        assert res_s[rid].frames == res_u[rid].frames == 3, text
        assert res_s[rid].pcm_i16.size == 0


def test_sharded_batcher_host_pinning(ctx):
    """submit(host=h) admits into host h's own rows."""
    b = ContinuousBatcher(ctx.engine, mesh=hmesh4(), **POOL)
    p = Params(num_frames=2, num_steps=1, seed=40, temp=0.5, eos_enabled=False)
    rid0 = b.submit("hello world", params=p, host=0)
    rid1 = b.submit("hello world", params=p, host=1)
    rid2 = b.submit("hello world", params=p, host=1)
    b.step()  # admission happens at the top of step()
    slot_of = {req.rid: s for s, req in enumerate(b.slot_req) if req is not None}
    assert slot_of[rid0] in b._host_slots[0]
    assert slot_of[rid1] in b._host_slots[1] and slot_of[rid2] in b._host_slots[1]
    res = b.drain()
    assert res[rid0].frames == res[rid1].frames == res[rid2].frames == 2
    with pytest.raises(ValueError, match="host groups"):
        b.submit("hello", params=p, host=2)


def test_default_routing_follows_backlog(ctx):
    """Without host=, a request goes to the group with the least backlog
    (queued minus free rows), ties to the lowest index."""
    b = ContinuousBatcher(ctx.engine, mesh=hmesh4(), **POOL)
    p = Params(num_frames=6, num_steps=1, seed=1, eos_enabled=False)
    reqs = [b.prepare("hello", params=p) for _ in range(6)]
    assert b._route_host() == 0                     # both -2: lowest index
    b.enqueue(reqs[0])
    assert b._route_host() == 1                     # -1 vs -2
    b.enqueue(reqs[1], host=0)
    b.enqueue(reqs[2], host=0)                      # h0: 3 queued, 2 free
    assert b._route_host() == 1
    b.enqueue(reqs[3])
    b.enqueue(reqs[4])
    assert [len(q) for q in b.queues] == [3, 2]
    assert b._route_host() == 1                     # 1 vs 0
    b.step()                                        # h0 admits 2, h1 admits 2
    assert [len(q) for q in b.queues] == [1, 0]
    assert b._route_host() == 1                     # 1 vs 0 (no free rows left)
    b.enqueue(reqs[5])
    assert [len(q) for q in b.queues] == [1, 1]
    assert len(b.drain()) == 6


def test_admit_group_fills_the_freest_shard(ctx, monkeypatch):
    """An admit group takes the free rows of ONE shard, the one with the
    most free rows, and pads to that shard's trash row (local indices)."""
    b = ContinuousBatcher(ctx.engine, slots=5, max_len=64, admit_chunk=4, prefix_budget=32,
                          mesh=pmesh.make_mesh(["cpu"] * 2))
    seen = []
    real = batching.admit_slots_ids

    def spy(w, cache, *a, **kw):
        seen.append((cache.k.shape[1], a[8].tolist()))
        return real(w, cache, *a, **kw)

    monkeypatch.setattr(batching, "admit_slots_ids", spy)
    p = Params(num_frames=2, num_steps=1, seed=3, eos_enabled=False)
    for t in ("one", "two", "three", "four", "five"):
        b.submit(t, params=p)
    assert b._admit() == 5
    # shard 0: 3 slots + trash (4 rows); shard 1: 2 slots + trash (3 rows)
    assert seen == [(4, [0, 1, 2, 3]), (3, [0, 1, 2, 2])]
    assert len(b.drain()) == 5


def test_spec_admit_on_a_1d_mesh(ctx):
    """spec_admit over a 2-position 1-D mesh: rows chosen on each shard's
    device, receipts resolved to global rows; results within 1 LSB of the
    unsharded host-picked run, nothing left in flight."""
    rids0, ref = run_specs(ContinuousBatcher(ctx.engine, **POOL), SPECS)
    b = ContinuousBatcher(ctx.engine, mesh=pmesh.make_mesh(["cpu"] * 2), spec_admit=True,
                          pipeline=True, **POOL)
    rids, got = run_specs(b, SPECS)
    assert rids == rids0 and set(got) == set(ref)
    assert b._spec_inflight == 0 and not b._receipts
    for rid in rids:
        assert got[rid].frames == ref[rid].frames
        assert max_lsb(got[rid].pcm_i16, ref[rid].pcm_i16) <= 1


def test_spec_admit_refused_with_two_host_groups(ctx):
    with pytest.raises(tapi.PttsError, match="single host group"):
        ContinuousBatcher(ctx.engine, mesh=hmesh4(), spec_admit=True, **POOL)


# -- the dry run ---------------------------------------------------------------------


def test_dryrun_multichip_on_cpu():
    dryrun.dryrun_multichip(8, "cpu")


def test_entry_runs_on_cpu():
    """entry()'s frame step and arguments, built here for a small FlowLM
    (entry itself is full size): one call advances the cache's device cursor
    in place (and its host mirror) and returns finite [8, ...] outputs."""
    cfg = dataclasses.replace(FC, vocab=17)
    fn, args = dryrun._frame_step_fn(cfg), dryrun._frame_step_args(cfg, "cpu")
    before = int(args[1].cursor)
    with torch.inference_mode():
        cache, x, latent, eos = fn(*args)
    assert cache.cursor is args[1].cursor and int(cache.cursor) == before + 1
    assert cache.cursor_host == args[1].cursor_host + 1 == before + 1
    assert x.shape == (8, cfg.d_model) and latent.shape == (8, cfg.latent_dim)
    assert eos.shape == (8,) and bool(torch.isfinite(x).all() and torch.isfinite(latent).all())


# -- profiling -------------------------------------------------------------------------


def test_device_trace_disabled_yields_none(monkeypatch):
    monkeypatch.delenv("PTTS_PROFILE", raising=False)
    with profiling.device_trace("off") as d:
        assert d is None
    monkeypatch.setenv("PTTS_PROFILE", "0")
    with profiling.device_trace("off") as d:
        assert d is None


def test_device_trace_writes_a_trace_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("PTTS_PROFILE_DIR", str(tmp_path))
    with profiling.device_trace("cpu", force=True) as d:
        a = torch.randn(32, 32)
        (a @ a).sum()
    assert os.path.dirname(d) == str(tmp_path / "cpu")
    names = os.listdir(d)
    assert len(names) == 1 and names[0].endswith(".json.gz")
    assert any(e.get("name") == "aten::mm" for e in profiling._events(d))
    assert profiling.summarize_trace(d) == {}   # no device events on the CPU


def test_device_traces_of_one_label_keep_apart(monkeypatch, tmp_path):
    """Two traces under one label land in directories of their own, each
    holding its one trace; the default base is in the temp directory, so it
    honours TMPDIR."""
    monkeypatch.setenv("PTTS_PROFILE_DIR", str(tmp_path))
    dirs = []
    for n in (8, 16):
        with profiling.device_trace("same", force=True) as d:
            torch.ones(n).sum()
        dirs.append(d)
    assert dirs[0] != dirs[1] and all(len(os.listdir(d)) == 1 for d in dirs)
    assert {os.path.dirname(d) for d in dirs} == {str(tmp_path / "same")}
    monkeypatch.delenv("PTTS_PROFILE_DIR")
    monkeypatch.setattr(profiling.tempfile, "tempdir", str(tmp_path / "tmp"))
    assert profiling.profile_dir("x") == str(tmp_path / "tmp" / "ptts_profile" / "x")


def test_trace_summaries_are_exact(tmp_path):
    """A hand-written Chrome trace: device events (kernel, gpu_memcpy,
    gpu_memset) aggregate by name; host events are dropped; busy time is
    the union of the device intervals."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 25.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "softmax", "ts": 60.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 90.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5.0, "dur": 3.0},
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "gpu"}},
    ]
    with gzip.open(tmp_path / "trace_1.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    agg = profiling.summarize_trace(str(tmp_path))
    assert agg == {"gemm": {"total_us": 50.0, "count": 2, "max_us": 30.0},
                   "softmax": {"total_us": 5.0, "count": 1, "max_us": 5.0},
                   "Memcpy DtoH": {"total_us": 10.0, "count": 1, "max_us": 10.0},
                   "Memset": {"total_us": 2.0, "count": 1, "max_us": 2.0}}
    assert [n for n, _ in profiling.top_ops(str(tmp_path), 2)] == ["gemm", "Memcpy DtoH"]
    text = profiling.format_summary(str(tmp_path), 2).splitlines()
    assert text[1].split() == ["gemm", "0.050", "2", "30.0"]
    assert text[-1].split()[-1] == "0.060"
    # [10, 55) + [60, 65) + [70, 80) + [90, 92) over the window [0, 100)
    assert profiling.busy_us(str(tmp_path)) == 62.0
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "missing"))


def test_mesh_dryrun_and_profiling_import_without_jax():
    """A fresh interpreter imports the three modules, builds a mesh and runs
    the dry run on the CPU without loading jax."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from ptts_torch.parallel import mesh
from ptts_torch import dryrun
from ptts_torch.utils import profiling
assert mesh.make_multihost_mesh(2, ["cpu"] * 4).size == 4
dryrun.dryrun_multichip(4, "cpu")
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
