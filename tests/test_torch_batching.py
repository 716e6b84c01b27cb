"""The port's continuous batcher (ptts_torch/runtime/batching.py) against the
JAX batcher and the port's offline engine (tiny configs, CPU, f32, explicit
seeds: host parity noise on both sides).

Gates: frame counts equal; int16 PCM within 8 LSB of the JAX batcher and
within 10 LSB of the port's quantized offline PCM (the JAX package's own
batcher gates, tests/test_batching.py); K-frame and split dispatches within
4 LSB of K = 1; packed-flag and spec_admit runs equal to their plain
counterparts; pipelined runs equal to serial ones, or within 1 LSB where
the pipeline admits a stream one ring column further on.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.runtime import batching  # noqa: E402
from ptts_torch.runtime.batching import ContinuousBatcher, QueueFull  # noqa: E402
from ptts_tpu import api as japi  # noqa: E402
from ptts_tpu.io import wav  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Params = japi.Params


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("tcbmodel"), seed=6)
    return path


@pytest.fixture(scope="module")
def ctx(model_dir):
    return tapi.Context(model_dir, flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI, device="cpu")


def max_lsb(a, b) -> int:
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    assert a.shape == b.shape
    return int(np.abs(a - b).max()) if a.size else 0


def offline_i16(ctx, text, p, rid):
    """The port's offline PCM for the batcher's rid (noise seed + rid), quantized."""
    return wav.quantize_i16(ctx.engine.generate(text, params=dataclasses.replace(
        p, seed=p.seed + rid)).samples)


def pool(ctx, **kw):
    args = dict(slots=2, max_len=96, admit_chunk=2, prefix_budget=32)
    args.update(kw)
    return ContinuousBatcher(ctx.engine, **args)


def p_(frames, seed, **kw):
    args = dict(num_frames=frames, num_steps=1, seed=seed, temp=0.4, eos_enabled=False)
    args.update(kw)
    return Params(**args)


FORCED_EOS = dict(eos_enabled=True, eos_threshold=-1e9, eos_min_frames=2, eos_after=1)
STAGGERED = [("hello world", p_(3, 100)), ("how low", p_(6, 101, **FORCED_EOS)),
             ("hello hello", p_(2, 102)), ("world world", p_(5, 103)),
             ("who who", p_(7, 104, **FORCED_EOS))]


def run_specs(b, specs):
    rids = [b.submit(t, params=p) for t, p in specs]
    return rids, b.drain()


def test_staggered_admission_matches_jax_and_offline(ctx, model_dir):
    """5 requests through 2 slots in admit groups of 2, ragged frames, EOS
    forced on two (3 frames each): frames equal to the JAX batcher's, PCM
    within 8 LSB of it and within 10 LSB of the port's offline engine."""
    from ptts_tpu.runtime.batching import ContinuousBatcher as JaxBatcher

    jctx = japi.Context(model_dir, flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI)
    jb = JaxBatcher(jctx.engine, slots=2, max_len=96, admit_chunk=2, prefix_budget=32)
    jrids, want = run_specs(jb, STAGGERED)
    rids, got = run_specs(pool(ctx), STAGGERED)
    assert rids == jrids and set(got) == set(rids)
    for rid, (text, p) in zip(rids, STAGGERED):
        assert got[rid].frames == want[rid].frames, text
        assert got[rid].frames == (3 if p.eos_enabled else p.num_frames), text
        assert got[rid].pcm_i16.dtype == np.int16
        assert got[rid].pcm_i16.shape == (got[rid].frames * TINY_MIMI.frame_samples,)
        assert max_lsb(got[rid].pcm_i16, want[rid].pcm_i16) <= 8, text
        assert max_lsb(got[rid].pcm_i16, offline_i16(ctx, text, p, rid)) <= 10, text


def test_single_request_matches_offline(ctx):
    p = p_(4, 5, temp=0.5)
    b = pool(ctx, slots=4)
    rid = b.submit("hello world", params=p)
    got = b.drain()[rid]
    assert got.frames == 4 and got.first_chunk_t > 0
    assert max_lsb(got.pcm_i16, offline_i16(ctx, "hello world", p, rid)) <= 8


def test_heterogeneous_params_match_offline(ctx):
    """Per-request num_steps, EOS settings and temperatures in one pool."""
    specs = [("hello world", p_(4, 11, temp=0.5)),
             ("how low", p_(5, 12, num_steps=3, temp=0.8)),
             ("hello hello", p_(6, 13, num_steps=2, temp=0.3, **FORCED_EOS)),
             ("world world", p_(4, 14, num_steps=4, temp=0.6))]
    b = pool(ctx, slots=3, max_num_steps=4)
    rids, got = run_specs(b, specs)
    for rid, (text, p) in zip(rids, specs):
        assert max_lsb(got[rid].pcm_i16, offline_i16(ctx, text, p, rid)) <= 10, text


def test_ids_admission_matches_prefix_admission(ctx):
    """The prompt built on the device (admit_slots_ids: voice bank + token
    embedding gather + projected BOS) against the host-assembled prefix."""
    specs = [(t, p_(3, 11, temp=0.5)) for t in ("hello world", "one two three", "hi")]

    def run(voice_cap):
        b = pool(ctx, slots=4, voice_cap=voice_cap)
        rids = [b.submit(t, params=p) for t, p in specs]
        reqs = {req.rid: req for req in b.queue}
        return rids, reqs, b.drain()

    rids_i, reqs_i, res_i = run(4)     # ids path
    rids_p, reqs_p, res_p = run(0)     # bank disabled -> prefix path
    assert all(reqs_i[r].ids is not None and reqs_i[r].prefix is None for r in rids_i)
    assert all(reqs_p[r].prefix is not None and reqs_p[r].ids is None for r in rids_p)
    for ri, rp in zip(rids_i, rids_p):
        assert res_i[ri].frames == res_p[rp].frames == 3
        assert max_lsb(res_i[ri].pcm_i16, res_p[rp].pcm_i16) <= 8


RAGGED = [("hello world", 7), ("how low", 2), ("hello hello", 5), ("world world", 4)]


def run_ragged(ctx, **kw):
    b = pool(ctx, **kw)
    rids, res = run_specs(b, [(t, p_(f, 70 + i)) for i, (t, f) in enumerate(RAGGED)])
    assert not b.first_chunk_t  # stamps move onto the Results
    return rids, res


@pytest.mark.parametrize("k", [2, 3, 4])
def test_multi_frame_dispatch_matches_single(ctx, k):
    """K frames per dispatch against K = 1: same frame counts and chunk
    routing across ragged ends and slot reuse, PCM within 4 LSB."""
    rids1, res1 = run_ragged(ctx)
    rids_k, res_k = run_ragged(ctx, frames_per_step=k)
    assert rids1 == rids_k
    for rid, (text, frames) in zip(rids1, RAGGED):
        assert res_k[rid].frames == frames == res1[rid].frames, text
        assert max_lsb(res_k[rid].pcm_i16, res1[rid].pcm_i16) <= 4, text


@pytest.mark.parametrize("pipeline", [False, True])
def test_split_admit_matches_unsplit(ctx, pipeline):
    """split_admit runs an admitting K-step as k=1 + k=K-1: invisible in the
    results, and every Result carries a first-chunk stamp."""
    rids0, res0 = run_ragged(ctx, frames_per_step=3, split_admit=False)
    rids1, res1 = run_ragged(ctx, frames_per_step=3, split_admit=True, pipeline=pipeline)
    assert rids0 == rids1
    for rid, (text, frames) in zip(rids0, RAGGED):
        assert res1[rid].frames == frames == res0[rid].frames, text
        assert max_lsb(res1[rid].pcm_i16, res0[rid].pcm_i16) <= 4, text
        assert res1[rid].first_chunk_t > 0, text


def test_split_admit_defaults(ctx):
    assert pool(ctx, frames_per_step=3).split_admit
    assert not pool(ctx, frames_per_step=1).split_admit
    assert not pool(ctx, frames_per_step=3, collect_pcm=False).split_admit


HETERO = [("hello world", p_(4, 21, temp=0.5)),
          ("how low", p_(6, 22, num_steps=2, temp=0.7, **FORCED_EOS)),
          ("hello hello", p_(3, 23)),
          ("world world", p_(5, 24, num_steps=2, temp=0.9))]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("slots", [4, 2])
def test_pipelined_equals_serial(ctx, k, slots):
    """The double-buffered loop against the serial loop, through ragged EOS.
    With every request admitted at once (4 slots) the results are equal.
    With staggered admissions (2 slots) the pipelined loop admits with one
    more frame in flight, so a late stream's decode columns sit one ring
    column further on: frame counts stay equal, and the PCM may move by the
    float summation order of the decode attention over those columns
    (at most 1 LSB)."""
    out = {}
    for pipeline in (False, True):
        out[pipeline] = run_specs(pool(ctx, slots=slots, max_num_steps=2, pipeline=pipeline,
                                       frames_per_step=k), HETERO)
    (rids_s, res_s), (rids_p, res_p) = out[False], out[True]
    assert rids_s == rids_p
    for rid in rids_s:
        assert res_s[rid].frames == res_p[rid].frames
        if slots == 4:
            np.testing.assert_array_equal(res_s[rid].pcm_i16, res_p[rid].pcm_i16)
        else:
            assert max_lsb(res_s[rid].pcm_i16, res_p[rid].pcm_i16) <= 1


@pytest.mark.parametrize("k", [1, 3])
def test_device_bound_mode_counts_frames(ctx, k):
    """collect_pcm=False reads back only the combined [k+1, B] flags: the
    same frame counts, empty PCM."""
    frames = {}
    for collect in (True, False):
        b = pool(ctx, collect_pcm=collect, frames_per_step=k, pipeline=True)
        rids, res = run_specs(b, HETERO)
        frames[collect] = [res[r].frames for r in rids]
        for r in rids:
            assert (res[r].pcm_i16.size > 0) == collect
            assert res[r].first_chunk_t > 0
    assert frames[True] == frames[False] == [4, 3, 3, 5]


def test_eos_frees_slots(ctx):
    """Forced EOS retires a stream after eos_after frames and its slot is
    reused, also mid-way through a 4-frame dispatch."""
    for k in (1, 4):
        b = pool(ctx, slots=1, admit_chunk=1, frames_per_step=k)
        p = p_(6, 2, temp=0.3, **FORCED_EOS)
        r0, r1 = b.submit("hello", params=p), b.submit("world", params=p)
        res = b.drain()
        assert res[r0].frames == res[r1].frames == 3


def test_decode_ring_wraps_more_than_once(ctx):
    """A server-like run that laps the 16-column decode ring more than
    twice (6 sequential 14-frame requests through 2 slots, the cursor moves
    42 columns): every stream still matches its offline run."""
    b = pool(ctx, max_len=48)
    R = b.max_len - b.prefix_budget
    p = p_(14, 41)
    texts = ["hello world", "how low", "world world", "hello hello", "who who", "hi there"]
    rids, res = run_specs(b, [(t, p) for t in texts])
    assert b.shards[0].cache.cursor - b.prefix_budget > 2 * R
    for rid, text in zip(rids, texts):
        assert res[rid].frames == 14
        assert max_lsb(res[rid].pcm_i16, offline_i16(ctx, text, p, rid)) <= 10, text


def test_ring_survives_early_finishers(ctx):
    """A stream that finished early keeps start fixed while the cursor runs
    on; later admissions into its slot wrap onto retired columns and still
    decode right."""
    b = pool(ctx, max_len=48)
    specs = [(t, p_(f, 70 + i)) for i, (t, f) in
             enumerate([("hello world", 14), ("how low", 2), ("hello hello", 8),
                        ("world world", 8)])]
    rids, res = run_specs(b, specs)
    for rid, (text, p) in zip(rids, specs):
        assert res[rid].frames == p.num_frames, text
        assert max_lsb(res[rid].pcm_i16, offline_i16(ctx, text, p, rid)) <= 10, text


def test_admission_writes_in_place(ctx):
    """Admission writes the admitted rows of the existing pool tensors and
    leaves a running stream's rows alone."""
    b = pool(ctx)
    sh = b.shards[0]  # no mesh: one shard, local rows = global rows
    r0 = b.submit("hello world", params=p_(6, 1))
    b.step()
    row0 = next(s for s in b.slot_rows if b.slot_req[s] is not None)
    ptrs = [t.data_ptr() for t in (sh.cache.k, sh.cache.v, sh.time_embs, sh.noise_tab,
                                   sh.mimi_state["ring"]["kpos"])]
    k_before = sh.cache.k[:, row0].clone()
    kpos_before = sh.mimi_state["ring"]["kpos"][row0].clone()
    b.submit("how low", params=p_(2, 2))
    assert b._admit() == 1
    assert ptrs == [t.data_ptr() for t in (sh.cache.k, sh.cache.v, sh.time_embs, sh.noise_tab,
                                           sh.mimi_state["ring"]["kpos"])]
    assert torch.equal(sh.cache.k[:, row0], k_before)
    assert torch.equal(sh.mimi_state["ring"]["kpos"][row0], kpos_before)
    row1 = next(s for s in b.slot_rows if s != row0)
    assert int(sh.cache.start[row1]) == sh.cache.cursor
    assert bool((sh.mimi_state["ring"]["kpos"][row1] == -1).all())
    assert not bool(sh.done[row1]) and int(sh.frame_idx[row1]) == 0
    assert r0 in b.drain()


def test_admission_launches_b1_at_the_admit_shape(ctx, monkeypatch):
    """Every admit group prefills through B1's path (causal_attention_qkv
    on the card; its plain version, which the CPU engine's prefill_impl
    resolves to, here) with [admit_chunk, prefix_budget, 3 d] and contiguous
    [admit_chunk] int32 lengths. A padded entry has length 1 on the
    host-prefix path and, on the ids path, an empty prompt after bank row
    0's voice (its cond frames + 1)."""
    calls = []
    name = {"kernel": "causal_attention_qkv",
            "plain": "causal_attention_qkv_plain"}[ctx.engine.prefill_impl]
    real = getattr(tfl, name)

    def spy(qkv, lengths, **kw):
        calls.append((tuple(qkv.shape), lengths.dtype, lengths.is_contiguous(),
                      lengths.tolist()))
        return real(qkv, lengths, **kw)

    monkeypatch.setattr(tfl, name, spy)
    d = TINY_FLOWLM.d_model
    n_cond = len(ctx.engine._voice_cond(None)[0])
    for voice_cap, pad in ((8, n_cond + 1), (0, 1)):  # ids path, host prefix path
        calls.clear()
        b = pool(ctx, slots=4, admit_chunk=3, voice_cap=voice_cap)
        b.submit("hello world", params=p_(2, 1))
        b.drain()
        assert len(calls) == TINY_FLOWLM.num_layers
        for shape, dtype, contiguous, lengths in calls:
            assert shape == (3, 32, 3 * d)
            assert dtype == torch.int32 and contiguous
            assert lengths[1:] == [pad, pad] and lengths[0] > pad


def test_batcher_steps_from_another_thread(ctx):
    """The pool holds inference tensors; a thread other than the
    constructor's drives admission and steps (inference mode per call)."""
    b = pool(ctx)
    rids = [b.submit(t, params=p_(3, 9)) for t in ("hello", "world", "again")]
    out, errs = {}, []

    def drive():
        try:
            out.update(b.drain())
        except Exception as e:  # surfaced below
            errs.append(e)

    t = threading.Thread(target=drive)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errs
    assert sorted(out) == rids and all(out[r].frames == 3 for r in rids)


def test_bf16_pool_stays_near_f32(ctx, monkeypatch):
    """PTTS_DTYPE=bf16: the pool (KV cache, Mimi state, noise tables, voice
    bank) in bf16, the Euler tables in f32; the PCM stays within the bf16
    engine's bound (0.08 of max) of the f32 pool's."""
    from ptts_torch.runtime.engine import TTSEngine

    monkeypatch.setenv("PTTS_DTYPE", "bf16")
    b16 = ContinuousBatcher(TTSEngine(ctx), slots=2, max_len=96, admit_chunk=2,
                            prefix_budget=32)
    sh = b16.shards[0]
    assert sh.cache.k.dtype == sh.noise_tab.dtype == sh.cond_bank.dtype == torch.bfloat16
    assert sh.mimi_state["ring"]["k"].dtype == torch.bfloat16
    assert sh.time_embs.dtype == torch.float32
    rids16, got = run_specs(b16, STAGGERED)
    rids32, want = run_specs(pool(ctx), STAGGERED)
    assert rids16 == rids32
    for rid in rids16:
        assert got[rid].frames == want[rid].frames
        g, w = got[rid].audio, want[rid].audio
        assert np.abs(g - w).max() <= 0.08 * np.abs(w).max()


def test_num_steps_above_pool_cap_rejected(ctx):
    b = pool(ctx, max_num_steps=2)
    with pytest.raises(tapi.PttsError, match="max_num_steps"):
        b.submit("hello", params=Params(num_frames=2, num_steps=3))


def test_noise_budget_beyond_ring_rejected(ctx):
    with pytest.raises(tapi.PttsError, match="decode ring"):
        pool(ctx, max_len=48, noise_budget=17)


def test_direct_enqueue_revalidates_ring_safety(ctx):
    """enqueue() enforces the ring-safety invariant on raw Requests too."""
    b = pool(ctx, max_num_steps=2)
    ok = b.prepare("hello", params=Params(num_frames=2, num_steps=1, seed=7))
    with pytest.raises(tapi.PttsError, match="noise_budget"):
        b.enqueue(dataclasses.replace(ok, max_frames=b.noise_budget + 1, noise=None))
    assert ok.noise is not None
    with pytest.raises(tapi.PttsError, match="noise rows"):
        b.enqueue(dataclasses.replace(ok, noise=ok.noise[:1], max_frames=2))
    with pytest.raises(tapi.PttsError, match="max_num_steps"):
        b.enqueue(dataclasses.replace(ok, num_steps=b.max_num_steps + 1))
    rid = b.enqueue(ok)
    assert b.drain()[rid].frames == 2


def test_max_queue_backpressure(ctx):
    b = pool(ctx, slots=1, admit_chunk=1, max_queue=2)
    p = p_(2, 1)
    b.submit("one", params=p)
    b.submit("two", params=p)
    with pytest.raises(QueueFull):
        b.submit("three", params=p)
    assert len(b.queue) == 2 and len(b.chunks) == 2
    assert issubclass(QueueFull, tapi.PttsError)


def test_cancel_queued_request(ctx):
    b = pool(ctx, slots=1, admit_chunk=1)
    p = p_(2, 1)
    r0, r1 = b.submit("hello", params=p), b.submit("world", params=p)
    assert b.cancel(r1)
    assert not b.cancel(r1)
    assert not b.cancel(10_000)
    assert set(b.drain()) == {r0}
    assert r1 not in b.chunks and not b.queue


def test_cancel_in_slot_frees_it_for_next_admission(ctx):
    p = p_(6, 2, temp=0.3)
    b = pool(ctx, slots=1, admit_chunk=1)
    r0, r1 = b.submit("hello", params=p), b.submit("world", params=p)
    b.step()
    slot = b.slot_rows[0]
    assert b.slot_req[slot].rid == r0
    assert b.cancel(r0)
    assert b.slot_req[slot] is None and bool(b._done_np[slot])
    res = b.drain()
    assert set(res) == {r1} and res[r1].frames == 6
    assert max_lsb(res[r1].pcm_i16, offline_i16(ctx, "world", p, r1)) <= 10


def test_cancel_finished_unclaimed(ctx):
    b = pool(ctx, slots=1, admit_chunk=1)
    rid = b.submit("hello", params=p_(2, 1))
    for _ in range(64):
        b.step()
        if rid in b.finished:
            break
    assert rid in b.finished
    assert b.cancel(rid)
    assert rid not in b.finished and rid not in b.chunks


@pytest.mark.parametrize("pipeline", [False, True])
def test_spec_admit_matches_host_admit(ctx, pipeline):
    """Rows chosen on the device, resolved from receipts, against rows the
    host picked: equal PCM per rid (rows may differ; noise is per request)."""
    rids0, ref = run_specs(pool(ctx), STAGGERED)
    b = pool(ctx, spec_admit=True, pipeline=pipeline)
    rids, got = run_specs(b, STAGGERED)
    assert rids == rids0 and set(got) == set(ref)
    assert b._spec_inflight == 0 and not b._receipts
    for rid in rids:
        assert got[rid].frames == ref[rid].frames
        np.testing.assert_array_equal(got[rid].pcm_i16, ref[rid].pcm_i16)


def test_spec_admit_overshoot_requeues(ctx):
    """Requests that found no free row land in the trash row and are
    re-queued when their receipt resolves; all finish correctly."""
    p = p_(2, 7, temp=0.3)
    texts = ["one two", "three four", "five six"]
    b = pool(ctx, slots=1, spec_admit=True)
    b._finish_ema = 8.0  # force a large speculative overshoot
    rids, got = run_specs(b, [(t, p) for t in texts])
    assert set(got) == set(rids)
    assert b._spec_inflight == 0 and not b._receipts
    for rid, text in zip(rids, texts):
        assert max_lsb(got[rid].pcm_i16, offline_i16(ctx, text, p, rid)) <= 10, text


def test_spec_admit_cancel_in_receipt(ctx):
    b = pool(ctx, spec_admit=True)
    p = p_(2, 7)
    r0, r1 = b.submit("hello", params=p), b.submit("world", params=p)
    assert b._admit() == 2 and b._receipts
    assert b.cancel(r1)
    assert not b.cancel(r1)
    assert set(b.drain()) == {r0}
    assert not b._spec_cancelled and b._spec_inflight == 0


def test_select_free_rows():
    done = torch.tensor([True, False, True, True, True])
    mask = torch.tensor([True, True, True, False, False])  # row 4 is trash
    rows = batching._select_free_rows(done, mask, n_valid=3, n=3, trash_row=4)
    assert rows.dtype == torch.int32 and rows.tolist() == [0, 2, 4]
    rows = batching._select_free_rows(done, mask, n_valid=1, n=3, trash_row=4)
    assert rows.tolist() == [0, 4, 4]
    # a group wider than the pool: the extra entries go to the trash row
    rows = batching._select_free_rows(done, mask, n_valid=7, n=7, trash_row=4)
    assert rows.tolist() == [0, 2, 4, 4, 4, 4, 4]


@pytest.mark.parametrize("spec", [False, True])
def test_failed_admission_keeps_its_requests(ctx, monkeypatch, spec):
    """An admission that raises leaves its requests where the server's error
    path finds them: installed in their slots (host-picked rows) or back at
    the front of the queue (device-picked rows), never lost."""
    b = pool(ctx, spec_admit=spec)
    rids = [b.submit(t, params=p_(2, 1)) for t in ("one", "two", "three")]

    def boom(*a, **kw):
        raise RuntimeError("injected admission failure")

    monkeypatch.setattr(batching, "admit_slots_ids", boom)
    with pytest.raises(RuntimeError, match="injected"):
        b._admit()
    queued = [r.rid for r in b.queue]
    in_slots = [r.rid for r in b.slot_req if r is not None]
    assert sorted(queued + in_slots) == rids
    assert queued == (rids if spec else rids[2:])
    assert b._spec_inflight == 0 and not b._receipts


def test_device_noise_rows_semantics():
    """std = sqrt(temp) scaling, clamping, rows at/after the request's frame
    count zero, temp <= 0 zero, same seed -> same rows whatever the group."""
    std = float(np.sqrt(0.7))
    meta = torch.tensor([[std, 1.0, std, 0.0], [0.0, 0.1, 0.0, 0.0]])
    frames = torch.tensor([50.0, 10.0, 50.0, 64.0])
    rows = batching._device_noise_rows([1, 2, 1, 3], meta, frames, 64, 32, torch.float32)
    assert rows.shape == (4, 64, 32) and rows.dtype == torch.float32
    assert bool((rows[0, 50:] == 0).all()) and bool((rows[1, 10:] == 0).all())
    assert bool((rows[0, :50] != 0).all())
    assert abs(float(rows[0, :50].std()) - std) < 0.1
    assert float(rows[1, :10].abs().max()) <= 0.1 + 1e-6
    assert bool((rows[3] == 0).all())                         # temp <= 0
    assert torch.equal(rows[0], rows[2])
    assert not torch.equal(rows[0, :10], rows[1, :10])
    # a request's rows do not depend on its position or group
    alone = batching._device_noise_rows([1], meta[:, :1], frames[:1], 64, 32, torch.float32)
    assert torch.equal(alone[0], rows[0])
    half = batching._device_noise_rows([1], meta[:, :1], frames[:1], 64, 32, torch.bfloat16)
    assert half.dtype == torch.bfloat16


def test_device_noise_routing(ctx):
    b = pool(ctx, admit_chunk=1)
    assert b.prepare("hello", params=Params(num_frames=3, seed=7)).noise is not None
    req = b.prepare("hello", params=Params(num_frames=3, seed=-1, temp=0.5, noise_clamp=1.0))
    assert req.noise is None and req.temp == 0.5 and req.noise_clamp == 1.0
    b2 = pool(ctx, admit_chunk=1, device_noise=False)
    assert b2.prepare("hello", params=Params(num_frames=3, seed=-1)).noise is not None


def test_device_noise_roundtrip_matches_host_path(ctx):
    """A device-noise request equals a host-noise request fed the same noise
    values (read back off the device): only the table's origin differs."""
    b = pool(ctx, admit_chunk=1)
    req = b.prepare("hello world", params=p_(4, -1, temp=0.5))
    assert req.noise is None
    rid = b.enqueue(req)
    b.step()
    slot = next(s for s in b.slot_rows if b.slot_req[s] is not None and b.slot_req[s].rid == rid)
    noise = b.shards[0].noise_tab[slot, :4].float().numpy().copy()
    assert np.abs(noise).max() > 0
    res = b.drain()[rid]
    assert res.frames == 4
    b2 = pool(ctx, admit_chunk=1)
    req2 = b2.prepare("hello world", params=p_(4, 3, temp=0.5))
    req2.noise = noise
    rid2 = b2.enqueue(req2)
    np.testing.assert_array_equal(res.pcm_i16, b2.drain()[rid2].pcm_i16)


def test_pinned_pool_reuses_only_completed_buffers():
    class Ev:
        def __init__(self, ok):
            self.ok = ok

        def query(self):
            return self.ok

    pool_ = batching._PinnedPool(pin=False)
    a = pool_.get((4,), torch.float32)
    pending = Ev(False)
    pool_.put(a, pending)
    b = pool_.get((4,), torch.float32)
    assert b is not a                       # its copy has not completed
    pending.ok = True
    assert pool_.get((4,), torch.float32) is a
    pool_.put(b)
    assert pool_.get((4,), torch.float32) is b
    assert pool_.get((2, 2), torch.int16).shape == (2, 2)


def test_serving_port_runs_without_jax(tmp_path):
    """A fresh interpreter imports the batcher and the server, drains two
    requests on the CPU and serves one over HTTP without loading jax."""
    code = f"""
import http.client, json, sys, threading
sys.path.insert(0, {REPO!r})
from ptts_tpu.config import FlowLMConfig, MimiConfig
from ptts_torch import api, synth
from ptts_torch.runtime import batching, server
fc = FlowLMConfig(vocab=60, text_dim=16, d_model=16, num_heads=2, head_dim=8, num_layers=2,
                  hidden=32, latent_dim=8, flow_dim=16, flow_depth=2, time_freqs=4)
mc = MimiConfig(latent_dim=8, d_model=8, num_heads=2, head_dim=4, num_layers=1, hidden=16,
                context=5, upsample_kernel=4, upsample_stride=2, n_filters=4, ratios=(3, 2),
                kernel_size=5)
path = synth.write_model_dir({str(tmp_path)!r}, fc, mc, seed=1, scale=0.3)
ctx = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cpu")
b = batching.ContinuousBatcher(ctx.engine, slots=2, max_len=64, admit_chunk=2, prefix_budget=32)
p = api.Params(seed=1, num_frames=3, eos_enabled=False)
rids = [b.submit(t, params=p) for t in ("Hello world!", "Again.")]
res = b.drain()
assert [res[r].frames for r in rids] == [3, 3], res
httpd = server.serve(ctx, port=0, slots=2, max_len=64, prefix_budget=32)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
conn = http.client.HTTPConnection(*httpd.server_address, timeout=120)
conn.request("POST", "/tts", json.dumps({{"text": "Hi.", "num_frames": 2, "seed": 2}}))
body = conn.getresponse().read()
assert body[:4] == b"RIFF" and len(body) == 44 + 2 * 2 * mc.frame_samples, len(body)
httpd.shutdown(); httpd.tts_service.close()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
