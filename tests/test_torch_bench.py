"""ptts_torch.bench and ptts_torch.tools (the port's measuring entry points)
on the CPU at tiny size, held against the repository's bench.py and the JAX
package on the same numpy inputs.

  * the input builders and the closed-loop request draws equal bench.py's
    expressions bit for bit;
  * the offline pipeline in each of the four modes against the same JAX
    calls (frames_used equal, PCM within 1e-3 of max);
  * streams per chip follow frames_used; the batcher, prepared and HTTP
    legs count what they finished;
  * main() refuses to run without a card, and a leg that raises is
    recorded and makes the run exit non-zero.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import TINY_FLOWLM as FC, TINY_MIMI as MC  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch import bench  # noqa: E402
from ptts_torch.models import flowlm as tfl, mimi as tmi  # noqa: E402
from ptts_torch.runtime.batching import ContinuousBatcher  # noqa: E402
from ptts_torch.tools import bench_http, bench_streaming, profile_stages  # noqa: E402
from ptts_tpu.config import FlowLMConfig as JFlowLMConfig  # noqa: E402
from ptts_tpu.models import flowlm as jfl, mimi as jmi  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(device="cpu", flowlm_cfg=FC, mimi_cfg=MC)
TOL = 1e-3
BATCH_KEYS = ("admit", "admit_wait", "dispatch", "collect")


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_model"))


@pytest.fixture(autouse=True)
def bench_env(tiny_dir, tmp_path, monkeypatch):
    """Every leg reads (and the first writes) one tiny synthetic checkpoint;
    profiles go to the test's own directory."""
    monkeypatch.setenv("PTTS_BENCH_MODEL_DIR", tiny_dir)
    monkeypatch.setenv("PTTS_PROFILE_DIR", str(tmp_path / "profile"))
    monkeypatch.setenv("PTTS_DTYPE", "f32")


def jax_bench_inputs(batch, frames, cfg, dtype):
    """bench.py:95-107 and 164-168, verbatim (jnp/np as there)."""
    T0 = 64
    frame_bucket = ((frames + 63) // 64) * 64
    rng = np.random.default_rng(0)
    prefix = jnp.asarray(rng.standard_normal((batch, T0, cfg.d_model)) * 0.02, dtype)
    lengths = jnp.full((batch,), T0, jnp.int32)
    noise = jnp.asarray(rng.standard_normal((batch, frame_bucket, cfg.latent_dim)) * 0.8, dtype)
    ragged_after = jnp.asarray(
        9 + (np.arange(batch) * (frames - 10) // max(batch - 1, 1)), jnp.int32)
    after_np = np.asarray(ragged_after)
    g_idx = np.array_split(np.argsort(after_np, kind="stable"), 4)
    g_width = [min(frames, (int(after_np[g].max()) + 1 + 15) // 16 * 16) for g in g_idx]
    return dict(prefix=prefix, lengths=lengths, noise=noise, ragged_after=ragged_after,
                g_idx=g_idx, g_width=g_width)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- (a) inputs and request draws -------------------------------------------------


@pytest.mark.parametrize("batch,frames,dtype", [(4, 12, "f32"), (16, 50, "bf16"),
                                                (256, 50, "f32"), (256, 50, "bf16")])
def test_inputs_match_bench_py(batch, frames, dtype):
    cfg = JFlowLMConfig()   # bench.py draws at the full width
    want = jax_bench_inputs(batch, frames, cfg, {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype])
    got = bench.bench_inputs(batch, frames, cfg, bench.DTYPES[dtype], "cpu")
    for name in ("prefix", "noise"):
        assert got[name].dtype == bench.DTYPES[dtype]
        assert np.array_equal(as_f32(got[name]), as_f32(want[name])), name
    for name in ("lengths", "ragged_after"):
        assert got[name].dtype == torch.int32
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name
    groups = bench.length_groups(got["ragged_after"].numpy(), frames)
    assert [w for _, w in groups] == want["g_width"]
    for (g, _), w in zip(groups, want["g_idx"]):
        assert np.array_equal(g, w)


def test_request_draws_match_bench_py():
    """The voice and the first 50 closed-loop requests (bench.py:323,
    330-340: frames, ids, noise_seed), drawn from one generator in order."""
    cfg = JFlowLMConfig()
    rng = np.random.default_rng(0)
    cond = (rng.standard_normal((40, cfg.d_model)) * 0.02).astype(np.float32)
    want = []
    for _ in range(50):
        frames = int(rng.integers(10, 51))
        ids = rng.integers(1, cfg.vocab, size=int(rng.integers(4, 21)))
        want.append((frames, ids.astype(np.int32), int(rng.integers(0, 2**31))))
    r = np.random.default_rng(0)
    assert np.array_equal(bench.voice_cond(r, cfg.d_model), cond)
    got = [bench.draw_request(r, cfg.vocab) for _ in range(50)]
    for (gf, gi, gs), (wf, wi, ws) in zip(got, want):
        assert gf == wf and gs == ws and gi.dtype == np.int32
        assert np.array_equal(gi, wi)


# -- (b) the offline pipeline against the JAX package ---------------------------


@pytest.fixture(scope="module")
def tiny_weights():
    fhost = jfl.random_weights(FC, seed=0, scale=0.3)
    mhost = jmi.random_weights(MC, seed=1, scale=0.3)
    port = (tfl.to_device(fhost, torch.float32, FC, "cpu"),
            tmi.to_device(mhost, torch.float32, MC, "cpu"))
    return port, (jfl.to_device(fhost, jnp.float32, FC), jmi.to_device(mhost, cfg=MC))


def jax_pipeline(fw, mw, batch, frames, mode):
    """bench.py's pipeline (116-139) and length-bucketed pipeline (175-190)
    with the JAX package's functions; returns ([PCM per group], used)."""
    inp = jax_bench_inputs(batch, frames, FC, jnp.float32)
    frame_bucket = ((frames + 63) // 64) * 64
    max_len = 64 + frame_bucket
    pimpl = jfl.resolve_prefill_impl()

    def decode(lat, width):
        return np.asarray(jmi.decode(mw, jfl.scale_latents(fw, lat[:, :width]), MC))

    if mode == "ragged_bucketed":
        pcms, used = [], np.zeros(batch, np.int64)
        for g, width in zip(inp["g_idx"], inp["g_width"]):
            take = jnp.asarray(g)
            cache, x0 = jfl.prefill_init(fw, inp["prefix"][take], inp["lengths"][take], FC,
                                         max_len, pimpl)
            res = jfl.generate_latents_while(
                fw, cache, x0, inp["noise"][take], FC, max_frames=frame_bucket, num_steps=1,
                eos_threshold=1e9, eos_min_frames=1, eos_after=inp["ragged_after"][take],
                max_frames_per_stream=jnp.full((take.size,), frames, jnp.int32))
            pcms.append(decode(res.latents, width))
            used[g] = np.asarray(res.frames_used)
        return pcms, used
    cache, x0 = jfl.prefill_init(fw, inp["prefix"], inp["lengths"], FC, max_len, pimpl)
    if mode == "off":
        res = jfl.generate_latents(fw, cache, x0, inp["noise"], FC, max_frames=frame_bucket,
                                   num_steps=1, eos_enabled=False)
    else:
        res = jfl.generate_latents_while(
            fw, cache, x0, inp["noise"], FC, max_frames=frame_bucket, num_steps=1,
            eos_threshold=1e9 if mode == "on" else -1e9, eos_min_frames=1,
            eos_after=inp["ragged_after"] if mode == "ragged" else 0,
            max_frames_per_stream=jnp.full((batch,), frames, jnp.int32))
    return [decode(res.latents, frames)], np.asarray(res.frames_used)


@pytest.mark.parametrize("mode", bench.OfflineBench.MODES)
def test_offline_modes_match_jax(tiny_weights, mode):
    (tfw, tmw), (jfw, jmw) = tiny_weights
    batch, frames = 8, 12
    off = bench.OfflineBench(tfw, tmw, batch, frames, torch.float32, FC, MC)
    got, used = off.run(mode)
    want, want_used = jax_pipeline(jfw, jmw, batch, frames, mode)
    assert np.array_equal(used.numpy(), want_used)
    assert len(got) == len(want) == (4 if mode == "ragged_bucketed" else 1)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()
    if mode == "ragged":   # EOS at frame 0, then ragged_after[b] more frames
        assert np.array_equal(used.numpy(), off.ragged_after.numpy() + 1)


# -- (c) streams from frames_used ------------------------------------------------


def test_audio_seconds_caps_each_stream_at_frames():
    assert bench.audio_seconds(np.array([3, 12, 64]), 12, 12.5) == (3 + 12 + 12) / 12.5


def test_run_bench_streams_follow_frames_used():
    """Each mode's streams = emitted audio seconds (frames_used capped at
    frames) / wall (bench.py:222-224): "on" emits every frame, "ragged"
    ragged_after + 1 per stream."""
    batch, frames = 8, 12
    r = bench.run_bench(batch, frames, "f32", 1, verbose=False, **KW)
    d = r["detail"]
    assert r["metric"] == "concurrent_realtime_streams" and r["unit"] == "streams/chip"
    assert d["platform"] == "cpu" and (d["batch"], d["frames"], d["dtype"]) == (8, 12, "f32")
    assert r["value"] * d["wall_s"] == pytest.approx(batch * frames / MC.frame_rate)
    after = bench.bench_inputs(batch, frames, FC, torch.float32, "cpu")["ragged_after"].numpy()
    ragged_s = np.minimum(after + 1, frames).sum() / MC.frame_rate
    assert d["ragged_eos_streams"] * d["ragged_wall_s"] == pytest.approx(ragged_s)
    assert d["eos_on_vs_off"] == pytest.approx(r["value"] / d["eos_off_streams"])
    for key in ("compile_s", "weights_s", "cuda_init_s", "ragged_bucketed_streams"):
        assert d[key] > 0, key
    assert "vs_baseline" not in r


# -- (d) the batcher legs --------------------------------------------------------


def test_batcher_bench_counts_what_finished(monkeypatch):
    """The closed loop finishes at least its target; frames_done is the sum
    of the frames of the requests that finished after the 12 warm-up steps,
    each as many as it asked for (EOS off), and every PCM is whole."""
    asked, timed = {}, {}
    steps = [0]
    enqueue, step = ContinuousBatcher.enqueue, ContinuousBatcher.step

    def spy_enqueue(self, req, host=None):
        asked[req.rid] = req.max_frames
        return enqueue(self, req, host)

    def spy_step(self):
        n = step(self)
        steps[0] += 1
        for rid, res in self.finished.items():
            assert res.frames == asked[rid]
            assert len(res.pcm_i16) == res.frames * MC.frame_samples
            if steps[0] > 12:
                timed[rid] = res.frames
        return n

    monkeypatch.setattr(ContinuousBatcher, "enqueue", spy_enqueue)
    monkeypatch.setattr(ContinuousBatcher, "step", spy_step)
    stats = {}
    # a queue of slots + admit_chunk = 6: the requests queued after the
    # warm-up reach a slot once the 6 before them have been admitted
    streams, p50, finished, wall = bench.run_batcher_bench(
        4, "f32", 16, frames_per_step=8, admit_chunk=2, verbose=False, stats_out=stats, **KW)
    assert finished >= 16 and finished == len(timed)
    assert stats["frames_done"] == sum(timed.values())
    assert streams == pytest.approx(stats["frames_done"] / MC.frame_rate / wall)
    assert set(BATCH_KEYS) <= set(stats["phase_s"])
    assert stats["n_steps"] == steps[0] - 12 and stats["frames_per_step"] == 8
    assert p50 > 0


def test_batcher_bench_takes_its_warmup_steps(monkeypatch):
    steps = [0]
    step = ContinuousBatcher.step

    def spy_step(self):
        steps[0] += 1
        return step(self)

    monkeypatch.setattr(ContinuousBatcher, "step", spy_step)
    stats = {}
    bench.run_batcher_bench(4, "f32", 8, frames_per_step=8, admit_chunk=2, verbose=False,
                            stats_out=stats, warmup_steps=3, **KW)
    assert stats["n_steps"] == steps[0] - 3 and stats["frames_done"] > 0


def test_batcher_bench_device_bound_spec_admit():
    """The device-bound, pipelined, speculative-admission leg with
    admit_chunk > slots + 1 (32 against 4 slots)."""
    streams, p50, finished, wall = bench.run_batcher_bench(
        4, "f32", 8, frames_per_step=8, collect_pcm=False, pipeline=True, spec_admit=True,
        verbose=False, **KW)
    assert finished >= 8 and streams > 0 and wall > 0


def test_prepared_batcher_bench_feeds_from_threads():
    streams, finished, wall = bench.run_batcher_bench_prepared(4, 8, verbose=False, **KW)
    assert finished >= 8 and streams > 0 and wall > 0


# -- (e) HTTP --------------------------------------------------------------------

HTTP_KEYS = ("http_cfg", "http_first_byte_p50_ms", "http_first_byte_p95_ms",
             "http_stream_reqs_per_s", "http_reqs_per_s", "http_stream_p95_ms",
             "http_stream_streams", "http_stream_errors", "http_wav_reqs_per_s",
             "http_wav_p95_ms", "http_wav_streams", "http_wav_errors")


def test_http_bench_answers_every_request(tiny_dir):
    ctx = tapi.Context(bench.bench_model_dir(FC, MC), FC, MC, device="cpu")
    out = bench_http.run_http_bench(ctx, slots=4, clients=3, reqs=6, frames_per_step=8,
                                    pipeline=True, spec_admit=True, verbose=False)
    ctx.close()
    assert set(out) == set(HTTP_KEYS)
    assert out["http_stream_errors"] == out["http_wav_errors"] == 0   # only 200s
    for key in HTTP_KEYS[1:]:
        if not key.endswith("_errors"):
            assert out[key] > 0, key
    assert out["http_reqs_per_s"] == out["http_stream_reqs_per_s"]


def test_http_bench_dual_reads_the_environment(monkeypatch):
    for k, v in (("PTTS_HTTP_SLOTS", "4"), ("PTTS_HTTP_CLIENTS", "2"), ("PTTS_HTTP_REQS", "4")):
        monkeypatch.setenv(k, v)
    out = bench_http.run_http_bench_dual(**KW)
    assert out["http_cfg"] == "slots=4,clients=2,reqs=4,fps=8,pipe=1,spec=1"
    assert out["http_lowlat_cfg"] == "slots=4,clients=2,reqs=4,fps=4,pipe=1,spec=1"
    assert out["http_wav_errors"] == out["http_lowlat_wav_errors"] == 0


# -- streaming and per-stage profiles --------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_streaming_bench_on_cpu(dtype):
    r = bench_streaming.run_streaming_bench(4, 6, 64, dtype, 2, **KW)
    d = r["detail"]
    assert r["metric"] == "p50_time_to_first_chunk_ms" and r["unit"] == "ms" and r["value"] > 0
    assert d["device"] == {"name": "cpu"} and "vs_baseline" not in r
    assert d["streaming_streams_per_chip"] == pytest.approx(4 * 80.0 / d["steady_frame_ms"])
    for key in ("p90_first_ms", "readback_frame_serial_ms", "readback_frame_pipelined_ms"):
        assert d[key] > 0, key


def test_profile_stages_on_cpu():
    """Every stage is traced; the CPU has no device events, so no device
    time is reported for it."""
    r = profile_stages.run_profile_stages(batch=4, frames=12, dtype_name="f32", verbose=False,
                                          **KW)
    assert tuple(r) == profile_stages.STAGES
    for stage, v in r.items():
        assert v["busy_us"] == 0.0 and v["device_events"] == 0 and v["wall_us"] > 0, stage
        assert v["busy_share"] == v["busy_share_unprofiled"] == 0.0 and v["wall_unprofiled_us"] > 0
        assert os.path.isdir(v["trace_dir"])
    ar = r["ar"]   # its window holds the frame loop alone, over the first 8 frames
    assert ar["frames"] == profile_stages.AR_FRAMES == 8
    assert ar["per_frame_wall_us"] == pytest.approx(ar["wall_us"] / 8)
    assert tuple(profile_stages.run_profile_stages(["transformer"], batch=4, frames=12,
                                                   dtype_name="f32", verbose=False,
                                                   **KW)) == ("transformer",)
    with pytest.raises(ValueError, match="unknown stages"):
        profile_stages.run_profile_stages(["vocoder"], **KW)


def test_bench_model_dir_is_keyed_by_the_configs(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.delenv("PTTS_BENCH_MODEL_DIR")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    a = bench.bench_model_dir(FC, MC)
    weights = os.path.join(a, "tts_b6369a24.safetensors")
    stamp = os.stat(weights).st_mtime_ns
    assert bench.bench_model_dir(FC, MC) == a and os.stat(weights).st_mtime_ns == stamp
    other = bench.bench_model_dir(FC, MC.__class__(**{**MC.__dict__, "num_layers": 2}))
    assert other != a and os.path.dirname(other) == os.path.dirname(a) == str(tmp_path)
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".ptts_bench_")]


# -- (f), (g) main ---------------------------------------------------------------


@pytest.mark.parametrize("module", ["ptts_torch.bench", "ptts_torch.tools.bench_http",
                                    "ptts_torch.tools.bench_streaming",
                                    "ptts_torch.tools.profile_stages",
                                    "ptts_torch.tools.bench_batcher_sweep",
                                    "ptts_torch.tools.bench_batch_sweep"])
def test_entry_points_refuse_to_run_without_a_card(module):
    proc = subprocess.run([sys.executable, "-m", module], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA card is visible" in proc.stderr
    assert '"value"' not in proc.stdout and "streams" not in proc.stdout


def fake_offline(batch, frames, dtype_name, repeats, **kw):
    return {"metric": "concurrent_realtime_streams", "value": 10.0 * batch,
            "unit": "streams/chip", "detail": {"batch": batch, "frames": frames}}


@pytest.fixture
def card(monkeypatch):
    """main() on a pretend card: every leg faked, each recording its call."""
    calls = []
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "device_info",
                        lambda: {"name": "card", "power_limit_w": 700.0, "count": 1})
    monkeypatch.setattr(bench, "run_bench", fake_offline)
    monkeypatch.setattr(bench, "device_weights", lambda *a: ("fw", "mw"))

    def fake_batcher(slots, dtype_name, target_finished, label="", **kw):
        calls.append(("batcher", slots, target_finished, label, kw))
        return 5.0, 20.0, target_finished, 1.0

    monkeypatch.setattr(bench, "run_batcher_bench", fake_batcher)
    monkeypatch.setattr(bench, "run_batcher_bench_prepared",
                        lambda slots, reqs, frames_per_step, warmup_steps: (7.0, reqs, 1.0))
    monkeypatch.setattr(bench, "run_http_leg", lambda: {"http_reqs_per_s": 3.0})
    for k, v in (("PTTS_BENCH_BATCH", "256"), ("PTTS_BENCH_BATCHER_REQS", "100"),
                 ("PTTS_BENCH_DEVICE_SLOTS", "64")):
        monkeypatch.setenv(k, v)
    return calls


def run_main(capsys):
    rc = bench.main()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    return rc, json.loads(out[-1])


def test_main_reports_every_leg(card, capsys):
    rc, r = run_main(capsys)
    d = r["detail"]
    assert rc == 0 and d["failed_legs"] == {} and r["value"] == 2560.0
    assert d["device"] == {"name": "card", "power_limit_w": 700.0, "count": 1}
    for key in ("sustained_batcher_streams", "batcher_first_chunk_p50_ms", "batcher_finished",
                "batcher_frames_per_step", "sustained_batcher_streams_pipelined_spec",
                "batcher_pipelined_spec_p50_ms", "batcher_lowlat_streams",
                "batcher_lowlat_p50_ms", "batcher_device_streams", "batcher_device_p50_ms",
                "batcher_device_spec_streams", "batcher_device_spec_p50_ms",
                "batcher_device_serial_streams", "batcher_device_serial_p50_ms",
                "sustained_batcher_streams_prepared", "http_reqs_per_s", "kernels"):
        assert key in d, key
    assert "vs_baseline" not in r
    # bench.py's slot and request arithmetic: the offline batch, 1200 -> 100
    # requests, the device-bound legs at 64 slots with 100 * 64 // 256
    assert [c[1:3] for c in card] == [(256, 100), (256, 100), (256, 50), (64, 25), (64, 25),
                                      (64, 25)]
    # every batcher leg on the one upload, after 12 warm-up steps
    assert all(c[4]["weights"] == ("fw", "mw") and c[4]["warmup_steps"] == 12 for c in card)
    assert set(d["leg_s"]) == {"offline", "device", "batcher", "batcher_pipelined_spec",
                               "batcher_lowlat", "batcher_device", "batcher_device_spec",
                               "batcher_device_serial", "batcher_prepared", "http"}


@pytest.mark.parametrize("failing", ["offline", "device", "batcher_pipelined_spec",
                                     "batcher_prepared", "http"])
def test_a_failed_leg_is_recorded_and_fails_the_run(card, capsys, monkeypatch, failing):
    def boom(*a, **kw):
        raise RuntimeError("boom")

    if failing == "offline":
        monkeypatch.setattr(bench, "run_bench", boom)
    elif failing == "device":
        monkeypatch.setattr(bench, "device_info", boom)
    elif failing == "batcher_pipelined_spec":
        inner = bench.run_batcher_bench
        monkeypatch.setattr(bench, "run_batcher_bench",
                            lambda *a, label="", **kw: boom() if label == "pipelined+spec"
                            else inner(*a, label=label, **kw))
    elif failing == "batcher_prepared":
        monkeypatch.setattr(bench, "run_batcher_bench_prepared", boom)
    else:
        monkeypatch.setattr(bench, "run_http_leg", boom)
    rc, r = run_main(capsys)
    d = r["detail"]
    assert rc != 0
    assert d["failed_legs"] == {failing: "RuntimeError: boom"}
    assert (r["value"] is None) == (failing == "offline")
    assert ("sustained_batcher_streams" in d) and ("batcher_lowlat_streams" in d)


def test_out_of_memory_halves_the_batch(card, capsys, monkeypatch):
    def offline(batch, *a, **kw):
        if batch > 64:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return fake_offline(batch, *a, **kw)

    monkeypatch.setattr(bench, "run_bench", offline)
    rc, r = run_main(capsys)
    assert rc == 0 and r["detail"]["batch"] == 64 and r["detail"]["failed_legs"] == {}
    assert card[0][1] == 64   # the batcher's slots follow the batch actually run


def test_main_reads_the_warmup_knob(card, capsys, monkeypatch):
    monkeypatch.setenv("PTTS_BENCH_WARMUP_STEPS", "2")
    rc, _ = run_main(capsys)
    assert rc == 0 and len(card) == 6
    assert all(c[4]["warmup_steps"] == 2 for c in card)


def test_prepared_and_http_legs_can_be_turned_off(card, capsys, monkeypatch):
    monkeypatch.setenv("PTTS_BENCH_PREPARED", "0")
    monkeypatch.setenv("PTTS_BENCH_HTTP", "0")
    rc, r = run_main(capsys)
    assert rc == 0
    assert "sustained_batcher_streams_prepared" not in r["detail"]
    assert "http_reqs_per_s" not in r["detail"]
