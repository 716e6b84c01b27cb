"""The port's streaming path against the JAX package (tiny configs, CPU,
f32): streaming Mimi, the frame step, device quantization, StreamingSession
and Context.stream. Gates: decode_stream 1e-4 of max; int16 PCM within 8
LSB of the JAX session and of the quantized offline PCM (the JAX package's
own gate, tests/test_streaming.py); flags and frame counts equal."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch import convert  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.models import mimi as tmi  # noqa: E402
from ptts_torch.models import mimi_stream as tms  # noqa: E402
from ptts_torch.runtime import streaming as tst  # noqa: E402
from ptts_tpu import api as japi  # noqa: E402
from ptts_tpu.io import wav  # noqa: E402
from ptts_tpu.models import flowlm as jfl  # noqa: E402
from ptts_tpu.models import mimi as jmi  # noqa: E402
from ptts_tpu.models import mimi_stream as jms  # noqa: E402
from ptts_tpu.runtime import streaming as jst  # noqa: E402
from ptts_tpu.text import prepare_text  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FC, MC = TINY_FLOWLM, TINY_MIMI
LSB = 8


def rel_close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def max_lsb(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


@pytest.fixture(scope="module")
def mimi_weights():
    host = jmi.random_weights(MC, seed=5, scale=0.3)
    return jmi.to_device(host, cfg=MC), convert.mimi_weights(host, MC)


@pytest.fixture(scope="module")
def contexts(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("streammodel"), seed=4)
    kw = dict(flowlm_cfg=FC, mimi_cfg=MC)
    return tapi.Context(path, device="cpu", **kw), japi.Context(path, **kw)


def stream_both(jw, tw, latents, chunk):
    """decode_stream chunk by chunk through both packages."""
    B, frames, _ = latents.shape
    jstate, tstate = jms.init_state(jw, MC, B), tms.init_state(tw, MC, B)
    jout, tout = [], []
    for f0 in range(0, frames, chunk):
        jstate, jp = jms.decode_stream(jw, jstate, jnp.asarray(latents[:, f0 : f0 + chunk]), MC)
        tstate, tp = tms.decode_stream(tw, tstate, torch.from_numpy(latents[:, f0 : f0 + chunk]), MC)
        jout.append(np.asarray(jp))
        tout.append(tp.numpy())
    return np.concatenate(jout, axis=1), np.concatenate(tout, axis=1), tstate


@pytest.mark.parametrize("chunk,ring,frames", [(1, None, 6), (2, None, 6), (3, None, 6),
                                               (2, 16, 20)])
def test_decode_stream_matches_jax_and_offline(mimi_weights, monkeypatch, chunk, ring, frames):
    """Chunked streaming Mimi against the JAX decode_stream and against the
    port's own whole-sequence decode; RING=16 on both sides forces the ring
    to wrap (40 positions through 16 slots)."""
    jw, tw = mimi_weights
    if ring is not None:
        monkeypatch.setattr(jms, "RING", ring)
        monkeypatch.setattr(tms, "RING", ring)
    lat = np.random.default_rng(21 + chunk).standard_normal((2, frames, MC.latent_dim))
    lat = lat.astype(np.float32)
    want, got, state = stream_both(jw, tw, lat, chunk)
    assert got.shape == (2, frames * MC.frame_samples)
    rel_close(got, want)
    rel_close(got, tmi.decode(tw, torch.from_numpy(lat), MC).numpy())
    assert state["ring"]["k"].shape[2] == (ring or 384)
    assert state["ring"]["pos"].tolist() == [frames * MC.upsample_stride] * 2


def test_chunk_sizes_agree(mimi_weights):
    _, tw = mimi_weights
    lat = np.random.default_rng(3).standard_normal((1, 6, MC.latent_dim)).astype(np.float32)

    def stream(chunk):
        state = tms.init_state(tw, MC, 1)
        return np.concatenate([tms.decode_stream(tw, state, torch.from_numpy(lat[:, f : f + chunk]),
                                                 MC)[1].numpy() for f in range(0, 6, chunk)], axis=1)

    rel_close(stream(1), stream(3), 3e-5)


def test_quantize_i16_device_is_bit_exact():
    adversarial = np.array(
        [0.0, 1.0, -1.0, 1.5, -1.5, 0.99999, -0.99999,
         1.0 / 32767.0, -1.0 / 32767.0, 0.5, -0.5,
         np.float32(100.0 / 32767.0), -np.float32(100.0 / 32767.0),
         3.05e-5, -3.05e-5], np.float32)
    rand = (np.random.default_rng(0).standard_normal(4096) * 0.7).astype(np.float32)
    for samples in (adversarial, rand):
        got = tst.quantize_i16_device(torch.from_numpy(samples))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), wav.quantize_i16(samples))
    # bf16 PCM goes up to f32 before the multiply
    bf = torch.from_numpy(rand).bfloat16()
    np.testing.assert_array_equal(tst.quantize_i16_device(bf).numpy(),
                                  wav.quantize_i16(bf.float().numpy()))


def test_flow_frame_step_per_stream_params_match_jax():
    """Ragged [B, S_max, fd] time tables with per-stream step counts, and
    [B] threshold, min-frames and budgets, one frame at a time."""
    host = jfl.random_weights(FC, seed=3, scale=0.3)
    jw, tw = jfl.to_device(host, jnp.float32, FC), convert.flowlm_weights(host, FC)
    rng = np.random.default_rng(5)
    B, T, F = 3, 5, 4
    x = (rng.standard_normal((B, T, FC.d_model)) * 0.5).astype(np.float32)
    lens = np.array([5, 2, 4], np.int32)
    steps = np.array([1, 3, 2], np.int32)
    tabs = np.zeros((B, 3, FC.flow_dim), np.float32)
    for b, n in enumerate(steps):
        tabs[b, :n] = np.asarray(jfl.lsd_time_embeds(jw, int(n), FC))
    thr = np.array([-1e9, 1e9, -1e9], np.float32)
    min_frames = np.array([2, 1, 1], np.int32)
    eos_after = np.array([0, 0, 1], np.int32)
    budget = np.array([4, 3, 4], np.int32)
    jc, jx = jfl.prefill_init(jw, jnp.asarray(x), jnp.asarray(lens), FC, T + F)
    tc, tx = tfl.prefill_init(tw, torch.from_numpy(x), torch.from_numpy(lens), FC, T + F)
    jstate = (jnp.full((B,), -1, jnp.int32), jnp.zeros((B,), bool))
    tstate = (torch.full((B,), -1, dtype=torch.int32), torch.zeros(B, dtype=torch.bool))
    for i in range(F):
        noise = rng.standard_normal((B, FC.latent_dim)).astype(np.float32)
        jc, jx, jscaled, jeos, *jstate = jst.flow_frame_step(
            jw, jc, jx, jnp.asarray(noise), jnp.asarray(tabs), jnp.int32(i), *jstate, FC, True,
            jnp.asarray(thr), jnp.asarray(min_frames), jnp.asarray(eos_after),
            jnp.asarray(budget), jnp.asarray(steps))
        tc, tx, tscaled, teos, *tstate = tst.flow_frame_step(
            tw, tc, tx, torch.from_numpy(noise), torch.from_numpy(tabs), i, *tstate, FC, True,
            torch.from_numpy(thr), torch.from_numpy(min_frames), torch.from_numpy(eos_after),
            torch.from_numpy(budget), torch.from_numpy(steps))
        rel_close(tscaled, jscaled)
        rel_close(tx, jx)
        rel_close(teos, jeos)
        for t, j in zip(tstate, jstate):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tstate[1].tolist() == [True, True, True]


def prefixes_of(ctx, texts):
    out = []
    for text in texts:
        prepared, _, _ = prepare_text(text)
        cond, _ = ctx.engine._voice_cond(None)
        out.append(ctx.engine._build_prefix(ctx.tokenize(prepared), cond))
    return out


RAGGED = dict(num_frames=6, num_steps=1, seed=4, temp=0.5, eos_enabled=True,
              eos_threshold=-1e9, eos_min_frames=2, eos_after=1)


def ragged_session(module, ctx, pipeline=True, frames_each=None):
    """B = 2, 6 frames, EOS forced at frame 1; stream 0 keeps 1 frame after
    it and stream 1 keeps 3, so the streams end at frames 2 and 4."""
    texts = ["hello world", "how low"]
    return module.StreamingSession(ctx.engine, prefixes_of(ctx, texts), 6,
                                   japi.Params(**RAGGED).normalized(),
                                   np.array([1, 3], np.int32), pipeline=pipeline,
                                   frames_each=frames_each)


def test_session_matches_jax(contexts):
    tctx, jctx = contexts
    got = list(ragged_session(tst, tctx))
    want = list(ragged_session(jst, jctx))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.frame_index == w.frame_index
        np.testing.assert_array_equal(g.active, w.active)
        assert g.pcm_i16.dtype == np.int16 and g.pcm_i16.shape == (2, MC.frame_samples)
        assert max_lsb(g.pcm_i16, w.pcm_i16) <= LSB
        rel_close(g.eos_logits, w.eos_logits, 1e-3)
    assert [c.active.tolist() for c in got][2:] == [[True, True], [False, True], [False, True]]


def test_session_frames_used_matches_jax(contexts):
    tctx, jctx = contexts
    sessions = [ragged_session(tst, tctx), ragged_session(jst, jctx)]
    for s in sessions:
        for _ in s:
            pass
    np.testing.assert_array_equal(sessions[0].frames_used, sessions[1].frames_used)
    assert sessions[0].frames_used.tolist() == [3, 5]


def test_pipelined_equals_serial(contexts):
    tctx, _ = contexts
    serial = ragged_session(tst, tctx, pipeline=False)
    piped = ragged_session(tst, tctx, pipeline=True)
    cs, cp = list(serial), list(piped)
    assert len(cs) == len(cp) == 5
    for a, b in zip(cs, cp):
        assert a.frame_index == b.frame_index
        np.testing.assert_array_equal(a.active, b.active)
        np.testing.assert_array_equal(a.pcm_i16, b.pcm_i16)
        np.testing.assert_array_equal(a.eos_logits, b.eos_logits)
    np.testing.assert_array_equal(serial.frames_used, piped.frames_used)


def test_per_stream_frame_budgets(contexts):
    tctx, _ = contexts
    texts = ["hello world", "how low"]
    sess = tst.StreamingSession(
        tctx.engine, prefixes_of(tctx, texts), 5,
        japi.Params(num_frames=5, num_steps=1, seed=3, temp=0.4, eos_enabled=False).normalized(),
        np.array([2, 2], np.int32), frames_each=np.array([2, 5], np.int32))
    chunks = list(sess)
    assert len(chunks) == 5
    actives = np.stack([c.active for c in chunks])
    assert actives[:, 0].tolist() == [True, True, False, False, False]
    assert actives[:, 1].tolist() == [True] * 5
    assert sess.frames_used.tolist() == [2, 5]


def test_start_and_step_match_jax(contexts):
    """StreamingSession.start (prompt assembly, per-text budgets) and the
    first step() by hand, against the JAX session."""
    tctx, jctx = contexts
    p = japi.Params(num_frames=3, num_steps=2, seed=1, temp=0.3, eos_enabled=False)
    ts = tst.StreamingSession.start(tctx.engine, ["hello"], params=p, pipeline=False)
    js = jst.StreamingSession.start(jctx.engine, ["hello"], params=p, pipeline=False)
    first = ts.step()
    assert first.frame_index == 0 and not ts.all_done
    assert max_lsb(first.pcm_i16, js.step().pcm_i16) <= LSB
    assert len(list(ts)) == 2 and ts.all_done
    assert ts.frames_used.tolist() == [3]
    with pytest.raises(StopIteration):
        ts.step()


def test_fused_stream_steps_equal_single_steps(contexts):
    """k = 3 frames with one Mimi chunk against 3 one-frame steps, through
    stream 0 ending at frame 0 (eos_after 0) and stream 1 running on."""
    tctx, _ = contexts
    engine = tctx.engine
    p = japi.Params(num_frames=4, num_steps=1, seed=2, temp=0.5, eos_enabled=True,
                    eos_threshold=-1e9, eos_min_frames=1)
    sessions = [tst.StreamingSession(engine, prefixes_of(tctx, ["hello world", "how low"]), 4,
                                     p.normalized(), np.array([0, 3], np.int32),
                                     pipeline=False) for _ in range(2)]
    with torch.inference_mode():
        args = lambda s: (engine.fw, engine.mw, s.cache, s.mimi_state, s.x, s._noise_dev,
                          s.time_embs)
        flags = lambda s: (s.cfg, engine.mimi_cfg, True, p.eos_threshold, p.eos_min_frames,
                           s.eos_after, s.frames_each)
        a = sessions[0]
        out = tst.fused_stream_steps(*args(a), torch.zeros(2, dtype=torch.int32), a.eos_step,
                                     a.done, *flags(a), None, k=3, pack_flags=True)
        pcm_k, eos_k, eos_step, done, wd_k, fidx = out[3:]
        b = sessions[1]
        singles, was = [], []
        cache, state, x, eos_step1, done1 = b.cache, b.mimi_state, b.x, b.eos_step, b.done
        for i in range(3):
            was.append(done1)
            cache, state, x, pcm, eos, eos_step1, done1 = tst.fused_stream_step(
                engine.fw, engine.mw, cache, state, x, b._noise_dev, b.time_embs, i,
                eos_step1, done1, *flags(b), emit_i16=True)
            singles.append(pcm)
    assert pcm_k.shape == (3, 2, MC.frame_samples + 2) and pcm_k.dtype == torch.int16
    assert max_lsb(pcm_k[..., :-2].numpy(), torch.stack(singles).numpy()) <= 1
    np.testing.assert_array_equal(wd_k.numpy(), torch.stack(was).numpy())
    assert wd_k.tolist() == [[False, False], [True, False], [True, False]]
    np.testing.assert_array_equal(pcm_k[..., -2].numpy(), wd_k.numpy().astype(np.int16))
    assert (pcm_k[..., -1] == done.to(torch.int16)).all()
    np.testing.assert_array_equal(done.numpy(), done1.numpy())
    np.testing.assert_array_equal(eos_step.numpy(), eos_step1.numpy())
    assert fidx.tolist() == [3, 3] and eos_k.shape == (3, 2)


def test_bf16_session_stays_near_f32_reference(contexts, monkeypatch):
    """PTTS_DTYPE=bf16: ring K/V, carries and the noise table in bf16, the
    Euler time tables in f32; the streamed PCM stays within the bf16
    engine's bound (0.08 of max) of the JAX f32 session."""
    from ptts_torch.runtime.engine import TTSEngine

    tctx, jctx = contexts
    monkeypatch.setenv("PTTS_DTYPE", "bf16")
    engine = TTSEngine(tctx)
    sess = tst.StreamingSession(engine, prefixes_of(tctx, ["hello world", "how low"]), 6,
                                japi.Params(**RAGGED).normalized(), np.array([1, 3], np.int32))
    assert sess.mimi_state["ring"]["k"].dtype == sess.mimi_state["dec_in"].dtype == torch.bfloat16
    assert sess.time_embs.dtype == torch.float32
    got = np.concatenate([c.pcm for c in sess], axis=1)
    want = np.concatenate([c.pcm for c in ragged_session(jst, jctx)], axis=1)
    rel_close(got, want, 0.08)


def test_context_stream_matches_generate(contexts):
    """Context.stream iterated from plain code (no inference mode around
    it): one 80 ms int16 chunk per frame, equal to the quantized generate."""
    tctx, jctx = contexts
    p = japi.Params(num_frames=4, num_steps=1, seed=11, temp=0.5, eos_enabled=False)
    assert not torch.is_inference_mode_enabled()
    chunks = []
    for c in tctx.stream("hello world", params=p):
        chunks.append(c)
    assert len(chunks) == 4
    for c in chunks:
        assert c.pcm_i16.shape == (MC.frame_samples,) and c.sample_rate == p.sample_rate
        np.testing.assert_array_equal(wav.quantize_i16(c.samples), c.pcm_i16)
    streamed = np.concatenate([c.pcm_i16 for c in chunks])
    assert max_lsb(streamed, wav.quantize_i16(tctx.generate("hello world", params=p).samples)) <= LSB
    jstreamed = np.concatenate([c.pcm_i16 for c in jctx.stream("hello world", params=p)])
    assert max_lsb(streamed, jstreamed) <= LSB


def test_context_stream_stops_at_eos(contexts):
    tctx, _ = contexts
    p = japi.Params(num_frames=8, num_steps=1, seed=3, temp=0.4, eos_enabled=True,
                    eos_threshold=-1e9, eos_min_frames=2, eos_after=1)
    assert len(list(tctx.stream("hello", params=p))) == 3


def test_port_streams_without_jax(tmp_path):
    """A fresh interpreter streams on the CPU and never loads jax."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from ptts_tpu.config import FlowLMConfig, MimiConfig
from ptts_torch import api, synth
fc = FlowLMConfig(vocab=60, text_dim=16, d_model=16, num_heads=2, head_dim=8, num_layers=2,
                  hidden=32, latent_dim=8, flow_dim=16, flow_depth=2, time_freqs=4)
mc = MimiConfig(latent_dim=8, d_model=8, num_heads=2, head_dim=4, num_layers=1, hidden=16,
                context=5, upsample_kernel=4, upsample_stride=2, n_filters=4, ratios=(3, 2),
                kernel_size=5)
path = synth.write_model_dir({str(tmp_path)!r}, fc, mc, seed=1, scale=0.3)
ctx = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cpu")
chunks = list(ctx.stream("Hello world!", params=api.Params(seed=1, num_frames=3, eos_enabled=False)))
assert len(chunks) == 3 and all(c.pcm_i16.shape == (mc.frame_samples,) for c in chunks)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
