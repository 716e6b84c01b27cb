"""The port's main path end to end against the JAX package: the same
synthetic model dir through ptts_torch.api.Context(...).engine and
ptts_tpu.api.Context(...).engine on the CPU, same seeds. Gate: frames_used
equal; latents, PCM and the parity taps within 1e-3 of their max (the JAX
serving paths were calibrated to 2-3e-4 of f32 drift against each other)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_tpu import api as japi  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3


def rel_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def contexts(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("model"), seed=6)
    kw = dict(flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI)
    return tapi.Context(path, device="cpu", **kw), japi.Context(path, **kw)


@pytest.mark.parametrize("params", [
    dict(seed=1, num_steps=2),                                     # EOS on, auto frames
    dict(seed=5, num_frames=9, eos_enabled=False, temp=0.4),       # fixed length
])
def test_generate_full_matches_jax(contexts, params):
    tctx, jctx = contexts
    p = japi.Params(**params)
    got = tctx.engine.generate_full("Hello world, this is a test.", params=p)
    want = jctx.engine.generate_full("Hello world, this is a test.", params=p)
    assert got.frames_used == want.frames_used
    rel_close(got.latents, want.latents)
    rel_close(got.audio.samples, want.audio.samples)
    rel_close(got.first_cond, want.first_cond)
    rel_close(got.first_flow, want.first_flow)
    assert abs(got.first_eos_logit - want.first_eos_logit) <= TOL * max(1.0, abs(want.first_eos_logit))
    assert len(got.audio.samples) == got.frames_used * TINY_MIMI.frame_samples


@pytest.mark.parametrize("texts,length_buckets", [
    (["Hello world!", "Hi.", "one two three four five six seven eight"], 1),
    (["Hi.", " ".join(["word"] * 40), "Hello world!", " ".join(["more"] * 30)], 2),
])
def test_batch_generate_ragged_matches_jax(contexts, texts, length_buckets):
    tctx, jctx = contexts
    p = japi.Params(seed=3, num_steps=1)
    got = tctx.engine.batch_generate(texts, params=p, length_buckets=length_buckets)
    want = jctx.engine.batch_generate(texts, params=p, length_buckets=length_buckets)
    assert len({len(a.samples) for a in want}) > 1  # ragged
    for g, w in zip(got, want):
        rel_close(g.samples, w.samples)


def test_bf16_engine_stays_near_f32_reference(contexts, monkeypatch):
    """PTTS_DTYPE=bf16 selects the bf16 engine; its drift is bounded as
    tests/test_bf16.py bounds the JAX bf16 path (0.08): latents against the
    JAX f32 engine, PCM against the JAX bf16 engine, whose host prompt
    tables are rounded to bf16 as the port's are (the 9-frame PCM of the
    random tiny model amplifies that rounding alone to ~8% of max)."""
    from ptts_torch.runtime.engine import TTSEngine
    from ptts_tpu.runtime.engine import TTSEngine as JEngine

    tctx, jctx = contexts
    monkeypatch.setenv("PTTS_DTYPE", "bf16")
    engine = TTSEngine(tctx)
    assert engine.dtype == torch.bfloat16
    assert engine.warmup((1, 2), num_frames=2) > 0
    p = japi.Params(seed=5, num_frames=9, eos_enabled=False, temp=0.4)
    got = engine.generate_full("Hello world, this is a test.", params=p)
    want = jctx.engine.generate_full("Hello world, this is a test.", params=p)
    want_bf16 = JEngine(jctx).generate_full("Hello world, this is a test.", params=p)
    rel_close(got.latents, want.latents, 0.08)
    rel_close(got.audio.samples, want_bf16.audio.samples, 0.08)


def test_port_runs_without_jax(tmp_path):
    """A fresh interpreter imports ptts_torch, writes a tiny synthetic model,
    generates on the CPU and never loads jax or the JAX package
    (tests/conftest.py imports jax, so this needs its own process)."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from ptts_torch import api, cli, synth
from ptts_torch.config import FlowLMConfig, MimiConfig
fc = FlowLMConfig(vocab=60, text_dim=16, d_model=16, num_heads=2, head_dim=8, num_layers=2,
                  hidden=32, latent_dim=8, flow_dim=16, flow_depth=2, time_freqs=4)
mc = MimiConfig(latent_dim=8, d_model=8, num_heads=2, head_dim=4, num_layers=1, hidden=16,
                context=5, upsample_kernel=4, upsample_stride=2, n_filters=4, ratios=(3, 2),
                kernel_size=5)
path = synth.write_model_dir({str(tmp_path)!r}, fc, mc, seed=1, scale=0.3)
ctx = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cpu")
out = ctx.engine.generate_full("Hello world!", params=api.Params(seed=1, num_frames=4))
assert len(out.audio.samples) == out.frames_used * mc.frame_samples > 0
assert not [m for m in sys.modules if m.startswith(("jax", "ptts_tpu"))], sorted(
    m for m in sys.modules if m.startswith(("jax", "ptts_tpu")))
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.fixture(scope="module")
def full_size_dir(tmp_path_factory):
    from ptts_torch import synth

    return synth.write_model_dir(str(tmp_path_factory.mktemp("full")), seed=0)


def test_synth_full_size_dir_verifies(full_size_dir):
    """ptts_torch.synth writes the real checkpoint's schema at full size."""
    ctx = japi.Context(full_size_dir)
    report = ctx.verify_weights()
    assert report.errors == 0, report.format()
    assert ctx.tokenize("Hello world!")
    cond, frames = japi.load_voice_conditioning(full_size_dir, None, 1024)
    assert cond.shape == (frames, 1024)
    ctx.close()


def test_cli_generates_wav_at_full_size(full_size_dir, tmp_path):
    from ptts_torch import cli
    from ptts_tpu.io.wav import load_wav

    out = str(tmp_path / "out.wav")
    assert cli.main(["-d", full_size_dir, "-p", "Hello world!", "-o", out, "--seed", "1",
                     "--frames", "2", "--device", "cpu", "-q"]) == 0
    n = load_wav(out).num_samples
    assert n in (1920, 2 * 1920)
    assert cli.main(["-d", str(tmp_path / "missing"), "-p", "x", "-o", out,
                     "--device", "cpu"]) == 1
