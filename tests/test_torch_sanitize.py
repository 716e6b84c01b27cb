"""PTTS_SANITIZE in the port (ptts_torch/utils/sanitize.py and the engine's
three guard points), on the tiny synthetic model, CPU, f32. Both packages
read the one environment switch; the port keeps its own override and its
own error class."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.models import mimi as tmi  # noqa: E402
from ptts_torch.runtime.engine import TTSEngine  # noqa: E402
from ptts_torch.utils import sanitize  # noqa: E402
from ptts_tpu.utils import sanitize as jsanitize  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = tapi.Params(num_frames=3, num_steps=1, seed=1, eos_enabled=False)


@pytest.fixture
def sanitizing():
    sanitize.set_enabled(True)
    yield
    sanitize.set_enabled(None)


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("sanmodel"), seed=5)
    return tapi.Context(path, flowlm_cfg=TINY_FLOWLM, mimi_cfg=TINY_MIMI, device="cpu")


def test_one_switch_for_both_packages(monkeypatch):
    """PTTS_SANITIZE turns both packages on; set_enabled overrides the
    port's switch alone, and the port raises its own SanitizeError."""
    assert sanitize.SanitizeError is not jsanitize.SanitizeError
    assert issubclass(sanitize.SanitizeError, RuntimeError)
    monkeypatch.setenv("PTTS_SANITIZE", "1")
    try:
        sanitize.set_enabled(None)
        jsanitize.set_enabled(None)
        assert sanitize.enabled() and jsanitize.enabled()
        sanitize.set_enabled(False)
        assert not sanitize.enabled() and jsanitize.enabled()
    finally:
        sanitize.set_enabled(None)
        jsanitize.set_enabled(None)


def test_env_var_turns_it_on(monkeypatch):
    sanitize.set_enabled(None)
    monkeypatch.setenv("PTTS_SANITIZE", "1")
    try:
        assert sanitize.enabled()
    finally:
        sanitize.set_enabled(None)
    monkeypatch.delenv("PTTS_SANITIZE")
    assert not sanitize.enabled()
    sanitize.set_enabled(None)


def test_disabled_is_noop():
    sanitize.set_enabled(False)
    try:
        sanitize.check_finite("x", torch.tensor([float("nan")]), np.array([np.inf]))
        sanitize.check_tree("x", {"w": np.array([np.inf])})
    finally:
        sanitize.set_enabled(None)


def test_check_finite_reads_tensors(sanitizing):
    sanitize.check_finite("s", torch.zeros(3), torch.ones(2, 2, dtype=torch.bfloat16),
                          torch.arange(3), None, np.zeros(2))
    with pytest.raises(sanitize.SanitizeError, match="stage 'lat', array 'latents', index \\(0, 1\\)"):
        sanitize.check_finite("lat", torch.tensor([[0.0, float("nan")]]), names=("latents",))
    with pytest.raises(sanitize.SanitizeError, match="index \\(1,\\)"):
        sanitize.check_finite("pcm", torch.tensor([0.0, float("inf")], dtype=torch.bfloat16))


def test_check_tree_names_the_tensor(sanitizing):
    tree = {"a": np.zeros(2), "flow": {"res": [np.ones(2), np.array([1.0, np.nan])]},
            "opt": None, "stride": 3}
    with pytest.raises(sanitize.SanitizeError, match=r"tensor '\['flow'\]\['res'\]\[1\]'"):
        sanitize.check_tree("load", tree)
    sanitize.check_tree("load", {"a": np.zeros(2), "b": [torch.ones(3)], "c": None})


@pytest.mark.parametrize("module,name", [(tfl, "emb_std"), (tmi, "quant_w")])
def test_engine_rejects_corrupt_checkpoint(ctx, sanitizing, monkeypatch, module, name):
    """A NaN planted in one weight fails engine construction, naming it."""
    real = module.load_weights

    def poisoned(st, cfg):
        w = dict(real(st, cfg))
        w[name] = np.array(w[name], np.float32)
        w[name].flat[0] = np.nan
        return w

    monkeypatch.setattr(module, "load_weights", poisoned)
    with pytest.raises(sanitize.SanitizeError, match=f"'{name}'"):
        TTSEngine(ctx)


def poisoned_engine(ctx, part):
    """A clean engine (construction passes), then one device weight set to
    NaN: FlowLM's last flow layer bias (non-finite latents) or the Mimi
    output conv bias (finite latents, non-finite PCM)."""
    engine = TTSEngine(ctx)
    with torch.no_grad():
        if part == "latents":
            engine.fw.flow.final_linear_b.fill_(float("nan"))
        else:
            engine.mw.dec_out_bias.fill_(float("nan"))
    return engine


@pytest.mark.parametrize("part,stage", [("latents", "generate_latents_batch"),
                                        ("pcm", "decode_audio_batch")])
def test_non_finite_stage_output_raises_at_generate(ctx, sanitizing, part, stage):
    engine = poisoned_engine(ctx, part)
    with pytest.raises(sanitize.SanitizeError, match=f"stage '{stage}', array '{part}'"):
        engine.generate("hello", params=P)


def test_nothing_is_checked_when_off(ctx):
    sanitize.set_enabled(False)
    try:
        audio = poisoned_engine(ctx, "pcm").generate("hello", params=P)
    finally:
        sanitize.set_enabled(None)
    assert np.isnan(audio.samples).any()


def test_clean_generate_stays_silent(ctx, sanitizing):
    audio = TTSEngine(ctx).generate("hello", params=P)
    assert audio.samples.shape == (3 * TINY_MIMI.frame_samples,)
    assert np.isfinite(audio.samples).all()


def test_sanitize_runs_without_jax(tmp_path):
    """A fresh interpreter with PTTS_SANITIZE=1: the engine checks its
    weights and stage outputs, rejects a NaN weight, and never loads jax."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np, torch
from ptts_tpu.config import FlowLMConfig, MimiConfig
from ptts_torch import api, synth
from ptts_torch.models import flowlm
from ptts_torch.utils import sanitize
assert sanitize.enabled()
fc = FlowLMConfig(vocab=60, text_dim=16, d_model=16, num_heads=2, head_dim=8, num_layers=2,
                  hidden=32, latent_dim=8, flow_dim=16, flow_depth=2, time_freqs=4)
mc = MimiConfig(latent_dim=8, d_model=8, num_heads=2, head_dim=4, num_layers=1, hidden=16,
                context=5, upsample_kernel=4, upsample_stride=2, n_filters=4, ratios=(3, 2),
                kernel_size=5)
path = synth.write_model_dir({str(tmp_path)!r}, fc, mc, seed=1, scale=0.3)
ctx = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cpu")
audio = ctx.generate("Hello!", params=api.Params(seed=1, num_frames=2, eos_enabled=False))
assert np.isfinite(audio.samples).all()
real = flowlm.load_weights
def poisoned(st, cfg):
    w = dict(real(st, cfg)); w["bos_emb"] = np.full_like(w["bos_emb"], np.inf); return w
flowlm.load_weights = poisoned
try:
    api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cpu").engine
    raise SystemExit("no SanitizeError")
except sanitize.SanitizeError as e:
    assert "'bos_emb'" in str(e), e
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu", "PTTS_SANITIZE": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
