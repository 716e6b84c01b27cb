"""The port's own host layer (ptts_torch/{config,text,rng,verify,api}.py,
io/, tokenizer/, native/, utils/timing.py) against the JAX package's
originals on the same inputs, and the isolation of the port: no module of
ptts_torch and no line of chip_smoke.py imports ptts_tpu, jax or ml_dtypes.

Everything here is host code: the gates are equality (bit-equal arrays,
identical ids, reports and strings)."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from ptts_torch import api as tapi
from ptts_torch import config as tconfig
from ptts_torch import native as tnative
from ptts_torch import rng as trng
from ptts_torch import synth
from ptts_torch import text as ttext
from ptts_torch import verify as tverify
from ptts_torch.io import safetensors as tst
from ptts_torch.io import wav as twav
from ptts_torch.tokenizer import load_tokenizer as t_load_tokenizer
from ptts_torch.tokenizer.spm import SentencePieceModel as TSpm
from ptts_torch.utils import timing as ttiming
from ptts_tpu import api as japi
from ptts_tpu import config as jconfig
from ptts_tpu import native as jnative
from ptts_tpu import rng as jrng
from ptts_tpu import text as jtext
from ptts_tpu import verify as jverify
from ptts_tpu.io import safetensors as jst
from ptts_tpu.io import wav as jwav
from ptts_tpu.tokenizer import load_tokenizer as j_load_tokenizer
from ptts_tpu.tokenizer.spm import SentencePieceModel as JSpm
from ptts_tpu.utils import timing as jtiming

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROMPTS = ["Hello world!", "  hello   world  ", "one\ttwo\nthree\rfour five six",
           "the quick brown fox jumps over the lazy dog", "42", "émigré café, naïve?",
           "a", "Ends with a digit 7", "...", "x " * 40]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    fc = tconfig.FlowLMConfig(vocab=60, text_dim=16, d_model=16, num_heads=2, head_dim=8,
                              num_layers=2, hidden=32, latent_dim=8, flow_dim=16,
                              flow_depth=2, time_freqs=4)
    mc = tconfig.MimiConfig(latent_dim=8, d_model=8, num_heads=2, head_dim=4, num_layers=1,
                            hidden=16, context=5, upsample_kernel=4, upsample_stride=2,
                            n_filters=4, ratios=(3, 2), kernel_size=5)
    return synth.write_model_dir(str(tmp_path_factory.mktemp("host")), fc, mc, seed=3,
                                 scale=0.3), fc, mc


# -- config, text --------------------------------------------------------------


def jax_config(cls, cfg):
    """The JAX package's config of the same values: the port's FlowLMConfig
    also describes the hybrid backbone, which the JAX package has not."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


@pytest.mark.parametrize("name", ["FlowLMConfig", "MimiConfig"])
def test_config_defaults_match(name):
    t, j = getattr(tconfig, name)(), getattr(jconfig, name)()
    # every field the JAX package has, equal; the port's others are the
    # hybrid backbone's, whose defaults leave Pocket's transformer
    assert {k: v for k, v in dataclasses.asdict(t).items()
            if k in dataclasses.asdict(j)} == dataclasses.asdict(j)
    assert not tconfig.is_hybrid(t)
    for prop in ("qkv_dim", "frame_samples", "frame_rate", "sample_rate"):
        if hasattr(j, prop):
            assert getattr(t, prop) == getattr(j, prop)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_prepare_text_matches(prompt):
    got = ttext.prepare_text(prompt)
    assert got == jtext.prepare_text(prompt)
    assert ttext.estimate_frames(got[1]) == jtext.estimate_frames(got[1])


@pytest.mark.parametrize("prompt", ["", "   ", "\n\t\r"])
def test_empty_prompt_refused_alike(prompt):
    with pytest.raises(ttext.EmptyPromptError):
        ttext.prepare_text(prompt)
    with pytest.raises(jtext.EmptyPromptError):
        jtext.prepare_text(prompt)


def test_estimate_frames_matches():
    for words in range(-2, 60):
        assert ttext.estimate_frames(words) == jtext.estimate_frames(words)


# -- host RNG ------------------------------------------------------------------


NOISE_CASES = [(1, 0.7, 0.0), (12345, 0.7, 0.0), (-1, 0.4, 0.0), (2**40 + 7, 1.0, 1.5),
               (0, 0.0, 0.0), (77, 0.3, 0.25)]


@pytest.fixture(scope="module")
def private_jax_native(tmp_path_factory):
    """The JAX package's host library, built by its own code from the same
    csrc/ptts_host.cpp into a directory of this module's alone. That build
    writes its .so in place, so processes that build it at once in the shared
    location can load a half-written file and fall back to Python for good;
    a private path keeps the comparison off that race. The module's state is
    restored afterwards."""
    so = str(tmp_path_factory.mktemp("jax_native") / "libptts_host.so")
    saved = {k: getattr(jnative, k) for k in ("_SO", "_STAMP", "_tried", "_lib")}
    for k, v in {"_SO": so, "_STAMP": so + ".sha256", "_tried": False, "_lib": None}.items():
        setattr(jnative, k, v)
    yield
    for k, v in saved.items():
        setattr(jnative, k, v)


@pytest.mark.parametrize("seed,temp,clamp", NOISE_CASES)
def test_frame_noise_native_bit_equal(seed, temp, clamp, private_jax_native):
    assert tnative.available(), "the port's host library (ptts_torch.native) did not load"
    assert jnative.available(), "the JAX package's host library (ptts_tpu.native) did not load"
    got = trng.frame_noise(seed, 9, 32, temp, clamp)
    want = jrng.frame_noise(seed, 9, 32, temp, clamp)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,temp,clamp", NOISE_CASES)
def test_frame_noise_python_bit_equal(seed, temp, clamp, monkeypatch):
    """The pure-Python Box-Muller path of both packages (native off)."""
    monkeypatch.setattr(tnative, "frame_noise", lambda *a: None)
    monkeypatch.setattr(jnative, "frame_noise", lambda *a: None)
    got = trng.frame_noise(seed, 5, 8, temp, clamp)
    want = jrng.frame_noise(seed, 5, 8, temp, clamp)
    np.testing.assert_array_equal(got, want)


# -- tokenizer -----------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
def test_tokenizer_ids_match(model_dir, native):
    path = os.path.join(model_dir[0], "tokenizer.model")
    if native:
        assert tnative.available()
        tok, jtok = t_load_tokenizer(path), j_load_tokenizer(path)
        assert isinstance(tok, tnative.NativeTokenizer)
    else:
        tok, jtok = TSpm.load(path), JSpm.load(path)
    assert tok.vocab_size == jtok.vocab_size
    for prompt in PROMPTS + ["hello <unk> world", ""]:
        assert tok.encode(prompt) == jtok.encode(prompt), prompt
    for pid in range(tok.vocab_size):
        assert tok.piece(pid) == jtok.piece(pid)


def test_native_off_picks_python(model_dir, monkeypatch):
    monkeypatch.setenv("PTTS_NATIVE", "0")
    tok = t_load_tokenizer(os.path.join(model_dir[0], "tokenizer.model"))
    assert isinstance(tok, TSpm)


# -- safetensors, WAV ----------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_safetensors_round_trip(tmp_path, writer):
    rng = np.random.default_rng(0)
    arrays = {"a.f32": rng.standard_normal((3, 5)).astype(np.float32),
              "b.f16": rng.standard_normal(7).astype(np.float16),
              "c.bf16": rng.standard_normal((2, 4)).astype(np.float32),
              "d.i32": np.arange(6, dtype=np.int32).reshape(2, 3),
              "e.i64": np.arange(3, dtype=np.int64), "f.bool": np.array([True, False])}
    path = str(tmp_path / "x.safetensors")
    (tst if writer == "port" else jst).save_safetensors(path, arrays, bf16=["c.bf16"])
    with tst.SafetensorsFile(path) as t, jst.SafetensorsFile(path) as j:
        assert t.names() == j.names() == list(arrays)
        assert t.format_all() == j.format_all()
        for name in arrays:
            te, je = t.find(name), j.find(name)
            assert (te.dtype, te.shape, te.data_size) == (je.dtype, je.shape, je.data_size)
            np.testing.assert_array_equal(t.view(te), j.view(je))
            if te.dtype in ("F32", "F16", "BF16"):
                np.testing.assert_array_equal(t.get_f32(te), j.get_f32(je))
        np.testing.assert_array_equal(t.get_f32_by_name("a.f32"), arrays["a.f32"])


def test_quantize_i16_bit_equal():
    x = np.concatenate([np.linspace(-1.5, 1.5, 20001, dtype=np.float32),
                        np.array([0.0, -0.0, 1.0, -1.0, 3e-5, -3e-5, np.float32(1 / 32767)],
                                 np.float32),
                        np.random.default_rng(1).standard_normal(4096).astype(np.float32)])
    got = twav.quantize_i16(x)
    np.testing.assert_array_equal(got, jwav.quantize_i16(x))
    np.testing.assert_array_equal(tnative.quantize_i16(x), got)


def test_wav_round_trip(tmp_path):
    samples = (np.random.default_rng(2).standard_normal(4800) * 0.3).astype(np.float32)
    a = twav.Audio(sample_rate=24000, channels=1, samples=samples)
    tp, jp = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    twav.save_wav(a, tp)
    jwav.save_wav(jwav.Audio(sample_rate=24000, channels=1, samples=samples), jp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    back = twav.load_wav(tp)
    np.testing.assert_array_equal(back.samples, jwav.load_wav(tp).samples)
    assert (back.sample_rate, back.channels, back.num_samples) == (24000, 1, 4800)


# -- verify, api ---------------------------------------------------------------


@pytest.mark.parametrize("damage", [None, "drop", "reshape"])
def test_verify_weights_report_matches(model_dir, damage, tmp_path):
    path, fc, mc = model_dir
    weights = os.path.join(path, synth.WEIGHTS_NAME)
    if damage is not None:
        with tst.SafetensorsFile(weights) as sf:
            arrays = {t.name: sf.get_f32(t) for t in sf.tensors}
        if damage == "drop":
            arrays.pop(next(n for n in arrays if n.endswith("out_eos.bias")))
        else:
            name = next(n for n in arrays if n.endswith("bos_emb"))
            arrays[name] = np.zeros(3, np.float32)
        weights = str(tmp_path / "bad.safetensors")
        tst.save_safetensors(weights, arrays)
    with tst.SafetensorsFile(weights) as t, jst.SafetensorsFile(weights) as j:
        got = tverify.verify_weights(t, fc, mc)
        want = jverify.verify_weights(j, jax_config(jconfig.FlowLMConfig, fc),
                                      jconfig.MimiConfig(**dataclasses.asdict(mc)))
    assert (got.missing, got.mismatch, got.ambiguous) == (want.missing, want.mismatch,
                                                          want.ambiguous)
    assert got.format() == want.format()
    assert (got.errors == 0) == (damage is None)


def test_context_introspection_matches(model_dir):
    path, fc, mc = model_dir
    t = tapi.Context(path, flowlm_cfg=fc, mimi_cfg=mc, device="cpu")
    j = japi.Context(path, flowlm_cfg=jax_config(jconfig.FlowLMConfig, fc),
                     mimi_cfg=jconfig.MimiConfig(**dataclasses.asdict(mc)))
    try:
        assert t.info() == j.info()
        assert t.list_tensors() == j.list_tensors()
        assert t.find_tensors("norm1") == j.find_tensors("norm1")
        assert t.tokenize("Hello world!") == j.tokenize("Hello world!")
        assert t.token_piece(5) == j.token_piece(5)
        assert t.verify_weights().errors == j.verify_weights().errors == 0
        assert str(t.device) == "cpu"
    finally:
        t.close()
        j.close()


def test_voice_conditioning_and_params_match(model_dir):
    path, fc, _ = model_dir
    got, n = tapi.load_voice_conditioning(path, None, fc.d_model)
    want, m = japi.load_voice_conditioning(path, None, fc.d_model)
    assert n == m > 0
    np.testing.assert_array_equal(got, want)
    assert tapi.load_voice_conditioning(path, "none", fc.d_model) == (None, 0)
    with pytest.raises(tapi.PttsError):
        tapi.load_voice_conditioning(path, "no-such-voice", fc.d_model)
    raw = dict(num_frames=-3, num_steps=0, temp=-1.0, sample_rate=0, eos_min_frames=0)
    assert (dataclasses.asdict(tapi.Params(**raw).normalized())
            == dataclasses.asdict(japi.Params(**raw).normalized()))


@pytest.mark.parametrize("text", ["Hello world!", "a b\tc", ""])
def test_generate_dummy_matches(text):
    got = tapi.generate_dummy(text, tapi.Params(sample_rate=16000))
    want = japi.generate_dummy(text, japi.Params(sample_rate=16000))
    assert got.sample_rate == want.sample_rate
    np.testing.assert_array_equal(got.samples, want.samples)


def test_timing_spans_match():
    ts, js = ttiming.Stats(), jtiming.Stats()
    for ms in (1.0, 2.5, 0.25):
        ts.record("x", ms)
        js.record("x", ms)
    assert ts.summary() == js.summary()
    with ttiming.span("y", stats=ts):
        pass
    assert ts.summary()["y"]["count"] == 1


# -- isolation -----------------------------------------------------------------


def _port_sources():
    pkg = os.path.join(REPO, "ptts_torch")
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_source_imports_the_jax_package():
    """AST scan: no ``import ptts_tpu``/``from ptts_tpu`` (nor jax, nor
    ml_dtypes, which the machine with the card lacks) anywhere in
    ptts_torch/**/*.py or chip_smoke.py, at any depth."""
    found = []
    sources = list(_port_sources())
    assert len(sources) > 30
    for path in sources:
        tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("ptts_tpu", "jax", "jaxlib", "ml_dtypes"):
                    found.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert not found, found


def test_fresh_process_imports_every_port_module_without_the_jax_package():
    """A fresh interpreter imports every ptts_torch module
    (pkgutil.walk_packages) and chip_smoke.py: no ptts_tpu*, jax* or
    ml_dtypes* module ends up in sys.modules."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})
import ptts_torch
names = [m.name for m in pkgutil.walk_packages(ptts_torch.__path__, "ptts_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.startswith(("ptts_tpu", "jax", "ml_dtypes")))
assert not bad, bad
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) > 30
