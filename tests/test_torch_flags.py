"""The port's kernel switches against the JAX package (tiny configs, CPU):
KernelFlags and flags_from_env, the engine's resolved impls, the blocked
decode attention and validate mode, the batcher's refusal of 'blocked', the
oracle variants of ops/rope and ops/conv, and utils/compile_cache.

Gates: single ops 1e-5 (atol and rtol, f32); whole generations 1e-4;
layer_impl values bit-equal (they run the same loop).
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import api as tapi  # noqa: E402
from ptts_torch import convert  # noqa: E402
from ptts_torch.config import KernelFlags  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.models import mimi as tmi  # noqa: E402
from ptts_torch.ops import attention as tatt  # noqa: E402
from ptts_torch.ops import conv as tconv  # noqa: E402
from ptts_torch.ops import rope as trope  # noqa: E402
from ptts_torch.runtime import engine as tengine  # noqa: E402
from ptts_torch.runtime.batching import ContinuousBatcher  # noqa: E402
from ptts_torch.utils import compile_cache  # noqa: E402
from ptts_tpu.config import KernelFlags as JFlags  # noqa: E402
from ptts_tpu.models import flowlm as jfl  # noqa: E402
from ptts_tpu.ops import attention as jatt  # noqa: E402
from ptts_tpu.ops import conv as jconv  # noqa: E402
from ptts_tpu.ops import rope as jrope  # noqa: E402
from ptts_tpu.runtime import engine as jengine  # noqa: E402

FC, MC = TINY_FLOWLM, TINY_MIMI
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP_TOL = 1e-5
GEN_TOL = 1e-4


def close(got, want, tol=OP_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


# -- KernelFlags and flags_from_env --------------------------------------------

# the JAX package's kernel values and the port's: the TPU's Pallas kernel is
# the port's CUDA kernel, its XLA path the port's plain version
PORT_VALUE = {"auto": "auto", "pallas": "kernel", "xla": "plain", "local": "plain"}


@pytest.mark.parametrize("env", [
    {},
    {"PTTS_PALLAS_PREFILL": "0"}, {"PTTS_PALLAS_PREFILL": "1"}, {"PTTS_PALLAS_PREFILL": "x"},
    {"PTTS_PALLAS_WINDOW": "0"}, {"PTTS_PALLAS_WINDOW": "1"},
    {"PTTS_DECODE_IMPL": "einsum"}, {"PTTS_DECODE_IMPL": "blocked"},
    {"PTTS_LAYER_IMPL": "scan"}, {"PTTS_LAYER_IMPL": "unroll"},
    {"PTTS_VALIDATE": "1"}, {"PTTS_VALIDATE": "0"}, {"PTTS_VALIDATE": "yes"},
    {"PTTS_DECODE_IMPL": "blocked", "PTTS_VALIDATE": "1", "PTTS_PALLAS_PREFILL": "0"},
])
def test_flags_from_env_matches_jax_field_by_field(monkeypatch, env):
    for name in ("PTTS_PALLAS_PREFILL", "PTTS_PALLAS_WINDOW", "PTTS_DECODE_IMPL",
                 "PTTS_LAYER_IMPL", "PTTS_VALIDATE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got, want = tengine.flags_from_env(), jengine.flags_from_env()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert got.decode_impl == want.decode_impl
    assert got.layer_impl == want.layer_impl
    assert got.validate == want.validate
    assert got.prefill_impl == PORT_VALUE[want.prefill_impl]
    assert got.window_impl == PORT_VALUE[want.window_impl]


def test_kernel_flags_defaults_match_jax():
    assert dataclasses.asdict(KernelFlags()) == dataclasses.asdict(JFlags())


@pytest.mark.parametrize("field,value", [("prefill_impl", "pallas"), ("window_impl", "xla"),
                                         ("decode_impl", "fused"), ("layer_impl", "loop")])
def test_unknown_flag_values_raise(field, value):
    with pytest.raises(ValueError, match=field):
        KernelFlags(**{field: value})


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path, _, _ = write_model_dir(tmp_path_factory.mktemp("flagsmodel"), seed=6)
    return path


@pytest.fixture(scope="module")
def ctx(model_dir):
    return tapi.Context(model_dir, flowlm_cfg=FC, mimi_cfg=MC, device="cpu")


@pytest.mark.parametrize("flags,env", [
    (KernelFlags(prefill_impl="kernel"), {}),
    (KernelFlags(window_impl="kernel"), {}),
    (None, {"PTTS_PALLAS_PREFILL": "1"}),
    (None, {"PTTS_PALLAS_WINDOW": "1"}),
])
def test_kernel_on_a_cpu_engine_raises(ctx, monkeypatch, flags, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tengine.TTSEngine(ctx, flags=flags)


@pytest.mark.parametrize("env,prefill,window", [
    ({}, "plain", "plain"),
    ({"PTTS_PALLAS_PREFILL": "0", "PTTS_PALLAS_WINDOW": "0"}, "plain", "plain"),
])
def test_cpu_engine_resolves_to_plain(ctx, monkeypatch, env, prefill, window):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    engine = tengine.TTSEngine(ctx)
    assert (engine.prefill_impl, engine.window_impl) == (prefill, window)


@pytest.mark.parametrize("device,choice,want", [
    ("cuda", "auto", "kernel"), ("cuda", "plain", "plain"), ("cuda", "kernel", "kernel"),
    ("cpu", "auto", "plain"), ("cpu", "plain", "plain"),
])
def test_resolve_impl_by_device(monkeypatch, device, choice, want):
    """Resolution only names the device (no card needed): auto follows it."""
    monkeypatch.delenv("PTTS_PALLAS_PREFILL", raising=False)
    monkeypatch.delenv("PTTS_PALLAS_WINDOW", raising=False)
    assert tfl.resolve_prefill_impl(choice, device) == want
    assert tmi.resolve_window_impl(choice, device) == want


def test_batcher_rejects_blocked_decode(ctx):
    """The 'blocked' decode attention reads [start, cursor] as one span:
    wrong once the decode ring wraps, so the batcher refuses it."""
    engine = ctx.engine
    orig = engine.flags
    engine.flags = dataclasses.replace(orig, decode_impl="blocked")
    try:
        with pytest.raises(tapi.PttsError, match="decode ring"):
            ContinuousBatcher(engine, slots=1, max_len=48, admit_chunk=1, prefix_budget=32)
    finally:
        engine.flags = orig


# -- the decode attentions -------------------------------------------------------


def decode_case(B, Tmax, H, D, prefix, start, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, D)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, Tmax, H, D)) * scale).astype(np.float32)
    v = rng.standard_normal((B, Tmax, H, D)).astype(np.float32)
    return q, k, v, np.asarray(prefix, np.int32), np.asarray(start, np.int32)


@pytest.mark.parametrize("B,Tmax,H,D,cursor,prefix,start,block_t", [
    (8, 128, 4, 64, 99, [5, 60, 64, 64, 1, 33, 64, 17], [64] * 8, 64),
    (8, 256, 2, 64, 193, [10, 64, 32, 5, 64, 1, 40, 64],
     [64, 64, 100, 130, 64, 190, 64, 100], 64),
    (4, 256, 2, 64, 63, [10, 20, 30, 40], [40] * 4, 64),
    (3, 100, 2, 8, 71, [9, 3, 12], [12, 12, 40], 128),   # block_t shrinks to 100
    (2, 90, 2, 8, 50, [7, 2], [30, 30], 64),             # 64 -> 45 divides 90
    (1, 17, 1, 4, 16, [4], [4], 5),                      # a prime Tmax: block 1
])
def test_decode_attention_blocked_matches_jax(B, Tmax, H, D, cursor, prefix, start, block_t):
    q, k, v, pl, st = decode_case(B, Tmax, H, D, prefix, start, seed=Tmax + cursor)
    want = jatt.decode_attention_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pl), jnp.asarray(st),
                                         jnp.asarray(cursor, jnp.int32), block_t=block_t)
    got = tatt.decode_attention_blocked(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), torch.from_numpy(pl),
                                        torch.from_numpy(st), cursor, block_t=block_t)
    close(got, want)


def test_decode_attention_blocked_reads_no_column_past_its_blocks():
    """NaN past the last block the cursor reaches changes nothing."""
    q, k, v, pl, st = decode_case(4, 256, 2, 64, [10, 20, 30, 40], [40] * 4, seed=2)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    clean = tatt.decode_attention_blocked(*args, torch.from_numpy(pl), torch.from_numpy(st),
                                          63, block_t=64)
    args[1][:, 64:] = float("nan")
    args[2][:, 64:] = float("nan")
    dirty = tatt.decode_attention_blocked(*args, torch.from_numpy(pl), torch.from_numpy(st),
                                          63, block_t=64)
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("B,Tmax,H,D,lengths,context", [
    (3, 16, 2, 8, [16, 1, 9], 0),
    (3, 16, 2, 8, [16, 1, 9], 5),
    (2, 40, 4, 16, [40, 23], 250),
])
def test_decode_attention_matches_jax(B, Tmax, H, D, lengths, context):
    q, k, v, _, _ = decode_case(B, Tmax, H, D, [0] * B, [0] * B, seed=Tmax + context)
    lens = np.asarray(lengths, np.int32)
    want = jatt.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens), context=context)
    got = tatt.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(lens), context=context)
    close(got, want)


@pytest.fixture(scope="module")
def flow():
    host = jfl.random_weights(FC, seed=3)
    rng = np.random.default_rng(4)
    B, T0, F = 2, 8, 6
    prefix = (rng.standard_normal((B, T0, FC.d_model)) * 0.1).astype(np.float32)
    lengths = np.asarray([8, 5], np.int32)
    noise = (rng.standard_normal((B, F, FC.latent_dim)) * 0.5).astype(np.float32)
    return host, prefix, lengths, noise


def port_generate(flow, flags, steps=1):
    host, prefix, lengths, noise = flow
    w = convert.flowlm_weights(host, FC)
    T0, F = prefix.shape[1], noise.shape[1]
    cache, x0 = tfl.prefill_init(w, torch.from_numpy(prefix), torch.from_numpy(lengths), FC,
                                 T0 + F)
    with torch.inference_mode():
        return tfl.generate_latents_while(w, cache, x0, torch.from_numpy(noise), FC,
                                          max_frames=F, num_steps=steps, eos_threshold=1e9,
                                          flags=flags)


def jax_generate(flow, flags, steps=1):
    host, prefix, lengths, noise = flow
    w = jfl.to_device(host, jnp.float32, FC)
    T0, F = prefix.shape[1], noise.shape[1]
    cache, x0 = jfl.prefill_init(w, jnp.asarray(prefix), jnp.asarray(lengths), FC, T0 + F)
    return jfl.generate_latents_while(w, cache, x0, jnp.asarray(noise), FC, max_frames=F,
                                      num_steps=steps, eos_threshold=1e9, eos_min_frames=1,
                                      eos_after=0, flags=flags)


def test_generation_blocked_equals_einsum_and_jax(flow):
    """Whole generation: 'blocked' == 'einsum' in the port, and the port's
    'blocked' == the JAX package's 'blocked' (after
    tests/test_decode_attention.py)."""
    einsum = port_generate(flow, KernelFlags(decode_impl="einsum"))
    blocked = port_generate(flow, KernelFlags(decode_impl="blocked"))
    want = jax_generate(flow, JFlags(decode_impl="blocked"))
    close(blocked.latents, einsum.latents, GEN_TOL)
    close(blocked.latents, want.latents, GEN_TOL)
    close(blocked.eos_logits, want.eos_logits, GEN_TOL)


def test_validate_prints_one_line_per_layer_and_frame(flow, capsys):
    """validate + blocked: the masked einsum's result, and one
    '[ptts] validate decode_attention maxdiff=' line per layer and frame."""
    plain = port_generate(flow, KernelFlags())
    capsys.readouterr()
    got = port_generate(flow, KernelFlags(decode_impl="blocked", validate=True))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[ptts] validate decode_attention maxdiff=")]
    assert torch.equal(got.latents, plain.latents)
    assert len(lines) == FC.num_layers * flow[3].shape[1]
    for ln in lines:
        diff, top = map(float, re.findall(r"=(\S+)", ln))
        assert diff <= OP_TOL * max(top, 1e-30)


def test_validate_is_silent_without_blocked(flow, capsys):
    port_generate(flow, KernelFlags(validate=True))
    assert "validate" not in capsys.readouterr().out


@pytest.mark.parametrize("steps", [1, 2])
def test_layer_impl_values_are_bit_equal(flow, steps):
    """scan, unroll and auto run the port's one layer loop: bit-equal."""
    runs = [port_generate(flow, KernelFlags(layer_impl=v), steps)
            for v in ("auto", "scan", "unroll")]
    for r in runs[1:]:
        assert torch.equal(r.latents, runs[0].latents)
        assert torch.equal(r.eos_logits, runs[0].eos_logits)


@pytest.mark.parametrize("impl", ["kernel", "plain", "auto"])
def test_prefill_attn_impls_agree_on_the_cpu(flow, impl):
    """On CPU tensors the kernel's wrapper computes the plain version: every
    attn_impl gives the same prefill."""
    host, prefix, lengths, _ = flow
    w = convert.flowlm_weights(host, FC)
    args = (w, torch.from_numpy(prefix), torch.from_numpy(lengths), FC)
    ref = tfl.prefill_kv(*args, attn_impl="plain")
    got = tfl.prefill_kv(*args, attn_impl=impl)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# -- oracle variants ---------------------------------------------------------------


@pytest.mark.parametrize("B,T,H,D", [(2, 5, 3, 8), (1, 7, 2, 64)])
def test_interleaved_rope_matches_jax(B, T, H, D):
    rng = np.random.default_rng(B * T)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, H, D)).astype(np.float32)
    pos = (np.arange(T)[None, :] + np.arange(B)[:, None] * 3).astype(np.int32)
    want = jrope.rope_rotate(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos))
    got = trope.rope_rotate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(pos))
    for g, w in zip(got, want):
        close(g, w)
    cos, sin = jrope.rope_cos_sin(jnp.asarray(pos), D)
    close(trope.apply_rope(torch.from_numpy(q[:, :, 0]), torch.from_numpy(np.array(cos)),
                           torch.from_numpy(np.array(sin))),
          jrope.apply_rope(jnp.asarray(q[:, :, 0]), cos, sin))


def test_interleaved_rope_equals_halves_after_the_permutation():
    """rope_rotate on the interleaved layout == rope_rotate_halves on the
    permuted one (the identity the load-time permutation relies on)."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 6, 2, 8)).astype(np.float32))
    pos = torch.arange(6)[None, :]
    perm = torch.from_numpy(trope.rope_head_permutation(8))
    inter, _ = trope.rope_rotate(q, q, pos)
    halves, _ = trope.rope_rotate_halves(q[..., perm], q[..., perm], pos)
    close(inter[..., perm], halves)


@pytest.mark.parametrize("Cin,Cout,groups,stride,T", [
    (4, 6, 1, 3, 5), (8, 8, 8, 2, 7), (6, 4, 2, 4, 3), (3, 5, 1, 1, 4),
])
def test_convtr1d_causal_matches_jax(Cin, Cout, groups, stride, T):
    rng = np.random.default_rng(Cin * T + stride)
    w_torch = rng.standard_normal((Cin, Cout // groups, 2 * stride)).astype(np.float32)
    bias = rng.standard_normal(Cout).astype(np.float32)
    x = rng.standard_normal((2, T, Cin)).astype(np.float32)
    kernel = tconv.prepare_convtr_kernel(w_torch, groups)
    np.testing.assert_array_equal(kernel, jconv.prepare_convtr_kernel(w_torch, groups))
    want = jconv.convtr1d_causal(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                                 stride=stride, groups=groups)
    got = tconv.convtr1d_causal(torch.from_numpy(x), torch.from_numpy(kernel),
                                torch.from_numpy(bias), stride=stride, groups=groups)
    assert tuple(got.shape) == (2, T * stride, Cout)
    close(got, want)


@pytest.mark.parametrize("groups", [1, "depthwise"])
def test_convtr1d_causal_equals_convtr1d_2s(groups):
    """The oracle and the model's k = 2s form agree (the Mimi identity)."""
    rng = np.random.default_rng(5)
    C, s, T = 6, 3, 5
    g = C if groups == "depthwise" else 1
    w_torch = rng.standard_normal((C, C // g, 2 * s)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32))
    w1, w2 = tconv.prepare_convtr_halves(w_torch, g)
    want = tconv.convtr1d_2s(x, torch.from_numpy(w1), torch.from_numpy(w2), None, stride=s,
                             depthwise=g > 1)
    got = tconv.convtr1d_causal(x, torch.from_numpy(tconv.prepare_convtr_kernel(w_torch, g)),
                                None, stride=s, groups=g)
    close(got, want)


# -- utils/compile_cache -------------------------------------------------------------


def run_fresh(code: str, env: dict) -> subprocess.CompletedProcess:
    full = {**os.environ, "JAX_PLATFORMS": "cpu", **env}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=full, cwd=REPO)


CACHE_PROBE = """
import os, sys
sys.path.insert(0, {repo!r})
from ptts_torch import native
from ptts_torch.utils import compile_cache
persistent = compile_cache.enable_persistent_cache()
print(persistent, compile_cache.build_dir())
print(native.available(), sorted(os.listdir(compile_cache.build_dir())))
"""


def test_compile_cache_builds_the_host_library_where_asked(tmp_path):
    """PTTS_COMPILE_CACHE=<dir>: the host library (g++) builds into <dir>."""
    out = tmp_path / "builds"
    proc = run_fresh(CACHE_PROBE.format(repo=REPO), {"PTTS_COMPILE_CACHE": str(out)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    first, second = proc.stdout.splitlines()[-2:]
    assert first == f"True {out}"
    assert second.startswith("True") and "libptts_host_" in second
    assert any(f.startswith("libptts_host_") and f.endswith(".so") for f in os.listdir(out))


def test_compile_cache_zero_builds_in_a_temporary_directory(tmp_path):
    """PTTS_COMPILE_CACHE=0: a directory of this process, gone at exit."""
    proc = run_fresh(CACHE_PROBE.format(repo=REPO), {"PTTS_COMPILE_CACHE": "0"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    first, second = proc.stdout.splitlines()[-2:]
    persistent, where = first.split(" ", 1)
    assert persistent == "False" and "ptts_build_" in where
    assert second.startswith("True") and "libptts_host_" in second
    assert not os.path.exists(where)


def test_compile_cache_default_and_explicit_dir(tmp_path, monkeypatch):
    """Default: ptts_torch/_build/ (.gitignore lists it); an explicit
    directory replaces the choice; the choice is idempotent."""
    monkeypatch.delenv("PTTS_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(compile_cache, "_dir", None)
    monkeypatch.setattr(compile_cache, "_persistent", True)
    assert compile_cache.enable_persistent_cache() is True
    assert compile_cache.build_dir() == compile_cache.DEFAULT_DIR
    assert compile_cache.DEFAULT_DIR == pathlib.Path(REPO, "ptts_torch", "_build")
    assert "ptts_torch/_build/" in open(os.path.join(REPO, ".gitignore")).read()
    monkeypatch.setenv("PTTS_COMPILE_CACHE", str(tmp_path))
    assert compile_cache.build_dir() == compile_cache.DEFAULT_DIR  # already chosen
    assert compile_cache.enable_persistent_cache(str(tmp_path / "x")) is True
    assert compile_cache.build_dir() == tmp_path / "x"
