"""The fused RoPE + attention wrappers of ptts_torch (ops/cuda/fused_attention)
against the Pallas kernels they replace, run in interpret mode on the CPU as
tests/test_pallas_fused.py runs them.

On a CPU tensor a wrapper computes its plain PyTorch version, so these tests
hold the plain versions to the Pallas kernels (5e-5, the tolerance of
test_pallas_fused.py), and the model integration points to their JAX
"pallas" paths. The CUDA kernels themselves are held to the plain versions
on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from helpers import TINY_FLOWLM, TINY_MIMI  # noqa: E402
from ptts_torch import convert  # noqa: E402
from ptts_torch.ops.cuda import fused_attention as tfa  # noqa: E402
from ptts_tpu.ops.pallas import fused_attention as jfa  # noqa: E402

TOL = 5e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _qkv(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 3 * H * D)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("lengths", [[5, 33, 64, 17], [64, 64, 64, 64]])
def test_causal_attention_qkv_matches_pallas(lengths):
    B, T, H, D = 4, 64, 2, 64
    qkv = _qkv(4, B, T, H, D)
    lens = np.asarray(lengths, np.int32)
    got, k_rot = tfa.causal_attention_qkv(torch.from_numpy(qkv), torch.from_numpy(lens),
                                          num_heads=H, head_dim=D)
    with pltpu.force_tpu_interpret_mode():
        want, want_k = jfa.causal_attention_qkv(jnp.asarray(qkv), jnp.asarray(lens),
                                                num_heads=H, head_dim=D, block_b=2)
    for b, n in enumerate(lens):
        close(got[b, :n], np.asarray(want)[b, :n])
    # the rotated K feeds the cache at every position, padding included
    close(k_rot, want_k)


def test_causal_attention_qkv_masks_padding_garbage():
    """K/V rows past a stream's length, poisoned with 1e20, must not reach
    the attention of its valid rows."""
    B, T, H, D = 2, 32, 1, 64
    qkv = _qkv(1, B, T, H, D)
    lens = np.array([7, 20], np.int32)
    dirty = qkv.copy()
    for b, n in enumerate(lens):
        dirty[b, n:, H * D:] = 1e20
    got, _ = tfa.causal_attention_qkv(torch.from_numpy(dirty), torch.from_numpy(lens),
                                      num_heads=H, head_dim=D)
    with pltpu.force_tpu_interpret_mode():
        want, _ = jfa.causal_attention_qkv(jnp.asarray(dirty), jnp.asarray(lens),
                                           num_heads=H, head_dim=D, block_b=2)
    for b, n in enumerate(lens):
        assert torch.isfinite(got[b]).all()
        close(got[b, :n], np.asarray(want)[b, :n])


@pytest.mark.parametrize(
    "B,T,context,block",
    # T > 256 takes the plain version's block-local path
    [(2, 40, 5, 8), (3, 37, 9, 16), (4, 16, 17, 16), (2, 70, 9, 16), (1, 300, 9, 128)],
)
def test_window_attention_qkv_matches_pallas(B, T, context, block):
    H, D = 2, 64
    qkv = _qkv(2, B, T, H, D)
    got = tfa.window_attention_qkv(torch.from_numpy(qkv), num_heads=H, head_dim=D,
                                   context=context)
    with pltpu.force_tpu_interpret_mode():
        want = jfa.window_attention_qkv(jnp.asarray(qkv), num_heads=H, head_dim=D,
                                        context=context, block=block, block_b=1)
    close(got, want)


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device is refused, and a CPU call launches no kernel."""
    before = (tfa.causal_attention_qkv.launches, tfa.window_attention_qkv.launches)
    qkv = torch.zeros(1, 8, 3 * 64, device="meta")
    with pytest.raises(ValueError):
        tfa.window_attention_qkv(qkv, num_heads=1, head_dim=64, context=4)
    with pytest.raises(ValueError):
        tfa.causal_attention_qkv(qkv, torch.ones(1, dtype=torch.int32), num_heads=1,
                                 head_dim=64)
    tfa.window_attention_qkv(torch.zeros(1, 8, 3 * 64), num_heads=1, head_dim=64, context=4)
    assert (tfa.causal_attention_qkv.launches, tfa.window_attention_qkv.launches) == before


def test_prefill_kv_matches_jax_pallas():
    """flowlm.prefill_kv (plain causal version on the CPU) == the JAX
    prefill_kv(..., "pallas") on the cache K/V at every position and on the
    last hidden state."""
    from ptts_torch.models import flowlm as tfl
    from ptts_tpu.models import flowlm as jfl

    cfg = TINY_FLOWLM
    host = jfl.random_weights(cfg, seed=7)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((4, 16, cfg.d_model)) * 0.1).astype(np.float32)
    lens = np.array([16, 3, 9, 16], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jfl.prefill_kv(jfl.to_device(host, jnp.float32, cfg), jnp.asarray(x),
                              jnp.asarray(lens), cfg, "pallas")
    got = tfl.prefill_kv(convert.flowlm_weights(host, cfg), torch.from_numpy(x),
                         torch.from_numpy(lens), cfg)
    for g, w in zip(got, want):
        close(g, w, 1e-4)


def test_mimi_transformer_matches_jax_pallas():
    from ptts_torch.models import mimi as tmi
    from ptts_tpu.models import mimi as jmi

    cfg = TINY_MIMI
    host = jmi.random_weights(cfg, seed=5, scale=0.3)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 40, cfg.d_model)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jmi.transformer(jmi.to_device(host, cfg=cfg)["transformer"], jnp.asarray(x),
                               cfg, window_impl="pallas")
    got = tmi.transformer(convert.mimi_weights(host, cfg).transformer, torch.from_numpy(x), cfg)
    close(got, want, 2e-4)
