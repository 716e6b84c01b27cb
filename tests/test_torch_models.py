"""ptts_torch models against ptts_tpu's on identical weights (tiny configs,
CPU, f32): the numpy loaders leaf for leaf, then convert.* of the JAX
random_weights through prefill, decode steps, the flow net, the frame loop
and the Mimi decode (1e-4)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import TINY_FLOWLM, TINY_MIMI, write_model_dir  # noqa: E402
from ptts_torch import convert  # noqa: E402
from ptts_torch.models import flowlm as tfl  # noqa: E402
from ptts_torch.models import mimi as tmi  # noqa: E402
from ptts_tpu.io.safetensors import SafetensorsFile  # noqa: E402
from ptts_tpu.models import flowlm as jfl  # noqa: E402
from ptts_tpu.models import mimi as jmi  # noqa: E402

FC, MC = TINY_FLOWLM, TINY_MIMI
TOL = 1e-4


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("prefixed,bf16", [(False, False), (True, True)])
def test_loaders_match_jax_leaf_for_leaf(tmp_path, prefixed, bf16):
    path, _, _ = write_model_dir(tmp_path, seed=4, prefixed=prefixed, bf16=bf16)
    with SafetensorsFile(f"{path}/tts_b6369a24.safetensors") as st:
        pairs = [(tfl.load_weights(st, FC), jfl.load_weights(st, FC)),
                 (tmi.load_weights(st, MC), jmi.load_weights(st, MC))]
        for got, want in pairs:
            got, want = dict(_flat(got)), dict(_flat(want))
            assert got.keys() == want.keys()
            for name, w in want.items():
                g = got[name]
                if w is None or isinstance(w, int):
                    assert g == w, name
                else:
                    assert g.dtype == np.float32 and g.shape == np.shape(w), name
                    np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def flow_weights():
    host = jfl.random_weights(FC, seed=3, scale=0.3)
    return host, jfl.to_device(host, jnp.float32, FC), convert.flowlm_weights(host, FC)


def test_prefill_and_decode_steps_match_jax(flow_weights):
    _, jw, tw = flow_weights
    rng = np.random.default_rng(11)
    B, T, extra = 3, 8, 4
    x = (rng.standard_normal((B, T, FC.d_model)) * 0.5).astype(np.float32)
    lens = np.array([8, 3, 5], np.int32)
    jc, jlast = jfl.prefill_init(jw, jnp.asarray(x), jnp.asarray(lens), FC, T + extra)
    tc, tlast = tfl.prefill_init(tw, torch.from_numpy(x), torch.from_numpy(lens), FC, T + extra)
    close(tlast, jlast)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    for i in range(extra):
        step = (rng.standard_normal((B, FC.d_model)) * 0.5).astype(np.float32)
        jc, jx = jfl.decode_step(jw, jc, jnp.asarray(step), FC)
        tc, tx = tfl.decode_step(tw, tc, torch.from_numpy(step), FC)
        close(tx, jx)
    close(tc.k, jc.k)
    assert tc.cursor == int(jc.cursor)


def test_kv_cache_ring_mask_matches_jax():
    """write_col / valid_mask, including a wrapped decode ring."""
    L, B, Tmax, t0 = 1, 3, 10, 4
    prefix = np.array([4, 2, 3], np.int32)
    start = np.array([4, 6, 9], np.int32)
    for cursor in (4, 7, 9, 12, 15):
        jc = jfl.KVCache(k=jnp.zeros((L, B, Tmax, 1, 2)), v=jnp.zeros((L, B, Tmax, 1, 2)),
                         prefix_len=jnp.asarray(prefix), start=jnp.asarray(start),
                         cursor=jnp.asarray(cursor), t0=jnp.asarray(t0))
        tc = tfl.KVCache(k=torch.zeros(L, B, Tmax, 1, 2), v=torch.zeros(L, B, Tmax, 1, 2),
                         prefix_len=torch.from_numpy(prefix), start=torch.from_numpy(start),
                         cursor=cursor, t0=t0)
        assert tc.write_col == int(jc.write_col)
        for through in (True, False):
            np.testing.assert_array_equal(tc.valid_mask(through).numpy(),
                                          np.asarray(jc.valid_mask(through)))
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_flow_net_and_lsd_decode_match_jax(flow_weights):
    _, jw, tw = flow_weights
    rng = np.random.default_rng(12)
    B = 3
    cond = rng.standard_normal((B, FC.d_model)).astype(np.float32)
    noise = rng.standard_normal((B, FC.latent_dim)).astype(np.float32)
    jte = jfl.lsd_time_embeds(jw, 3, FC)
    tte = tfl.lsd_time_embeds(tw, 3, FC)
    close(tte, jte)
    cond_emb = (rng.standard_normal((B, FC.flow_dim))).astype(np.float32)
    close(tfl.flow_net(tw, torch.from_numpy(cond_emb), tte[1], torch.from_numpy(noise), FC),
          jfl.flow_net(jw, jnp.asarray(cond_emb), jte[1], jnp.asarray(noise), FC))
    for got, want in zip(tfl.lsd_decode(tw, torch.from_numpy(cond), tte, torch.from_numpy(noise), FC),
                         jfl.lsd_decode(jw, jnp.asarray(cond), jte, jnp.asarray(noise), FC)):
        close(got, want)


def test_generate_latents_while_matches_jax(flow_weights):
    """EOS bookkeeping, per-stream budgets and the parity taps."""
    _, jw, tw = flow_weights
    rng = np.random.default_rng(13)
    B, T, F = 3, 6, 8
    x = (rng.standard_normal((B, T, FC.d_model)) * 0.5).astype(np.float32)
    lens = np.array([6, 2, 4], np.int32)
    noise = rng.standard_normal((B, F, FC.latent_dim)).astype(np.float32)
    budgets = np.array([8, 3, 8], np.int32)
    eos_after = np.array([1, 0, 2], np.int32)
    jc, jx0 = jfl.prefill_init(jw, jnp.asarray(x), jnp.asarray(lens), FC, T + F)
    tc, tx0 = tfl.prefill_init(tw, torch.from_numpy(x), torch.from_numpy(lens), FC, T + F)
    # at this threshold streams 0 and 2 hit EOS at frame 1; stream 1 runs
    # into its 3-frame budget before its EOS at frame 3
    kw = dict(max_frames=F, num_steps=2, eos_threshold=-0.5, eos_min_frames=2)
    want = jfl.generate_latents_while(jw, jc, jx0, jnp.asarray(noise), FC, eos_after=eos_after,
                                      max_frames_per_stream=jnp.asarray(budgets), **kw)
    got = tfl.generate_latents_while(tw, tc, tx0, torch.from_numpy(noise), FC,
                                     eos_after=eos_after,
                                     max_frames_per_stream=torch.from_numpy(budgets), **kw)
    np.testing.assert_array_equal(got.frames_used.numpy(), np.asarray(want.frames_used))
    np.testing.assert_array_equal(got.eos_step.numpy(), np.asarray(want.eos_step))
    assert got.eos_step.tolist() == [1, 3, 1] and got.frames_used.tolist() == [3, 3, 4]
    for name in ("latents", "eos_logits", "first_cond", "first_flow"):
        close(getattr(got, name), getattr(want, name))
    close(tfl.scale_latents(tw, got.latents), jfl.scale_latents(jw, want.latents))


def test_mimi_decode_matches_jax():
    host = jmi.random_weights(MC, seed=2, scale=0.3)
    rng = np.random.default_rng(14)
    lat = rng.standard_normal((2, 7, MC.latent_dim)).astype(np.float32)
    want = jmi.decode(jmi.to_device(host, cfg=MC), jnp.asarray(lat), MC, window_impl="local")
    got = tmi.decode(convert.mimi_weights(host, MC), torch.from_numpy(lat), MC)
    assert got.shape == (2, 7 * MC.frame_samples)
    close(got, want)


def test_convert_applies_rope_permutation_once(flow_weights):
    host, _, tw = flow_weights
    from ptts_torch.ops.rope import permute_qk_rows_for_rope

    np.testing.assert_array_equal(
        tw.in_proj.numpy(), permute_qk_rows_for_rope(host["in_proj"], FC.num_heads, FC.head_dim))
    assert host["in_proj"].shape == tw.in_proj.shape  # the host dict is not modified
    bf = convert.flowlm_weights(host, FC, dtype=torch.bfloat16)
    assert bf.flow.res.ada_w.dtype == torch.bfloat16 and bf.flow.time.freqs is not None
