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
                         cursor=torch.tensor(cursor, dtype=torch.int32), t0=t0)
        assert int(tc.write_col) == int(jc.write_col)
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


def test_make_cache_and_prefill_match_prefill_init(flow_weights):
    """Prefill into an empty cache == prefill_init, in both packages."""
    _, jw, tw = flow_weights
    rng = np.random.default_rng(15)
    B, T, Tmax = 2, 7, 11
    x = (rng.standard_normal((B, T, FC.d_model)) * 0.5).astype(np.float32)
    lens = np.array([7, 4], np.int32)
    jc, jlast = jfl.prefill(jw, jfl.make_cache(FC, B, Tmax), jnp.asarray(x), jnp.asarray(lens), FC)
    tc, tlast = tfl.prefill(tw, tfl.make_cache(FC, B, Tmax), torch.from_numpy(x),
                            torch.from_numpy(lens), FC)
    ic, ilast = tfl.prefill_init(tw, torch.from_numpy(x), torch.from_numpy(lens), FC, Tmax)
    close(tlast, jlast)
    close(tc.k, jc.k)
    close(tc.v, jc.v)
    np.testing.assert_array_equal(tc.k.numpy(), ic.k.numpy())
    np.testing.assert_array_equal(tlast.numpy(), ilast.numpy())
    for name in ("prefix_len", "start"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    assert (tc.cursor, tc.t0) == (int(jc.cursor), int(jc.t0)) == (T, T)


def test_lsd_decode_ragged_matches_jax_and_lsd_decode(flow_weights):
    """Per-stream step counts from a [B, S_max, fd] table: against JAX, and
    each stream against lsd_decode at its own step count (1e-6)."""
    _, jw, tw = flow_weights
    rng = np.random.default_rng(16)
    B, S = 3, 4
    steps = np.array([1, 4, 3], np.int32)
    cond = rng.standard_normal((B, FC.d_model)).astype(np.float32)
    noise = rng.standard_normal((B, FC.latent_dim)).astype(np.float32)
    tabs = np.zeros((B, S, FC.flow_dim), np.float32)
    for b, n in enumerate(steps):
        tabs[b, :n] = tfl.lsd_time_embeds(tw, int(n), FC).numpy()
    got = tfl.lsd_decode_ragged(tw, torch.from_numpy(cond), torch.from_numpy(tabs),
                                torch.from_numpy(steps), torch.from_numpy(noise), FC)
    want = jfl.lsd_decode_ragged(jw, jnp.asarray(cond), jnp.asarray(tabs), jnp.asarray(steps),
                                 jnp.asarray(noise), FC)
    for g, w in zip(got, want):
        close(g, w)
    for b, n in enumerate(steps):
        one, first = tfl.lsd_decode(tw, torch.from_numpy(cond[b : b + 1]),
                                    torch.from_numpy(tabs[b, :n]), torch.from_numpy(noise[b : b + 1]),
                                    FC)
        close(got[0][b : b + 1], one, 1e-6)
        close(got[1][b : b + 1], first, 1e-6)


def _prefilled(tw, jw, rng, B, T, F):
    x = (rng.standard_normal((B, T, FC.d_model)) * 0.5).astype(np.float32)
    lens = np.array([T, 2, 4][:B], np.int32)
    jc, jx0 = jfl.prefill_init(jw, jnp.asarray(x), jnp.asarray(lens), FC, T + F)
    tc, tx0 = tfl.prefill_init(tw, torch.from_numpy(x), torch.from_numpy(lens), FC, T + F)
    return (jc, jx0), (tc, tx0)


def test_generate_latents_matches_jax(flow_weights):
    """The fixed-length loop: every frame runs; EOS state and taps as JAX."""
    _, jw, tw = flow_weights
    rng = np.random.default_rng(17)
    B, T, F = 3, 6, 5
    (jc, jx0), (tc, tx0) = _prefilled(tw, jw, rng, B, T, F)
    noise = rng.standard_normal((B, F, FC.latent_dim)).astype(np.float32)
    eos_after = np.array([0, 1, 2], np.int32)
    kw = dict(max_frames=F, num_steps=2, eos_threshold=-0.5, eos_min_frames=2)
    want = jfl.generate_latents(jw, jc, jx0, jnp.asarray(noise), FC, eos_after=eos_after, **kw)
    got = tfl.generate_latents(tw, tc, tx0, torch.from_numpy(noise), FC, eos_after=eos_after, **kw)
    for name in ("frames_used", "eos_step", "done"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    for name in ("latents", "eos_logits", "first_cond", "first_flow", "x"):
        close(getattr(got, name), getattr(want, name))
    assert got.cache.cursor == T + F
    assert (got.latents[:, -1] != 0).all()  # no early exit: the last frame ran


def test_generate_latents_resumes(flow_weights):
    """Two resumed calls (3 + 4 frames) equal one 7-frame call."""
    _, jw, tw = flow_weights
    rng = np.random.default_rng(18)
    B, T, F = 2, 5, 7
    _, (tc, tx0) = _prefilled(tw, jw, rng, B, T, F)
    _, (tc2, _) = _prefilled(tw, jw, np.random.default_rng(18), B, T, F)
    noise = rng.standard_normal((B, F, FC.latent_dim)).astype(np.float32)
    kw = dict(num_steps=1, eos_enabled=True, eos_threshold=-0.3, eos_min_frames=1,
              eos_after=np.array([1, 2], np.int32))
    one = tfl.generate_latents(tw, tc, tx0, torch.from_numpy(noise), FC, max_frames=F, **kw)
    a = tfl.generate_latents(tw, tc2, tx0, torch.from_numpy(noise[:, :3]), FC, max_frames=3, **kw)
    b = tfl.generate_latents(tw, a.cache, a.x, torch.from_numpy(noise[:, 3:]), FC, max_frames=4,
                             frame0=3, eos_step0=a.eos_step, done0=a.done, used0=a.frames_used,
                             **kw)
    close(torch.cat([a.latents, b.latents], 1), one.latents, 1e-6)
    close(torch.cat([a.eos_logits, b.eos_logits], 1), one.eos_logits, 1e-6)
    for name in ("frames_used", "eos_step", "done"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), getattr(one, name).numpy())
    close(a.first_cond, one.first_cond, 0)
    assert (b.first_cond == 0).all()  # the taps belong to frame 0
    assert b.cache.cursor == one.cache.cursor


def test_forward_next_matches_cached_loop_and_jax(flow_weights):
    """The uncached O(T^2) forward over [prompt, input_linear(latents)]
    reproduces each frame of the KV-cached loop."""
    _, jw, tw = flow_weights
    rng = np.random.default_rng(19)
    B, T, F = 2, 5, 3
    x = (rng.standard_normal((B, T, FC.d_model)) * 0.5).astype(np.float32)
    lens = np.full(B, T, np.int32)  # unpadded: the sequence grows by appending
    noise = rng.standard_normal((B, F, FC.latent_dim)).astype(np.float32)
    tc, tx0 = tfl.prefill_init(tw, torch.from_numpy(x), torch.from_numpy(lens), FC, T + F)
    res = tfl.generate_latents(tw, tc, tx0, torch.from_numpy(noise), FC, max_frames=F,
                               num_steps=2, eos_enabled=False)
    seq = torch.from_numpy(x)
    for i in range(F):
        n = torch.full((B,), T + i, dtype=torch.int32)
        latent, eos = tfl.forward_next(tw, seq, n, torch.from_numpy(noise[:, i]), FC, 2)
        jlat, jeos = jfl.forward_next(jw, jnp.asarray(seq.numpy()), jnp.asarray(n.numpy()),
                                      jnp.asarray(noise[:, i]), FC, 2)
        close(latent, jlat)
        close(eos, jeos)
        close(latent, res.latents[:, i])
        close(eos, res.eos_logits[:, i])
        nxt = tfl._linear(tw.input_linear, None, res.latents[:, i])
        seq = torch.cat([seq, nxt[:, None]], 1)


def test_embed_tokens_clamps_like_jax(flow_weights):
    _, jw, tw = flow_weights
    ids = np.array([[0, 3, FC.vocab, FC.vocab + 1, -1, 99]], np.int64)
    got = tfl.embed_tokens(tw, torch.from_numpy(ids), FC)
    want = jfl.embed_tokens(jw, jnp.asarray(ids.astype(np.int32)), FC)
    close(got, want, 0)
    np.testing.assert_array_equal(got[0, 3:].numpy(), np.repeat(tw.embed[:1].numpy(), 3, 0))
