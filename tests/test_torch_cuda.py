"""The hand-written CUDA kernels of ptts_torch on the card.

Every test here needs a CUDA device and skips without one. The machine with
the card has no jax, and tests/conftest.py imports it, so run this file
there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Gates (max error relative to the largest reference value): 1e-4 in f32,
5e-2 in bf16 for a kernel against its plain version on the same inputs;
1e-3 for the engine and the streaming session on the card against the same
on the CPU; bit-equal for a loop replayed as a CUDA graph against the same
loop run eagerly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ptts_torch import api, synth  # noqa: E402
from ptts_torch.config import FlowLMConfig, MimiConfig  # noqa: E402
from ptts_torch.ops.cuda import fused_attention as fa  # noqa: E402
from ptts_torch.runtime.streaming import StreamingSession, fused_stream_step  # noqa: E402

pytestmark = pytest.mark.cuda
GATES = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def qkv_on(dev, dtype, B, T, H, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 3 * H * 64)).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,lengths", [(64, [64, 1, 33, 7]), (128, [128, 65, 64, 100]),
                                       (100, [100, 99, 1, 64]), (37, [37, 20, 1, 36])])
def test_causal_kernel_matches_plain(dev, dtype, T, lengths):
    H = 16
    qkv = qkv_on(dev, dtype, len(lengths), T, H, seed=T)
    # poison the K/V rows past each length: the kernel must not read them
    for b, n in enumerate(lengths):
        qkv[b, n:, H * 64:] = 1e20
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = fa.causal_attention_qkv.launches
    got, k_rot = fa.causal_attention_qkv(qkv, lens, num_heads=H, head_dim=64)
    want, want_k = fa.causal_attention_qkv_plain(qkv, lens, num_heads=H, head_dim=64)
    assert fa.causal_attention_qkv.launches == before + 1
    for b, n in enumerate(lengths):
        assert torch.isfinite(got[b, :n]).all()
        assert rel(got[b, :n], want[b, :n]) <= GATES[dtype]
    assert rel(k_rot, want_k) <= GATES[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [64, 128])
def test_causal_kernel_at_the_admission_shape(dev, dtype, T):
    """B1 as serving admission calls it: [admit_chunk = 8, prefix_budget,
    3 * 1024] with the group's padded entries at length 1."""
    lengths = [T, 1, 1, T // 2 + 3, 1, 17, T - 5, 1]
    H = 16
    qkv = qkv_on(dev, dtype, len(lengths), T, H, seed=1000 + T)
    for b, n in enumerate(lengths):
        qkv[b, n:, H * 64:] = 1e20
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got, k_rot = fa.causal_attention_qkv(qkv, lens, num_heads=H, head_dim=64)
    want, want_k = fa.causal_attention_qkv_plain(qkv, lens, num_heads=H, head_dim=64)
    for b, n in enumerate(lengths):
        assert torch.isfinite(got[b, :n]).all()
        assert rel(got[b, :n], want[b, :n]) <= GATES[dtype]
    assert rel(k_rot, want_k) <= GATES[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,context", [(2, 1024, 250), (2, 800, 250), (1, 37, 250),
                                         (3, 300, 5), (1, 256, 64)])
def test_window_kernel_matches_plain(dev, dtype, B, T, context):
    qkv = qkv_on(dev, dtype, B, T, 8, seed=T + context)
    got = fa.window_attention_qkv(qkv, num_heads=8, head_dim=64, context=context)
    want = fa.window_attention_qkv_plain(qkv, num_heads=8, head_dim=64, context=context)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= GATES[dtype]


def grid_lengths(B, T):
    """Ragged lengths with 0, 1 and T among them (B = 1: T)."""
    return [T, 0, 1, T // 2, max(T - 1, 0), 1, T, min(3, T)][:B]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 37, 64, 100, 127, 128])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_causal_kernel_grid_with_nan_past_lengths(dev, dtype, T, B):
    """B1 over the tile edges (T = 1, 63/64/65-row tails, 127/128) at every
    batch the main path uses, 32- and 64-row query tiles alike; K/V rows at
    or past lengths[b] hold NaN, which the kernel must never read: every
    output row stays finite, and rows below the length (and the rotated K of
    every finite row) are within the gates of the plain version, run on the
    same projection with those rows zeroed (its p.V product would carry the
    NaN through p = 0)."""
    H = 16
    lengths = grid_lengths(B, T)
    clean = qkv_on(dev, dtype, B, T, H, seed=17 * T + B)
    qkv = clean.clone()
    for b, n in enumerate(lengths):
        clean[b, n:, H * 64:] = 0
        qkv[b, n:, H * 64:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got, k_rot = fa.causal_attention_qkv(qkv, lens, num_heads=H, head_dim=64)
    want, want_k = fa.causal_attention_qkv_plain(clean, lens, num_heads=H, head_dim=64)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    for b, n in enumerate(lengths):
        if n:
            assert rel(got[b, :n], want[b, :n]) <= GATES[dtype], (b, n)
            assert rel(k_rot[b, :n], want_k[b, :n]) <= GATES[dtype], (b, n)
        assert torch.isnan(k_rot[b, n:]).any(dim=-1).all()  # every position written


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 63, 65, 800, 1024])
@pytest.mark.parametrize("context", [250, 17])
def test_window_kernel_grid(dev, dtype, T, context):
    qkv = qkv_on(dev, dtype, 2, T, 8, seed=3 * T + context)
    got = fa.window_attention_qkv(qkv, num_heads=8, head_dim=64, context=context)
    want = fa.window_attention_qkv_plain(qkv, num_heads=8, head_dim=64, context=context)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel(got, want) <= GATES[dtype]


def test_shared_memory_limit_raised_once(dev):
    """cudaFuncSetAttribute runs once per kernel and device: a second round
    of launches at the same shapes (and at others) adds no call."""
    def round_():
        for dtype in (torch.float32, torch.bfloat16):
            for B, T in ((8, 128), (1, 14)):  # 64- and 32-row query tiles
                qkv = qkv_on(dev, dtype, B, T, 16, seed=B)
                lens = torch.full((B,), T, dtype=torch.int32, device=dev)
                fa.causal_attention_qkv(qkv, lens, num_heads=16, head_dim=64)
            for B, T in ((2, 1024), (1, 64)):
                fa.window_attention_qkv(qkv_on(dev, dtype, B, T, 8, seed=T), num_heads=8,
                                        head_dim=64, context=250)
        torch.cuda.synchronize()

    round_()
    first = fa.attribute_calls()
    assert first >= 1
    round_()
    assert fa.attribute_calls() == first
    fa.causal_attention_qkv(qkv_on(dev, torch.float32, 3, 77, 16, seed=0),
                            torch.full((3,), 50, dtype=torch.int32, device=dev),
                            num_heads=16, head_dim=64)
    assert fa.attribute_calls() == first


def test_kernels_refuse_what_they_cannot_take(dev):
    qkv = qkv_on(dev, torch.float32, 2, 64, 2, seed=0)
    lens = torch.tensor([64, 3], dtype=torch.int32)
    with pytest.raises(ValueError):  # lengths on the host
        fa.causal_attention_qkv(qkv, lens, num_heads=2, head_dim=64)
    with pytest.raises(ValueError):  # not contiguous
        fa.window_attention_qkv(qkv.transpose(0, 1), num_heads=2, head_dim=64, context=5)
    with pytest.raises(ValueError):  # head dim the kernels are not built for
        fa.window_attention_qkv(qkv, num_heads=4, head_dim=32, context=5)
    with pytest.raises(TypeError):
        fa.window_attention_qkv(qkv.half(), num_heads=2, head_dim=64, context=5)


def test_engine_on_card_matches_cpu(dev, tmp_path):
    """A small model with the kernels' head dim: the f32 engine on the card
    (kernels) against the same engine on the CPU (plain versions)."""
    fc = FlowLMConfig(vocab=60, text_dim=128, d_model=128, num_heads=2, head_dim=64,
                      num_layers=2, hidden=256, latent_dim=8, flow_dim=32, flow_depth=2,
                      time_freqs=8)
    mc = MimiConfig(latent_dim=8, d_model=128, num_heads=2, head_dim=64, num_layers=1,
                    hidden=256, n_filters=4, ratios=(3, 2))
    path = synth.write_model_dir(str(tmp_path), fc, mc, seed=2, scale=0.1)
    p = api.Params(seed=4, num_frames=5, eos_enabled=False, num_steps=2)
    outs = []
    for device in ("cpu", "cuda"):
        ctx = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device=device)
        outs.append(ctx.engine.generate_full("Hello world!", params=p))
    cpu, gpu = outs
    assert cpu.frames_used == gpu.frames_used == 5
    assert rel(torch.from_numpy(gpu.latents), torch.from_numpy(cpu.latents)) <= 1e-3
    assert rel(torch.from_numpy(gpu.audio.samples), torch.from_numpy(cpu.audio.samples)) <= 1e-3


def stream_f32(path, device, p, texts, frames):
    """Unclipped f32 PCM [B, frames * 1920] of a StreamingSession's state
    driven through fused_stream_step with emit_i16=False (the session's
    own int16 chunks clip, which would hide the drift this gate bounds)."""
    ctx = api.load_dir(path, device=device)
    engine = ctx.engine
    s = StreamingSession.start(engine, texts, params=p, pipeline=False)
    cache, state, x, eos_step, done, out = s.cache, s.mimi_state, s.x, s.eos_step, s.done, []
    with torch.inference_mode():
        for i in range(frames):
            cache, state, x, pcm, _, eos_step, done = fused_stream_step(
                engine.fw, engine.mw, cache, state, x, s._noise_dev, s.time_embs, i, eos_step,
                done, s.cfg, engine.mimi_cfg, False, p.eos_threshold, p.eos_min_frames,
                s.eos_after, s.frames_each)
            out.append(pcm.float().cpu())
    return torch.cat(out, dim=1)


def test_full_width_stream_on_card_matches_cpu(dev, tmp_path):
    """The default-width streaming step (prefill with B1 at the unrounded
    prefix lengths, FlowLM frame, streaming Mimi) on the card against the
    CPU: 8 frames of two ragged streams, f32 PCM within 1e-3 of max."""
    path = synth.write_model_dir(str(tmp_path), seed=0)
    p = api.Params(seed=1, num_frames=8, eos_enabled=False)
    texts = ["Hello world!", "A second, longer stream of text."]
    before = fa.causal_attention_qkv.launches
    gpu = stream_f32(path, "cuda", p, texts, 8)
    assert fa.causal_attention_qkv.launches == before + 6  # one per layer
    cpu = stream_f32(path, "cpu", p, texts, 8)
    assert gpu.shape == cpu.shape == (2, 8 * 1920)
    assert torch.isfinite(gpu).all()
    assert rel(gpu, cpu) <= 1e-3


def test_full_width_batcher_on_card_matches_cpu(dev, tmp_path):
    """The continuous batcher at default width on the card (B1 at every
    admission) against the CPU: 3 requests through 2 slots, 4 frames, EOS
    off, explicit seeds. Frames equal; int16 within 8 LSB, or, where the
    random full-size PCM clips, int16/32767 views within 1e-3 of max."""
    from ptts_torch.runtime.batching import ContinuousBatcher

    path = synth.write_model_dir(str(tmp_path), seed=0)
    texts = ["Hello world!", "A second, longer stream of text.", "Third."]
    out = {}
    for device in ("cuda", "cpu"):
        b = ContinuousBatcher(api.load_dir(path, device=device).engine, slots=2, admit_chunk=2,
                              prefix_budget=128, max_len=192)
        before = fa.causal_attention_qkv.launches
        rids = [b.submit(t, params=api.Params(seed=3, num_frames=4, eos_enabled=False))
                for t in texts]
        out[device] = (rids, b.drain(), fa.causal_attention_qkv.launches - before)
    (rids, gpu, launched), (rids_c, cpu, _) = out["cuda"], out["cpu"]
    assert rids == rids_c
    assert launched == 6 * 2  # one per layer, two admit groups
    for rid in rids:
        g, c = gpu[rid].pcm_i16, cpu[rid].pcm_i16
        assert gpu[rid].frames == cpu[rid].frames == 4 and g.shape == c.shape == (4 * 1920,)
        lsb = int(np.abs(g.astype(np.int32) - c.astype(np.int32)).max())
        if lsb > 8:
            assert (np.abs(c) == 32767).any(), f"rid {rid}: {lsb} LSB with no clipping"
            assert rel(torch.from_numpy(g / np.float32(32767.0)),
                       torch.from_numpy(c / np.float32(32767.0))) <= 1e-3


def card_mesh(pmesh):
    """A 2-host mesh over the first 4 (or 2) visible GPUs, else 2 host
    groups x 2 shards all on cuda:0 (the pool's 4 slots fill at most 4
    positions)."""
    n = torch.cuda.device_count()
    devs = [f"cuda:{i}" for i in range(4 if n >= 4 else 2)] if n >= 2 else ["cuda:0"] * 4
    return pmesh.make_multihost_mesh(2, devs)


def test_sharded_batcher_on_card_matches_unsharded(dev, tmp_path):
    """The batcher's pool sharded over a 2-host mesh on the card (B1 in
    every admit group of every shard) against the unsharded pool: frames
    equal, int16 within 4 LSB (sub-pools run their GEMMs at other batch
    sizes); every shard's tensors on its device; a second drain at the same
    shapes builds no new RoPE table on any device."""
    from ptts_torch.ops import rope
    from ptts_torch.parallel import mesh as pmesh
    from ptts_torch.runtime.batching import ContinuousBatcher

    fc = FlowLMConfig(vocab=60, text_dim=128, d_model=128, num_heads=2, head_dim=64,
                      num_layers=2, hidden=256, latent_dim=8, flow_dim=32, flow_depth=2,
                      time_freqs=8)
    mc = MimiConfig(latent_dim=8, d_model=128, num_heads=2, head_dim=64, num_layers=1,
                    hidden=256, n_filters=4, ratios=(3, 2))
    path = synth.write_model_dir(str(tmp_path), fc, mc, seed=2, scale=0.1)
    engine = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cuda").engine
    texts = ["Hello world!", "A second, longer stream of text.", "Third.", "Four.", "Five!"]
    frames = (3, 6, 4, 5, 2)
    mesh = card_mesh(pmesh)

    def run(m):
        b = ContinuousBatcher(engine, slots=4, admit_chunk=2, prefix_budget=64, max_len=96,
                              mesh=m)
        rids = [b.submit(t, params=api.Params(seed=3, num_frames=f, eos_enabled=False))
                for t, f in zip(texts, frames)]
        return rids, b.drain(), b

    rids_u, res_u, _ = run(None)
    before = fa.causal_attention_qkv.launches
    rids, res, b = run(mesh)
    assert fa.causal_attention_qkv.launches - before == fc.num_layers * b.n_admit_groups
    assert [sh.device for sh in b.shards] == mesh.device_list
    for sh in b.shards:
        assert all(t.device == sh.device for t in (sh.cache.k, sh.x, sh.done, sh.noise_tab,
                                                   sh.cond_bank, *sh.params_dev))
    assert rids == rids_u
    for rid, f in zip(rids, frames):
        g, u = res[rid].pcm_i16, res_u[rid].pcm_i16
        assert res[rid].frames == res_u[rid].frames == f and g.shape == u.shape
        assert int(np.abs(g.astype(np.int32) - u.astype(np.int32)).max()) <= 4, rid
    misses = (fa._rope_tables.cache_info().misses, rope._device_freqs.cache_info().misses)
    run(mesh)
    assert (fa._rope_tables.cache_info().misses,
            rope._device_freqs.cache_info().misses) == misses


def test_dryrun_multichip_on_card(dev):
    """The sharded offline pipeline, the 2-host sharded batcher and
    spec_admit over 4 positions (distinct GPUs when 4 are visible, else
    cuda:0 repeated), with both kernels launched."""
    from ptts_torch import dryrun

    before = (fa.causal_attention_qkv.launches, fa.window_attention_qkv.launches)
    dryrun.dryrun_multichip(4, "cuda")
    assert fa.causal_attention_qkv.launches > before[0]
    assert fa.window_attention_qkv.launches > before[1]


def small_model(tmp_path):
    """A small model with the kernels' head dim (as test_engine_on_card_matches_cpu)."""
    fc = FlowLMConfig(vocab=60, text_dim=128, d_model=128, num_heads=2, head_dim=64,
                      num_layers=2, hidden=256, latent_dim=8, flow_dim=32, flow_depth=2,
                      time_freqs=8)
    mc = MimiConfig(latent_dim=8, d_model=128, num_heads=2, head_dim=64, num_layers=1,
                    hidden=256, n_filters=4, ratios=(3, 2))
    return synth.write_model_dir(str(tmp_path), fc, mc, seed=2, scale=0.1), fc, mc


def test_plain_switches_launch_no_kernel(dev, tmp_path):
    """chip_smoke phase 10 (a), small: an engine with both switches on
    "plain" launches neither kernel and stays within 1e-3 of the kernel
    engine (latents and PCM)."""
    from ptts_torch.config import KernelFlags
    from ptts_torch.runtime.engine import TTSEngine

    path, fc, mc = small_model(tmp_path)
    ctx = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cuda")
    p = api.Params(seed=4, num_frames=5, eos_enabled=False)
    want = ctx.engine.generate_full("Hello world!", params=p)
    plain = TTSEngine(ctx, flags=KernelFlags(prefill_impl="plain", window_impl="plain"))
    assert (plain.prefill_impl, plain.window_impl) == ("plain", "plain")
    before = (fa.causal_attention_qkv.launches, fa.window_attention_qkv.launches)
    got = plain.generate_full("Hello world!", params=p)
    assert (fa.causal_attention_qkv.launches, fa.window_attention_qkv.launches) == before
    assert rel(torch.from_numpy(got.latents), torch.from_numpy(want.latents)) <= 1e-3
    assert rel(torch.from_numpy(got.audio.samples), torch.from_numpy(want.audio.samples)) <= 1e-3


def test_blocked_decode_on_card_matches_einsum(dev, tmp_path):
    """chip_smoke phase 10 (b), small: decode_impl="blocked" against the
    masked einsum on the card, latents within 1e-3 of max."""
    import dataclasses

    path, fc, mc = small_model(tmp_path)
    engine = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cuda").engine
    p = api.Params(seed=4, num_frames=5, eos_enabled=False)
    want = engine.generate_full("Hello world!", params=p, decode_audio=False)
    engine.flags = dataclasses.replace(engine.flags, decode_impl="blocked")
    got = engine.generate_full("Hello world!", params=p, decode_audio=False)
    assert rel(torch.from_numpy(got.latents), torch.from_numpy(want.latents)) <= 1e-3


def test_packed_bf16_load_on_card(dev, tmp_path):
    """chip_smoke phase 11 (a), small: the bf16 engine's weights on the card
    are bit-equal to the same trees packed on the CPU, every leaf at a
    256-byte-aligned address; bf16 generation launches B1 and B2 in bf16."""
    from ptts_torch.models import flowlm, mimi
    from ptts_torch.runtime.engine import TTSEngine
    from ptts_torch.utils.packing import ALIGN

    path, fc, mc = small_model(tmp_path)
    ctx = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cuda")
    engine = TTSEngine(ctx, dtype=torch.bfloat16)
    assert set(engine.weights_s) == {"read", "pack", "copy"}
    host = (flowlm.to_device(flowlm.load_weights(ctx.weights, fc, dtype=torch.bfloat16),
                             torch.bfloat16, fc),
            mimi.to_device(mimi.load_weights(ctx.weights, mc), torch.bfloat16, mc))
    for dev_tree, cpu_tree in zip((engine.fw, engine.mw), host):
        pairs = list(zip(dev_tree.named_buffers(), cpu_tree.named_buffers()))
        assert pairs
        for (name, d), (_, c) in pairs:
            assert d.is_cuda and d.dtype == torch.bfloat16 and d.data_ptr() % ALIGN == 0, name
            assert torch.equal(d.cpu().view(torch.int16), c.view(torch.int16)), name
    fa.causal_attention_qkv.shapes.clear()
    fa.window_attention_qkv.shapes.clear()
    out = engine.generate_full("Hello world!", params=api.Params(seed=4, num_frames=3,
                                                                eos_enabled=False))
    assert np.isfinite(out.audio.samples).all() and out.frames_used == 3
    assert {d for d, _, _ in fa.causal_attention_qkv.shapes} == {"bf16"}
    assert {d for d, _, _ in fa.window_attention_qkv.shapes} == {"bf16"}


# -- CUDA graphs (runtime/graphs): replay against eager ------------------------


def graph_engines(tmp_path):
    """Two engines on one small model on the card: graphs on (the default)
    and off."""
    from ptts_torch.runtime.engine import TTSEngine

    path, fc, mc = small_model(tmp_path)
    ctx = api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cuda")
    eager = TTSEngine(ctx, graphs=False)
    assert ctx.engine.graphs and not eager.graphs
    return ctx.engine, eager


def test_graph_offline_loop_equals_eager(dev, tmp_path):
    """generate_full (EOS on, EOS off) and a ragged batch_generate replayed
    in chunks of flowlm.GRAPH_CHUNK frames: bit-equal to the eager engine,
    with at most one done-check per chunk."""
    from ptts_torch.models import flowlm
    from ptts_torch.runtime import graphs

    eng, eager = graph_engines(tmp_path)
    texts = ["Hello world!", "A second, longer stream.", "Three.", "Four, five, six."]
    captures = graphs.STATS["captures"]
    for p in (api.Params(seed=3, num_frames=40, num_steps=2, eos_threshold=-0.5),
              api.Params(seed=4, num_frames=27, eos_enabled=False)):
        checks = flowlm.HOST_CHECKS
        a = eng.generate_full(texts[0], params=p)
        assert flowlm.HOST_CHECKS - checks <= -(-64 // flowlm.GRAPH_CHUNK)
        b = eager.generate_full(texts[0], params=p)
        assert a.frames_used == b.frames_used
        np.testing.assert_array_equal(a.latents, b.latents)
        np.testing.assert_array_equal(a.first_cond, b.first_cond)
        np.testing.assert_array_equal(a.audio.samples, b.audio.samples)
        for x, y in zip(eng.batch_generate(texts, params=p), eager.batch_generate(texts, params=p)):
            np.testing.assert_array_equal(x.samples, y.samples)
    assert graphs.STATS["captures"] > captures


def test_graph_session_equals_eager(dev, tmp_path, monkeypatch):
    """StreamingSession replayed, B = 1 and 3, 32 frames, the Mimi ring cut
    to 32 slots so that it wraps: every chunk bit-equal to the eager
    session's."""
    from ptts_torch.models import mimi_stream

    monkeypatch.setattr(mimi_stream, "RING", 32)
    eng, eager = graph_engines(tmp_path)
    texts = ["Hello world!", "A second, longer stream.", "Three."]
    p = api.Params(seed=5, num_frames=32, eos_enabled=False)
    for B in (1, 3):
        a = list(StreamingSession.start(eng, texts[:B], params=p))
        b = list(StreamingSession.start(eager, texts[:B], params=p))
        assert len(a) == len(b) == 32
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.pcm_i16, y.pcm_i16)
            np.testing.assert_array_equal(x.active, y.active)


@pytest.mark.parametrize("kw", [dict(frames_per_step=1), dict(frames_per_step=4, split_admit=True)],
                         ids=["k1", "k4_split"])
def test_graph_batcher_equals_eager(dev, tmp_path, monkeypatch, kw):
    """The batcher's shard step replayed at k = 1 and at k = 4 with
    split_admit: 16 requests of 10-15 frames through 4 slots, past the
    16-column FlowLM ring and the Mimi ring cut to 96 slots (it wraps every
    6 frames; a 4-frame chunk is 64 positions); results bit-equal to the
    eager batcher's."""
    from ptts_torch.models import mimi_stream
    from ptts_torch.runtime.batching import ContinuousBatcher

    monkeypatch.setattr(mimi_stream, "RING", 96)
    eng, eager = graph_engines(tmp_path)

    def run(engine):
        b = ContinuousBatcher(engine, slots=4, admit_chunk=2, prefix_budget=64, max_len=80, **kw)
        rids = [b.submit(f"Request number {i}.", params=api.Params(
            seed=7, num_frames=10 + i % 6, eos_enabled=False)) for i in range(16)]
        return rids, b.drain(), b

    rids, got, b = run(eng)
    _, want, _ = run(eager)
    assert int(b.shards[0].cache.cursor) - b.prefix_budget > 2 * (b.max_len - b.prefix_budget)
    assert len(b._graphs) >= 1
    for rid in rids:
        assert got[rid].frames == want[rid].frames
        np.testing.assert_array_equal(got[rid].pcm_i16, want[rid].pcm_i16)


def test_graph_capture_error_propagates(dev):
    """A body that syncs the host cannot be captured: the error reaches the
    caller (no eager fallback) at each capture attempt, and nothing is kept."""
    from ptts_torch.runtime import graphs

    cache = graphs.GraphCache()
    x = torch.ones(4, device=dev)

    def body():
        x.add_(1)
        return x * float(x.sum().item())

    for _ in range(graphs.WARMUP):  # the eager warm-up runs
        cache.run("k", dev, body)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            cache.run("k", dev, body)
        assert len(cache) == 0
    torch.cuda.synchronize()
