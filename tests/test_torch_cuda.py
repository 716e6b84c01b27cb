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
from ptts_torch.tools import sanitize as tsan  # noqa: E402

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", tsan.B1_B)
@pytest.mark.parametrize("T", tsan.B1_T)
def test_causal_kernel_guarded_launch(dev, dtype, T, B):
    """ptts_torch.tools.sanitize phase 1: B1's C entry point on views inside
    slabs whose bands hold NaN (inputs) and a sentinel (outputs): the output
    bands come back bit-identical, the outputs finite and within the gate
    of the plain version."""
    launch = tsan.kernel_launch("causal_attention_qkv", dev)
    before = fa.causal_attention_qkv.launches
    res = tsan.guarded_case("causal_attention_qkv", dtype, B, T, tsan.B1_HEADS, launch, dev,
                            seed=B * 1000 + T)
    assert res["rel"] <= GATES[dtype]
    assert fa.causal_attention_qkv.launches == before   # a raw launch is not counted


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("context", tsan.B2_CONTEXTS)
@pytest.mark.parametrize("T", tsan.B2_T)
def test_window_kernel_guarded_launch(dev, dtype, T, context):
    launch = tsan.kernel_launch("window_attention_qkv", dev)
    res = tsan.guarded_case("window_attention_qkv", dtype, tsan.B2_B, T, tsan.B2_HEADS, launch,
                            dev, context=context, seed=T + context)
    assert res["rel"] <= GATES[dtype]


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
    engine.flags = dataclasses.replace(engine.flags, decode_impl="einsum")
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


# -- the decode attention (ops/cuda/decode_attention) ---------------------------


def within_decode_gates(got, want, dtype) -> bool:
    """The decode attention's gates (tools/sanitize.DECODE_GATES): max error
    over max |want|, and in bf16 the error's norm over want's."""
    norm = ((got.float() - want.float()).norm() / want.float().norm()).item()
    return rel(got, want) <= tsan.DECODE_GATES[dtype] and (
        dtype != torch.bfloat16 or norm <= tsan.DECODE_RMS_GATE)


def decode_cache(dev, dtype, B, Tmax, t0, seed, offline=False, kind="mixed"):
    """A flowlm.KVCache of one layer, [1, B, Tmax, 16, 64] random K/V, at a
    cursor where its decode ring (the columns from t0 on) has wrapped three
    times (``offline``: not wrapped, every stream started at t0, as the
    offline loop's cache); prefixes and decode spans random. ``kind``
    "mixed" makes rows 0, 1, 2 a prefix-only row, a row of one valid column
    and a row of none; "prefix_only", "one_column" and "none" make every
    row so. Returns (q [B, 16, 64], cache)."""
    from ptts_torch.models import flowlm

    rng = np.random.default_rng(seed)
    ring = Tmax - t0
    cursor = t0 + 2 * ring // 3 if offline else t0 + 3 * ring + 17
    prefix = rng.integers(max(t0 // 2, 1), t0 + 1, B)
    start = np.full(B, t0) if offline else cursor - rng.integers(0, ring, B)
    rows = {"prefix_only": (None, cursor + 1), "one_column": (0, cursor), "none": (0, cursor + 1)}
    order = ["prefix_only", "one_column", "none"] if kind == "mixed" else [kind] * B
    for b, what in enumerate(order[:B]):
        p, s = rows[what]
        prefix[b] = prefix[b] if p is None else p
        start[b] = s
    k, v, q = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
               for s in ((1, B, Tmax, 16, 64), (1, B, Tmax, 16, 64), (B, 16, 64)))
    cache = flowlm.KVCache(k=k, v=v, prefix_len=torch.tensor(prefix, dtype=torch.int32,
                                                               device=dev),
                           start=torch.tensor(start, dtype=torch.int32, device=dev),
                           cursor=torch.tensor(cursor, dtype=torch.int32, device=dev), t0=t0)
    return q, cache


# (dtype, B, Tmax, prefix columns t0, offline): bf16-serve-short's and
# bf16-serve-long's pools, f32-offline-long's length groups, Context.stream
DECODE_SHAPES = [(torch.bfloat16, 256, 128, 64, False), (torch.bfloat16, 256, 544, 160, False),
                 (torch.float32, 16, 528, 153, True), (torch.bfloat16, 1, 200, 40, False),
                 (torch.float32, 1, 200, 40, True)]


@pytest.mark.parametrize("dtype,B,Tmax,t0,offline", DECODE_SHAPES,
                         ids=["bf16-256x128", "bf16-256x544", "f32-16x528", "bf16-1x200",
                              "f32-1x200"])
def test_decode_kernel_matches_plain_with_nan_in_masked_columns(dev, dtype, B, Tmax, t0,
                                                                offline):
    """The kernel at the main path's shapes against the plain version, on
    KVCache.valid_mask past ring wraps (a prefix-only row, a row of one
    column, a row of none among them), with NaN in every K/V column the
    mask leaves out of a row that has a valid one: the output is finite and
    within the gates of the plain version run on the clean cache."""
    from ptts_torch.ops import attention
    from ptts_torch.ops.cuda import decode_attention as da

    q, cache = decode_cache(dev, dtype, B, Tmax, t0, seed=B + Tmax, offline=offline)
    mask = cache.valid_mask()
    want = attention.decode_attention_masked(q, cache.k[0], cache.v[0], mask)
    skip = (~mask & mask.any(dim=1, keepdim=True))[:, :, None, None]
    k, v = (x[0].masked_fill(skip, float("nan")) for x in (cache.k, cache.v))
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert within_decode_gates(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_grouped_decode_kernel_matches_plain(dev, dtype, group):
    """Grouped-query heads: 8 KV heads each serving ``group`` query heads
    (the hybrid backbone's 32 over 8 at 4), at its softmax scale 1/64, on
    the long cell's pool mask with NaN in the masked K/V columns: finite
    and within the gates of the plain grouped version on the clean cache."""
    from ptts_torch.ops import attention
    from ptts_torch.ops.cuda import decode_attention as da

    _, cache = decode_cache(dev, dtype, 256, 544, 160, seed=group)
    mask = cache.valid_mask()
    g = torch.Generator(device=dev).manual_seed(group)
    q = torch.randn(256, 8 * group, 64, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(256, 544, 8, 64, generator=g, device=dev).to(dtype) for _ in range(2))
    want = attention.decode_attention_masked(q, k, v, mask, 0.015625)
    skip = (~mask & mask.any(dim=1, keepdim=True))[:, :, None, None]
    got = da.decode_attention(q, k.masked_fill(skip, float("nan")),
                              v.masked_fill(skip, float("nan")), mask, 0.015625)
    torch.cuda.synchronize()
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert within_decode_gates(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["prefix_only", "one_column", "none"])
def test_decode_kernel_single_stream_rows(dev, dtype, kind):
    """B = 1 (Context.stream; many splits of one stream) with its only row
    prefix-only, of one valid column, or of none (every column at equal
    scores, as the plain version's softmax over -1e30 gives)."""
    from ptts_torch.ops import attention
    from ptts_torch.ops.cuda import decode_attention as da

    q, cache = decode_cache(dev, dtype, 1, 544, 160, seed=7, kind=kind)
    mask = cache.valid_mask()
    got = da.decode_attention(q, cache.k[0], cache.v[0], mask)
    want = attention.decode_attention_masked(q, cache.k[0], cache.v[0], mask)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and within_decode_gates(got, want, dtype)


def test_decode_kernel_refuses_what_it_cannot_take(dev):
    from ptts_torch.ops.cuda import decode_attention as da

    q, cache = decode_cache(dev, torch.bfloat16, 4, 64, 16, seed=1)
    k, v, mask = cache.k[0], cache.v[0], cache.valid_mask()
    with pytest.raises(ValueError):  # the cache on another layout
        da.decode_attention(q, k.transpose(1, 2), v.transpose(1, 2), mask)
    with pytest.raises(TypeError):   # q and cache in different dtypes
        da.decode_attention(q.float(), k, v, mask)
    with pytest.raises(ValueError):  # the mask on the host
        da.decode_attention(q, k, v, mask.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_replayed_equals_eager_kernel(dev, dtype, tmp_path):
    """flowlm.decode_step on the small model's weights (2 heads), captured
    once as a CUDA graph and replayed for 12 frames across a ring wrap, against the
    same steps run eagerly on a copy of the cache: outputs and caches
    bit-equal, and the kernel launched in both."""
    import dataclasses

    from ptts_torch.models import flowlm
    from ptts_torch.ops.cuda import decode_attention as da
    from ptts_torch.runtime.engine import TTSEngine

    path, fc, mc = small_model(tmp_path)
    w = TTSEngine(api.load_dir(path, flowlm_cfg=fc, mimi_cfg=mc, device="cuda"), dtype=dtype).fw
    rng = np.random.default_rng(3)
    B, Tmax, t0 = 8, 90, 80   # a 10-column ring, three splits a stream

    def fresh():
        cache = flowlm.make_cache(fc, B, Tmax, dtype, dev)
        g = np.random.default_rng(4)
        cache.k.copy_(torch.from_numpy(g.standard_normal(tuple(cache.k.shape)).astype(np.float32)))
        cache.v.copy_(torch.from_numpy(g.standard_normal(tuple(cache.v.shape)).astype(np.float32)))
        cache.prefix_len.copy_(torch.tensor([80, 33, 1, 0, 50, 80, 2, 70], dtype=torch.int32))
        cache.start.copy_(torch.tensor([80, 80, 81, 82, 80, 84, 80, 87], dtype=torch.int32))
        return dataclasses.replace(flowlm.seek(cache, t0, t0), cursor_host=None)

    xs = [torch.from_numpy(rng.standard_normal((B, fc.d_model)).astype(np.float32)).to(dev, dtype)
          for _ in range(12)]
    eager, replayed = fresh(), fresh()
    x = torch.empty_like(xs[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up on a throwaway cache
        scratch = fresh()
        for _ in range(2):
            flowlm.decode_step(w, scratch, x.copy_(xs[0]), fc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = da.decode_attention.launches
    with torch.cuda.graph(graph):
        _, out = flowlm.decode_step(w, replayed, x, fc)
    assert da.decode_attention.launches == launches + fc.num_layers
    for step in range(12):
        x.copy_(xs[step])
        graph.replay()
        _, want = flowlm.decode_step(w, eager, xs[step], fc)
        torch.cuda.synchronize()
        assert torch.equal(out, want), step
    assert torch.equal(replayed.k, eager.k) and torch.equal(replayed.v, eager.v)
    assert int(replayed.cursor) == int(eager.cursor) == t0 + 12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Tmax,splits", tsan.DECODE_CASES)
def test_decode_kernel_guarded_launch(dev, dtype, B, Tmax, splits):
    """ptts_torch.tools.sanitize phase 1 for the decode attention: its C
    entry point on views inside NaN- and sentinel-banded slabs, NaN in the
    masked K/V columns."""
    from ptts_torch.ops.cuda import decode_attention as da

    before = da.decode_attention.launches
    res = tsan.guarded_decode_case(dtype, B, Tmax, splits, tsan.decode_launch(dev), dev,
                                   seed=B * 10000 + Tmax + splits)
    assert res["rel"] <= tsan.DECODE_GATES[dtype]
    assert dtype != torch.bfloat16 or res["rms"] <= tsan.DECODE_RMS_GATE
    assert da.decode_attention.launches == before   # a raw launch is not counted


# -- the Mamba-2 frame step (ops/cuda/ssm_step) ---------------------------------


@pytest.mark.parametrize("live", [None, True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3, 257])
def test_ssm_step_kernel_matches_plain(dev, dtype, B, live):
    """The frame step's kernels against the plain version on the card, over
    3 frames from the same state and window: the conv window equal; the
    state within 1e-5 of max in f32, and in bf16 within 2^-6 of |s dA| +
    |x dt B| (a conv output whose bf16 rounding flips moves x or B by one
    ulp, up to 2^-7 of it, and the state's rounding may then flip too); y
    within 1e-5 / 2^-7 of max. Not live: the state and the window
    keep every bit."""
    from chip_smoke import ssm_inputs, xbc_dt
    from ptts_torch.ops.cuda import ssm_step as tss

    zxbcdt, ssm, conv, params = ssm_inputs(dtype, B, 64, seed=B, device=dev)
    flag = None if live is None else torch.tensor(live, device=dev)
    s_plain, c_plain = ssm.clone(), conv.clone()
    before = tss.ssm_step.launches
    for frame in range(3):
        s0, c0 = ssm.clone(), conv.clone()
        x_f, dt_f = xbc_dt(zxbcdt * (1 + 0.1 * frame))
        want = tss.ssm_step_plain(x_f, dt_f, s_plain, c_plain, *params, flag)
        got = tss.ssm_step(x_f, dt_f, ssm, conv, *params, flag)
        torch.cuda.synchronize()
        assert torch.equal(conv, c_plain)
        if live is False:
            assert torch.equal(ssm.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                               s0.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
            assert torch.equal(conv, c0)
        if dtype == torch.float32:
            assert rel(ssm, s_plain) < 1e-5 and rel(got, want) < 1e-5
        else:
            H, P, N = ssm.shape[1:]
            window = torch.cat([c0, x_f[:, None]], 1).float()
            xc = (window * params[0].float().T).sum(1) + params[1].float()
            xc = (xc * torch.sigmoid(xc)).to(dtype).float()
            dtv = torch.nn.functional.softplus(dt_f.float() + params[2].float())
            dA = torch.exp(dtv * -torch.exp(params[3].float()))
            terms = ((s0.float() * dA[:, :, None, None]).abs()
                     + ((xc[:, :H * P].reshape(B, H, P) * dtv[..., None])[..., None]
                        * xc[:, None, None, H * P:H * P + N]).abs())
            assert bool(((ssm.float() - s_plain.float()).abs() <= terms * 2.0 ** -6).all())
            assert rel(got, want) < 2.0 ** -7
        s_plain.copy_(ssm)
    assert tss.ssm_step.launches == before + 3
    assert tss.ssm_step.shapes[("bf16" if dtype == torch.bfloat16 else "f32", B, 64)] >= 3


def test_ssm_step_kernel_refuses_what_it_cannot_take(dev):
    """On the card the wrapper raises where the kernel cannot run: a state
    of another head dim, a mixed dtype, a state that is not contiguous."""
    from chip_smoke import ssm_inputs, xbc_dt
    from ptts_torch.ops.cuda import ssm_step as tss

    zxbcdt, ssm, conv, params = ssm_inputs(torch.bfloat16, 2, 64, seed=0, device=dev)
    xbc, dt = xbc_dt(zxbcdt)
    with pytest.raises(ValueError, match="P = 64"):
        tss.ssm_step(xbc, dt, ssm.reshape(2, 64, 128, 64), conv, *params)
    with pytest.raises(TypeError, match="state's dtype"):
        tss.ssm_step(xbc.float(), dt, ssm, conv, *params)
    with pytest.raises(ValueError, match="contiguous"):
        tss.ssm_step(xbc, dt, ssm.transpose(2, 3).contiguous().transpose(2, 3), conv, *params)


def hybrid_system(dev, dtype):
    """The hybrid configuration's stack (layer_types[0:10]: 9 Mamba layers,
    attention at index 5) at the kernels' Mamba widths (P = 64, N = 128)
    and small others, on the card, through the benchmark's own builder."""
    import json
    import os

    from benchmark import hybrid as H

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    c = json.load(open(os.path.join(repo, "benchmark", "configs",
                                    "pocket-tts-granite4h-bf16.json")))
    c.update(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
             shared_intermediate_size=256, intermediate_size=256, mamba_n_heads=4,
             mamba_chunk_size=16, vocab_size=64, num_hidden_layers=10,
             dtype="bf16" if dtype == torch.bfloat16 else "f32",
             flowlm=dict(c["flowlm"], latent_dim=8, flow_dim=32, flow_depth=2, time_freqs=8),
             mimi=dict(latent_dim=8, d_model=128, num_heads=2, head_dim=64, num_layers=1,
                       hidden=256, context=8, max_period=10000.0, ln_eps=1e-5,
                       upsample_kernel=4, upsample_stride=2, n_filters=4, ratios=[2, 2],
                       kernel_size=3, last_kernel_size=3, residual_kernel=3, compress=2))
    c["assumed"] = dict(c["assumed"], voice_frames=4)
    cfg = H.expand(c)
    return H.build(cfg, 1234, dev, 1).engine


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hybrid_step_replayed_equals_eager(dev, dtype):
    """The hybrid's decode_step (9 Mamba layers through the frame step's
    kernels, the grouped decode attention) through runtime/graphs'
    GraphCache -- 2 eager warm-up frames, then a capture and 8 replays --
    against 10 eager frames on a copy of the cache, with ``live`` read on
    the device (False at frames 4 and 8): outputs, SSM and conv states and
    K/V bit-equal, and ssm_step.launches up by 9 a frame, replays
    included."""
    import dataclasses

    from ptts_torch.models import flowlm
    from ptts_torch.ops.cuda import ssm_step as tss
    from ptts_torch.runtime.graphs import GraphCache

    eng = hybrid_system(dev, dtype)
    w, fc = eng.fw, eng.flowlm_cfg
    assert len(fc.mamba_layers) == 9 and fc.mamba_head_dim == 64 and fc.mamba_d_state == 128
    rng = np.random.default_rng(5)
    B, Tmax, t0 = 8, 90, 80

    def fresh():
        cache = flowlm.make_cache(fc, B, Tmax, dtype, dev)
        g = np.random.default_rng(6)
        for t, scale in ((cache.k, 1.0), (cache.v, 1.0), (cache.ssm, 0.3), (cache.conv, 1.0)):
            t.copy_(torch.from_numpy((g.standard_normal(tuple(t.shape)) * scale).astype(
                np.float32)))
        cache.prefix_len.copy_(torch.tensor([80, 33, 1, 0, 50, 80, 2, 70], dtype=torch.int32))
        cache.start.copy_(torch.tensor([80, 80, 81, 82, 80, 84, 80, 87], dtype=torch.int32))
        return dataclasses.replace(flowlm.seek(cache, t0, t0), cursor_host=None)

    xs = [torch.from_numpy(rng.standard_normal((B, fc.d_model)).astype(np.float32)).to(dev, dtype)
          for _ in range(10)]
    lives = [True, True, True, False, True, True, True, False, True, True]
    graphed, eager = fresh(), fresh()
    x, live = torch.empty_like(xs[0]), torch.ones((), dtype=torch.bool, device=dev)
    graphs = GraphCache()
    with torch.inference_mode():
        for step in range(10):
            x.copy_(xs[step])
            live.fill_(lives[step])
            n = tss.ssm_step.launches
            out = graphs.run(("hybrid",), dev, lambda: flowlm.decode_step(
                w, graphed, x, fc, live=live)[1])
            assert tss.ssm_step.launches == n + 9, step
            _, want = flowlm.decode_step(w, eager, xs[step], fc,
                                         live=torch.tensor(lives[step], device=dev))
            torch.cuda.synchronize()
            assert torch.equal(out, want), step
    assert len(graphs) == 1
    for a, b in ((graphed.ssm, eager.ssm), (graphed.conv, eager.conv), (graphed.k, eager.k),
                 (graphed.v, eager.v)):
        assert torch.equal(a, b)
    assert int(graphed.cursor) == int(eager.cursor) == t0 + 8
