"""Granite 4.0-H's hybrid stack as FlowLM's backbone (ptts_torch/models/
hybrid.py) on the CPU at tiny widths, held to the benchmark's plain
reference (benchmark/reference/hybrid.py: float32, the Mamba-2 layers run
position by position) on seeded random weights made by the benchmark's
own schema (benchmark/hybrid.py), with Mamba-2's published init.

The JAX package has no such backbone, so the reference is the oracle here.
Tolerances, each relative to the largest magnitude compared: the port and
the reference both run float32, in different orders of summation (the
port's prompt pass is the chunked scan, its frames the in-place
recurrence; the reference's the sequential recurrence over the whole
sequence), which part at about 1e-6 of max over a dozen frames of random
weights; 1e-4 leaves room for the ~2x per frame growth of rounding that
random weights give, and is 100x under what a skipped layer or a stale
state moves (a stale state moves the frames by ~1e-2 of max, the faulted
check below).
"""

import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ptts_torch.models import flowlm, hybrid  # noqa: E402
from ptts_torch.ops import attention as tattn  # noqa: E402
from ptts_torch.ops.cuda import decode_attention as tda  # noqa: E402
from ptts_torch.runtime import batching  # noqa: E402
from ptts_torch.runtime.batching import ContinuousBatcher, Request  # noqa: E402
from test_torch_graphs import ReplayOnCPU  # noqa: E402

from benchmark import hybrid as H  # noqa: E402
from benchmark.reference.hybrid import HybridReference  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 8
TOL = 1e-4
MIMI = dict(latent_dim=8, d_model=16, num_heads=2, head_dim=8, num_layers=1, hidden=32,
            context=8, max_period=10000.0, ln_eps=1e-5, upsample_kernel=4, upsample_stride=2,
            n_filters=4, ratios=[2, 2], kernel_size=3, last_kernel_size=3, residual_kernel=3,
            compress=2)
HEADS = dict(latent_dim=8, flow_dim=16, flow_depth=2, time_freqs=8, max_period=10000.0,
             ln_eps=1e-5, flow_ln_eps=1e-6, rms_eps=1e-5)


def tiny_cfg(**over) -> dict:
    """The hybrid configuration file at tiny widths: Mamba, attention,
    Mamba, the published multipliers, 4 query heads over 2 KV heads, all in
    float32, the SSM state included."""
    c = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                    "pocket-tts-granite4h-bf16.json")))
    c.update(hidden_size=32, num_attention_heads=4, num_key_value_heads=2,
             shared_intermediate_size=48, intermediate_size=48, mamba_n_heads=4, mamba_d_head=16,
             mamba_d_state=8, mamba_chunk_size=CHUNK, vocab_size=64, num_hidden_layers=3,
             layer_types=["mamba", "attention", "mamba"], dtype="f32", flowlm=dict(HEADS),
             mimi=dict(MIMI))
    c["assumed"] = dict(c["assumed"], weight_scale=0.3, voice_frames=4, voice_scale=0.3)
    c.update(over)
    return H.expand(c)


@pytest.fixture(scope="module")
def system():
    torch.manual_seed(0)
    cfg = tiny_cfg()
    return H.build(cfg, 1234, "cpu", 2), HybridReference(
        {k: v.float() for k, v in H.make_weights(cfg, 1234, "cpu").items()}, cfg)


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# -- the stack against the reference ------------------------------------------


def test_prefill_then_cached_frames_equal_the_reference(system):
    """A prompt through the chunked prefill (longer than one chunk), then
    12 frames through the KV cache and the Mamba states: latents and EOS
    logits equal the reference's full pass over the same history."""
    sysm, ref = system
    eng = sysm.engine
    cfg = eng.flowlm_cfg
    prompt = ref.prompt([3, 5, 7, 9, 11, 13], sysm.voices[0])
    T0, F = prompt.shape[0], 12
    assert T0 > CHUNK
    noise = torch.randn(F, cfg.latent_dim, generator=torch.Generator().manual_seed(1)) * 0.8
    with torch.inference_mode():
        cache = flowlm.make_cache(cfg, 1, T0 + F, torch.float32)
        cache, x = flowlm.prefill(eng.fw, cache, prompt[None],
                                  torch.tensor([T0], dtype=torch.int32), cfg)
        res = flowlm.generate_latents(eng.fw, cache, x, noise[None], cfg, F, 1,
                                      eos_enabled=False)
    lat, eos = ref.teacher_forced(prompt, noise, res.latents[0])
    assert rel(res.latents[0], lat) < TOL
    assert rel(res.eos_logits[0], eos) < TOL


@pytest.mark.parametrize("T", [1, CHUNK - 1, CHUNK + 3])
def test_chunked_prefill_equals_the_recurrence(system, T):
    """A Mamba layer's chunked prompt pass over two back-padded rows (T and
    T - 1 columns, at least 1) against the port's recurrence position by
    position from a zero state: outputs at the valid positions, and each
    row's final SSM state and conv window, at its own length."""
    sysm, _ = system
    cfg = sysm.engine.flowlm_cfg
    mw = sysm.engine.fw.hybrid.mamba
    u = torch.randn(2, T, cfg.d_model, generator=torch.Generator().manual_seed(T))
    lengths = torch.tensor([T, max(T - 1, 1)], dtype=torch.int32)
    with torch.inference_mode():
        out, ssm, conv = hybrid.mamba_prefill(mw, 1, u, lengths, cfg)
        s_shape, c_shape = hybrid.state_shapes(cfg, 2)
        s, c = torch.zeros(s_shape[1:]), torch.zeros(c_shape[1:])
        steps = []
        for t in range(T):
            steps.append(hybrid.mamba_step(mw, 1, u[:, t], s, c, cfg))
            for b in range(2):
                if t == lengths[b] - 1:
                    assert rel(s[b], ssm[b]) < 1e-5 and torch.allclose(c[b], conv[b])
    rec = torch.stack(steps, 1)
    for b in range(2):
        n = int(lengths[b])
        assert rel(out[b, :n], rec[b, :n]) < 1e-5


# -- the batcher's slots ----------------------------------------------------------


def _requests(sysm, n, seed):
    """n requests of 6-9 frames with their own host noise (rng.frame_noise
    is seeded per rid; fixed noise makes a request the same in any batcher)."""
    rng = np.random.default_rng(seed)
    cfg = sysm.engine.flowlm_cfg
    out = []
    for i in range(n):
        frames = int(rng.integers(6, 10))
        out.append(dict(ids=rng.integers(1, cfg.vocab, size=int(rng.integers(2, 6))).astype(
            np.int32), noise=(rng.standard_normal((frames, cfg.latent_dim)) * 0.8).astype(
            np.float32), max_frames=frames, voice=i % 2))
    return out


def serve(eng, sysm, reqs, slots=1, **kw):
    b = ContinuousBatcher(eng, slots=slots, max_len=48, admit_chunk=2, prefix_budget=16,
                          max_num_steps=1, collect_pcm=True, noise_budget=32, **kw)
    vidx = [b.register_voice(f"v{i}", sysm.voices[i].float().numpy()) for i in range(2)]
    for rid, r in enumerate(reqs):
        b.enqueue(Request(rid=rid, prefix=None, noise=r["noise"], max_frames=r["max_frames"],
                          eos_after=0, num_steps=1, eos_threshold=np.float32(1e30),
                          eos_min_frames=1, ids=r["ids"], voice_idx=vidx[r["voice"]], temp=0.7))
    return b, b.drain()


def test_reused_slot_gives_the_frames_of_a_fresh_one(system, monkeypatch):
    """One slot serves request A, then B: B's PCM equals B's alone in a
    fresh batcher (8 LSB: B's decode columns sit elsewhere in the ring).
    With the admission's state write left out, B reads A's state and
    misses."""
    sysm, _ = system
    a, b = _requests(sysm, 2, 5)
    _, both = serve(sysm.engine, sysm, [a, b], frames_per_step=4)
    _, alone = serve(sysm.engine, sysm, [b], frames_per_step=4)
    assert both[1].frames == alone[0].frames == b["max_frames"]
    diff = np.abs(both[1].pcm_i16.astype(int) - alone[0].pcm_i16.astype(int)).max()
    assert diff <= 8
    monkeypatch.setattr(hybrid, "write_state", lambda cache, rows, state: None)
    _, stale = serve(sysm.engine, sysm, [a, b], frames_per_step=4)
    assert np.abs(stale[1].pcm_i16.astype(int) - alone[0].pcm_i16.astype(int)).max() > 8 * 8


def test_replayed_hybrid_step_equals_eager(system, monkeypatch):
    """The batcher's k-frame shard step of the hybrid (Mamba states advanced
    in place, the grouped decode attention) replayed through ReplayOnCPU:
    PCM bit-equal to the eager batcher's, with slots reused."""
    sysm, _ = system
    reqs = _requests(sysm, 6, 9)
    monkeypatch.setattr(batching, "GraphCache", ReplayOnCPU)
    eng = copy.copy(sysm.engine)          # the same weights, its loops replayed
    eng._graphs_on, eng._graphs = True, ReplayOnCPU()
    b, got = serve(eng, sysm, reqs, slots=2, frames_per_step=2)
    _, want = serve(sysm.engine, sysm, reqs, slots=2, frames_per_step=2)
    for rid in range(len(reqs)):
        assert got[rid].frames == want[rid].frames > 0
        np.testing.assert_array_equal(got[rid].pcm_i16, want[rid].pcm_i16)
    assert b._graphs.calls["replay"] > 0


def test_offline_replayed_loop_equals_eager(system):
    """The offline EOS loop in replayed chunks (a chunk past every stream's
    end gated: the Mamba states must not move) equals the per-frame loop."""
    sysm, ref = system
    eng = sysm.engine
    cfg = eng.flowlm_cfg
    prompts = [ref.prompt([3, 4, 5], sysm.voices[0]), ref.prompt([7, 8], sysm.voices[1])]
    T0 = max(p.shape[0] for p in prompts)
    x = torch.zeros(2, T0, cfg.d_model)
    for i, p in enumerate(prompts):
        x[i, :p.shape[0]] = p
    lengths = torch.tensor([p.shape[0] for p in prompts], dtype=torch.int32)
    noise = torch.randn(2, 12, cfg.latent_dim, generator=torch.Generator().manual_seed(3))
    budgets = torch.tensor([11, 6], dtype=torch.int32)
    outs = []
    with torch.inference_mode():
        for graphs in (None, ReplayOnCPU()):
            cache, x0 = flowlm.prefill_init(eng.fw, x, lengths, cfg, T0 + 12, graphs=graphs)
            res = flowlm.generate_latents_while(eng.fw, cache, x0, noise, cfg, 12, 1,
                                                eos_threshold=1e30,
                                                max_frames_per_stream=budgets, graphs=graphs)
            outs.append((res.latents.clone(), res.frames_used.clone(), cache.ssm.clone()))
    (lat_e, fr_e, ssm_e), (lat_g, fr_g, ssm_g) = outs
    assert fr_e.tolist() == fr_g.tolist() == [11, 6]
    assert torch.equal(lat_e, lat_g) and torch.equal(ssm_e, ssm_g)


# -- the grouped decode attention -------------------------------------------------


@pytest.mark.parametrize("group", [1, 4])
def test_grouped_decode_attention_equals_its_plain_version(group):
    """decode_attention_masked over a cache of H / G KV heads equals
    multi-head attention over the cache with each KV head repeated for its
    G query heads (1e-6: the same f32 products, summed alike), at the
    hybrid's scale; the kernel's wrapper on a CPU tensor is the plain
    version bit for bit, and a group of 1 at the default scale is the
    original formula."""
    g = torch.Generator().manual_seed(group)
    B, T, H, D = 3, 20, 8, 64
    q = torch.randn(B, H, D, generator=g)
    k, v = (torch.randn(B, T, H // group, D, generator=g) for _ in range(2))
    mask = torch.rand(B, T, generator=g) < 0.6
    mask[0] = False                               # a row with no valid column
    scale = 0.015625
    got = tattn.decode_attention_masked(q, k, v, mask, scale)
    kr, vr = (t.repeat_interleave(group, dim=2) for t in (k, v))
    s = torch.einsum("bhd,bthd->bht", q, kr) * scale
    p = torch.softmax(torch.where(mask[:, None], s, torch.tensor(-1e30)), dim=-1)
    want = torch.einsum("bht,bthd->bhd", p, vr)
    assert rel(got, want) < 1e-6
    assert torch.equal(tda.decode_attention(q, k, v, mask, scale), got)
    if group == 1:
        assert torch.equal(tattn.decode_attention_masked(q, k, v, mask),
                           tattn.decode_attention_masked(q, k, v, mask, D ** -0.5))


def test_the_kernel_takes_its_groups_and_refuses_others():
    """The wrapper's checks, on meta tensors (no card): 32 query heads over
    8 KV heads pass the shape checks; 24 over 8 (a group of 3) is refused."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    k = torch.empty(4, 64, 8, 64, **meta)
    mask = torch.empty(4, 64, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tda._check(torch.empty(4, 32, 64, **meta), k, k, mask)
    with pytest.raises(ValueError, match="query heads per KV head"):
        tda._check(torch.empty(4, 24, 64, **meta), k, k, mask)


# -- the cache's state and the config -------------------------------------------


def test_cache_holds_the_state_beside_the_kv(system):
    sysm, _ = system
    cfg = sysm.engine.flowlm_cfg
    from ptts_torch.utils import timing
    before = timing.counters().get("ssm.state_bytes", 0)
    cache = flowlm.make_cache(cfg, 5, 24, torch.float32)
    assert tuple(cache.k.shape) == (1, 5, 24, 2, 8)
    assert tuple(cache.ssm.shape) == (2, 5, 4, 16, 8) and cache.ssm.dtype == torch.float32
    assert tuple(cache.conv.shape) == (2, 5, 3, 64 + 16)
    grew = timing.counters()["ssm.state_bytes"] - before
    assert grew == H.state_bytes(tiny_cfg()["flowlm"], 5, "f32")


def test_pocket_configs_are_unchanged():
    from ptts_torch.config import FlowLMConfig, is_hybrid
    cfg = FlowLMConfig()
    assert not is_hybrid(cfg) and cfg.kv_heads == cfg.num_heads == 16
    assert cfg.attention_layers == tuple(range(6)) and cfg.attn_scale == 0.125
    with pytest.raises(ValueError, match="layer_types"):
        FlowLMConfig(layer_types=("mamba", "conv"), num_layers=2)
