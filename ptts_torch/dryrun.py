"""Dry-run entry points of the port (counterpart of __graft_entry__.py).

    entry(device)               -> (fn, example_args): the full-size FlowLM
                                   frame step at B = 8 (out_norm -> EOS ->
                                   LSD flow matching -> input_linear ->
                                   KV-cached decode step)
    dryrun_multichip(n, device) -> the offline pipeline and the continuous
                                   batcher, sharded over an n-position mesh

    python -c "from ptts_torch.dryrun import dryrun_multichip; dryrun_multichip(4)"

Weights are ptts_torch.synth's seeded random tensors, built in memory. The
dry run's models are tiny, as in __graft_entry__.py, except that every
attention head is 64 wide: the CUDA kernels are built for that head width
only, and the dry run exists to run them (B1 in the prefill and at every
admission, B2 in the offline Mimi decode) under a mesh.
"""

from __future__ import annotations

import types
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import convert, synth
from .config import FlowLMConfig, KernelFlags, MimiConfig
from .models import flowlm, mimi
from .ops.norms import layernorm
from .parallel import mesh as pmesh

DRY_FLOWLM = FlowLMConfig(vocab=17, text_dim=128, d_model=128, num_heads=2, head_dim=64,
                          num_layers=2, hidden=256, latent_dim=8, flow_dim=32, flow_depth=2,
                          time_freqs=8)
DRY_MIMI = MimiConfig(latent_dim=8, d_model=128, num_heads=2, head_dim=64, num_layers=1,
                      hidden=256, context=8, upsample_kernel=4, upsample_stride=2, n_filters=4,
                      ratios=(2, 2), kernel_size=3, last_kernel_size=3)


class _Tensors:
    """The lookup interface of io.safetensors.SafetensorsFile
    (find, tensors, get_f32) over an in-memory dict of arrays."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self._arrays = arrays
        self.tensors = [types.SimpleNamespace(name=n) for n in arrays]
        self._by_name = {t.name: t for t in self.tensors}

    def find(self, name: str):
        return self._by_name.get(name)

    def get_f32(self, t) -> np.ndarray:
        return np.asarray(self._arrays[t.name], np.float32)


def _normal(seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return lambda *shape: rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _random_flowlm(cfg: FlowLMConfig, seed: int, device) -> "convert.TensorTree":
    """FlowLM weights of synth's schema and distribution on ``device``, f32."""
    host = flowlm.load_weights(_Tensors(synth.flowlm_tensors(cfg, _normal(seed))), cfg)
    return convert.flowlm_weights(host, cfg, torch.float32, device)


def _random_mimi(cfg: MimiConfig, seed: int, device) -> "convert.TensorTree":
    host = mimi.load_weights(_Tensors(synth.mimi_tensors(cfg, _normal(seed))), cfg)
    return convert.mimi_weights(host, cfg, torch.float32, device)


def _frame_step_fn(cfg: FlowLMConfig):
    """One full generation frame for B streams (the serving hot loop)."""

    def frame_step(w, cache, x, noise, time_embs):
        normed = layernorm(x, w.out_norm_w, w.out_norm_b, cfg.ln_eps)
        eos = flowlm.eos_logit(w, normed)
        latent, _ = flowlm.lsd_decode(w, normed, time_embs, noise, cfg)
        cache, x = flowlm.decode_step(w, cache, flowlm._linear(w.input_linear, None, latent), cfg)
        return cache, x, latent, eos

    return frame_step


def entry(device="cuda"):
    """The full-size FlowLM frame step at batch 8 on ``device``, with
    example arguments: a cache holding a 64-column prompt."""
    cfg = FlowLMConfig()
    return _frame_step_fn(cfg), _frame_step_args(cfg, device)


def _frame_step_args(cfg: FlowLMConfig, device) -> tuple:
    """entry()'s example arguments for ``cfg``: seeded weights, a B = 8
    cache past a 64-column prompt, zero x and noise, one Euler step."""
    B, T0, MAXLEN = 8, 64, 192
    dev = pmesh.normalize_device(device)
    w = _random_flowlm(cfg, 0, dev)
    cache = flowlm.make_cache(cfg, B, MAXLEN, torch.float32, dev)
    cache.prefix_len.fill_(T0)
    cache.start.fill_(T0)
    cache = flowlm.seek(cache, T0, T0)
    x = torch.zeros(B, cfg.d_model, device=dev)
    noise = torch.zeros(B, cfg.latent_dim, device=dev)
    time_embs = flowlm.lsd_time_embeds(w, 1, cfg)
    return w, cache, x, noise, time_embs


@torch.inference_mode()
def sharded_generate(mesh: pmesh.Mesh, fws, mws, prefix: torch.Tensor, lengths: torch.Tensor,
                     noise: torch.Tensor, cfg: FlowLMConfig, mcfg: MimiConfig,
                     frames: int) -> Tuple[List[flowlm.GenResult], List[torch.Tensor]]:
    """The offline pipeline per mesh position: prefill (B1),
    generate_latents, scale_latents and, when ``mws`` is given, mimi.decode
    (B2), each position on its own device with its weights (``fws``/``mws``
    from shard_weights). prefix [B, T0, d], lengths [B], noise [B, frames,
    latent]; B divides over the mesh. Returns the per-position GenResults
    and PCM [B / n, frames * frame_samples] pieces."""
    B, T0, _ = prefix.shape
    caches = pmesh.shard_cache(mesh, flowlm.make_cache(cfg, B, T0 + frames))
    pieces = zip(mesh.device_list, caches, pmesh.shard_batch_array(mesh, prefix),
                 pmesh.shard_batch_array(mesh, lengths), pmesh.shard_batch_array(mesh, noise))
    results, pcm = [], []
    for dev, cache, px, ln, nz in pieces:
        with pmesh.on_device(dev):
            cache, x0 = flowlm.prefill(fws[dev], cache, px, ln, cfg)
            res = flowlm.generate_latents(fws[dev], cache, x0, nz, cfg, max_frames=frames,
                                          num_steps=1, eos_enabled=True)
            results.append(res)
            if mws is not None:
                pcm.append(mimi.decode(mws[dev], flowlm.scale_latents(fws[dev], res.latents),
                                       mcfg))
    return results, pcm


def _devices(n: int, device) -> List[torch.device]:
    kind = torch.device(device).type
    if kind != "cuda":
        return [torch.device(device)] * n
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if avail == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device is visible")
    if avail >= n:
        return [torch.device("cuda", i) for i in range(n)]
    print(f"dryrun_multichip: {avail} CUDA device(s) for {n} mesh positions; "
          f"every position on cuda:0")
    return [torch.device("cuda", 0)] * n


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _on_mesh(parts: Sequence[torch.Tensor], mesh: pmesh.Mesh, what: str) -> None:
    got = [p.device for p in parts]
    _check(got == mesh.device_list, f"{what}: pieces on {got}, mesh {mesh.device_list}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded pipeline once over an ``n_devices``-position mesh:
    the offline path (prefill with B1, generate_latents, scale_latents,
    mimi.decode with B2) on a 1-D mesh and, for n >= 4 and even, on a
    2-host (dcn, batch) mesh; a ContinuousBatcher sharded over the first 4
    positions as 2 host groups x 2 (6 requests through 4 slots, odd ones by
    ids with device noise, even ones by host prefix with host noise); and
    spec_admit with pipeline=True over those 4 positions as a 1-D mesh.
    ``device="cpu"`` repeats the CPU device; on CUDA with fewer cards than
    positions, cuda:0 repeats."""
    from .runtime.batching import ContinuousBatcher, Request

    devices = _devices(n_devices, device)
    mesh = pmesh.make_mesh(devices)
    cfg, mcfg = DRY_FLOWLM, DRY_MIMI
    B, T0, FRAMES = 2 * n_devices, 8, 2
    fw, mw = _random_flowlm(cfg, 0, devices[0]), _random_mimi(mcfg, 1, devices[0])
    prefix = torch.zeros(B, T0, cfg.d_model)
    lengths = torch.full((B,), T0, dtype=torch.int32)
    noise = torch.zeros(B, FRAMES, cfg.latent_dim)

    res, pcm = sharded_generate(mesh, pmesh.shard_weights(mesh, fw), pmesh.shard_weights(mesh, mw),
                                prefix, lengths, noise, cfg, mcfg, FRAMES)
    _on_mesh([r.latents for r in res], mesh, "latents")
    _on_mesh(pcm, mesh, "pcm")
    out = pmesh.gather_batch(pcm, device="cpu")
    _check(out.shape == (B, FRAMES * mcfg.frame_samples), f"PCM shape {tuple(out.shape)}")
    _check(bool(torch.isfinite(out).all()), "non-finite PCM")

    if n_devices % 2 or n_devices < 4:
        return
    # multi-host layout: 2 host groups x n/2 positions, the batch over both
    hmesh = pmesh.make_multihost_mesh(2, devices)
    hres, _ = sharded_generate(hmesh, pmesh.shard_weights(hmesh, fw), None, prefix, lengths,
                               noise, cfg, mcfg, FRAMES)
    _on_mesh([r.latents for r in hres], hmesh, "latents (2 hosts)")

    # the serving slot pool sharded over 2 host groups x 2 positions (its 4
    # slots fill at most 4 positions: a shard without a slot is refused)
    pool_mesh = pmesh.make_multihost_mesh(2, devices[:4])
    eng = types.SimpleNamespace(flowlm_cfg=cfg, mimi_cfg=mcfg, dtype=torch.float32, fw=fw,
                                mw=mw, device=devices[0], flags=KernelFlags(),
                                prefill_impl="auto", graphs=devices[0].type == "cuda")
    bat = ContinuousBatcher(eng, slots=4, max_len=24, admit_chunk=2, prefix_budget=T0,
                            max_num_steps=2, mesh=pool_mesh)
    rng = np.random.default_rng(0)
    vidx = bat.register_voice("dry", (0.02 * rng.standard_normal((2, cfg.d_model)))
                              .astype(np.float32))
    _check(vidx >= 0, "the voice bank refused the voice")
    for i in range(6):  # 6 requests > 4 slots: slots are reused
        if i % 2:  # prompt built on the device (admit_slots_ids), noise drawn there
            bat.enqueue(Request(rid=i, prefix=None, noise=None, noise_seed=i, temp=0.7,
                                max_frames=FRAMES, eos_after=1,
                                ids=np.arange(1, 4, dtype=np.int32), voice_idx=vidx))
        else:      # host-assembled prompt, host noise
            bat.enqueue(Request(
                rid=i, prefix=(0.02 * rng.standard_normal((T0, cfg.d_model))).astype(np.float32),
                noise=rng.standard_normal((FRAMES, cfg.latent_dim)).astype(np.float32),
                max_frames=FRAMES, eos_after=1))
    done = bat.drain()
    _check(set(done) == set(range(6)), f"finished {sorted(done)}")
    _check(all(r.frames == FRAMES and len(r.pcm_i16) == FRAMES * mcfg.frame_samples
               for r in done.values()), "a request's frames or PCM length")
    _on_mesh([sh.cache.k for sh in bat.shards], pool_mesh, "pool KV cache")
    _on_mesh([sh.done for sh in bat.shards], pool_mesh, "pool done flags")

    # speculative admission over a 1-D mesh of the same 4 positions: rows
    # chosen on each device
    bat2 = ContinuousBatcher(eng, slots=4, max_len=24, admit_chunk=2, prefix_budget=T0,
                             max_num_steps=2, mesh=pmesh.make_mesh(devices[:4]),
                             spec_admit=True, pipeline=True)
    v2 = bat2.register_voice("dry", (0.02 * rng.standard_normal((2, cfg.d_model)))
                             .astype(np.float32))
    for i in range(6):
        bat2.enqueue(Request(rid=i, prefix=None, noise=None, noise_seed=i, temp=0.7,
                             max_frames=FRAMES, eos_after=1,
                             ids=np.arange(1, 4, dtype=np.int32), voice_idx=v2))
    done2 = bat2.drain()
    _check(set(done2) == set(range(6)), f"spec_admit finished {sorted(done2)}")
    _check(all(r.frames == FRAMES for r in done2.values()), "spec_admit frames")
    _check(bat2._spec_inflight == 0 and not bat2._receipts, "spec_admit left a receipt")


if __name__ == "__main__":
    dryrun_multichip(8, "cpu")
    print("dryrun_multichip(8, 'cpu'): OK")
