"""TTSEngine: device-resident weights + the offline text -> PCM pipeline
(port of ptts_tpu/runtime/engine.py).

Weights load from the safetensors mmap to the device once, at construction,
through one packed copy (utils/packing); a bf16 engine reads FlowLM straight
to bf16 (zero-copy views of BF16-stored tensors). Prompt assembly stays on
the host in numpy; prefill, the per-frame loop and Mimi run on the engine's
device. Shape bucketing (prefix length, frame count) is kept as in the JAX
engine, so both packages compute on the same padded shapes and draw the
same host noise (rng.frame_noise).

The kernel switches (config.KernelFlags, from the environment by
flags_from_env) are resolved once at construction into ``prefill_impl`` and
``window_impl``. On a CUDA device the frame loops replay CUDA graphs
(runtime/graphs), as the JAX engine runs jitted loops: the offline loop in
chunks of flowlm.GRAPH_CHUNK frames, the serving step and the streaming
frame whole (``graphs``; ``TTSEngine(ctx, graphs=False)`` runs them
eagerly). Prefill (B1) and the offline Mimi decode (B2) stay eager. Unlike
the JAX engine there is no degradation from a failing kernel to its plain
version: on a CUDA device the chosen kernels run or the call raises, the
plain versions run only where a switch asked for them, and an engine asked
for ``cuda`` never runs on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import api
from ..config import KernelFlags
from ..io.wav import Audio
from ..models import flowlm, mimi
from ..rng import frame_noise
from ..text import estimate_frames, prepare_text
from ..utils import sanitize
from ..utils.compile_cache import enable_persistent_cache
from ..utils.timing import GLOBAL_STATS, counters, span
from .graphs import GraphCache


def flags_from_env() -> KernelFlags:
    """The kernel switches from the environment, the variables of the JAX
    package's flags_from_env: PTTS_PALLAS_PREFILL / PTTS_PALLAS_WINDOW (0 ->
    the plain version, 1 -> the kernel, unset -> auto), PTTS_DECODE_IMPL
    (auto, einsum, blocked), PTTS_LAYER_IMPL (auto, scan, unroll) and
    PTTS_VALIDATE=1 (run both decode attentions, print the maxdiff)."""
    kernel = {"0": "plain", "1": "kernel"}
    return KernelFlags(
        decode_impl=os.environ.get("PTTS_DECODE_IMPL", "auto"),
        window_impl=kernel.get(os.environ.get("PTTS_PALLAS_WINDOW", "auto"), "auto"),
        prefill_impl=kernel.get(os.environ.get("PTTS_PALLAS_PREFILL", "auto"), "auto"),
        layer_impl=os.environ.get("PTTS_LAYER_IMPL", "auto"),
        validate=os.environ.get("PTTS_VALIDATE", "0") == "1",
    )


def _host_f32(a) -> np.ndarray:
    """A host weight (f32 numpy, or a bf16 torch tensor of a bf16 load) as
    f32 numpy; a bf16 weight keeps its bf16 value, as in the JAX engine."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class GenerateOutput:
    """Single-stream result with the parity taps (--latent-out/--cond-out/
    --flow-out of the reference CLI)."""

    audio: Optional[Audio]
    latents: np.ndarray          # [used, latent_dim] raw (pre-scale) latents
    frames_used: int
    first_eos_logit: float
    first_cond: np.ndarray       # [d_model]
    first_flow: np.ndarray       # [latent_dim]


class TTSEngine:
    def __init__(self, ctx, dtype: Optional[torch.dtype] = None,
                 prefix_bucket: int = 64, frame_bucket: int = 64,
                 flags: Optional[KernelFlags] = None, graphs: Optional[bool] = None):
        """``ctx`` is a ptts_torch.api.Context; the engine runs on
        ``ctx.device``. dtype: float32 (default, the parity mode) or
        bfloat16 (PTTS_DTYPE=bf16). flags: the kernel switches (default
        flags_from_env()); a "kernel" switch on a CPU engine raises
        ValueError. graphs: replay the frame loops as CUDA graphs (default:
        on a CUDA device; True on a CPU engine raises ValueError).
        ``weights_s`` holds the seconds of the weight load: checkpoint
        read, host pack and the copy to the device."""
        if dtype is None:
            dtype = torch.bfloat16 if os.environ.get("PTTS_DTYPE") == "bf16" else torch.float32
        self.device = torch.device(ctx.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("engine asked for a CUDA device, but CUDA is not available")
        # the build directory of the kernel and host libraries
        # (PTTS_COMPILE_CACHE; utils/compile_cache)
        enable_persistent_cache()
        self.flags = flags if flags is not None else flags_from_env()
        self.prefill_impl = flowlm.resolve_prefill_impl(self.flags.prefill_impl, self.device)
        self.window_impl = mimi.resolve_window_impl(self.flags.window_impl, self.device)
        on_card = self.device.type == "cuda"
        if graphs and not on_card:
            raise ValueError(f"graphs=True: CUDA graphs need a CUDA engine, not {self.device}")
        self._graphs_on = on_card if graphs is None else bool(graphs)
        # the offline loop's captured chunks and the static buffers they read
        self._graphs = GraphCache()
        if dtype == torch.float32:
            # f32 parity: cuDNN would otherwise run the SEANet convs in TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.ctx = ctx
        self.flowlm_cfg = ctx.flowlm_cfg
        self.mimi_cfg = ctx.mimi_cfg
        self.dtype = dtype
        self.prefix_bucket = prefix_bucket
        self.frame_bucket = frame_bucket

        # a bf16 engine reads FlowLM (most of the parameters) straight to
        # bf16; Mimi keeps the f32 load (host math in its conv preparation)
        t0 = time.perf_counter()
        if dtype == torch.bfloat16:
            fw_host = flowlm.load_weights(ctx.weights, self.flowlm_cfg, dtype=torch.bfloat16)
        else:
            fw_host = flowlm.load_weights(ctx.weights, self.flowlm_cfg)
        mw_host = mimi.load_weights(ctx.weights, self.mimi_cfg)
        load = {"read": time.perf_counter() - t0, "pack": 0.0, "copy": 0.0}
        # PTTS_SANITIZE=1: a corrupt checkpoint fails here, naming the tensor
        sanitize.check_tree("load_weights(flowlm)", fw_host)
        sanitize.check_tree("load_weights(mimi)", mw_host)
        # host copies for prefix assembly (off the device path), f32 (bf16
        # values in a bf16 engine, as in the JAX engine)
        self._embed = _host_f32(fw_host["embed"])
        self._input_linear = _host_f32(fw_host["input_linear"])
        self._bos_emb = _host_f32(fw_host["bos_emb"])
        self.fw = flowlm.to_device(fw_host, dtype, self.flowlm_cfg, self.device, load)
        self.mw = mimi.to_device(mw_host, dtype, self.mimi_cfg, self.device, load)
        self.weights_s = load
        self._voice_cache: dict = {}

    @property
    def graphs(self) -> bool:
        """Whether the frame loops replay CUDA graphs: on for a CUDA engine
        unless constructed with graphs=False, and off, from the flags at
        each call, for the blocked decode attention (its trip count is a
        host int) and validate mode (it reads values back every layer)."""
        return (self._graphs_on and self.flags.decode_impl != "blocked"
                and not self.flags.validate)

    # -- prompt assembly -----------------------------------------------------

    def _voice_cond(self, voice: Optional[str]) -> Tuple[Optional[np.ndarray], int]:
        key = voice or "alba"
        if key not in self._voice_cache:
            self._voice_cache[key] = api.load_voice_conditioning(
                self.ctx.model_dir, voice, self.flowlm_cfg.d_model)
        return self._voice_cache[key]

    def _build_prefix(self, token_ids: Sequence[int],
                      cond: Optional[np.ndarray]) -> np.ndarray:
        """[T0, d_model]: voice cond frames + token embeddings + projected BOS."""
        cfg = self.flowlm_cfg
        parts = []
        if cond is not None and len(cond):
            parts.append(cond.astype(np.float32))
        ids = np.asarray(token_ids, dtype=np.int64)
        ids = np.where((ids < 0) | (ids >= cfg.vocab + 1), 0, ids)
        parts.append(self._embed[ids])
        bos = self._bos_emb @ self._input_linear.T
        parts.append(bos[None, :].astype(np.float32))
        return np.concatenate(parts, axis=0)

    # -- generation ------------------------------------------------------------

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(self.device, dtype or self.dtype)

    @torch.inference_mode()
    def generate_latents_batch(
        self,
        prefixes: List[np.ndarray],               # list of [T0_b, d_model]
        max_frames: int,
        params: api.Params,
        noise: Optional[np.ndarray] = None,       # [B, frames, latent] override
        eos_after: Optional[np.ndarray] = None,   # [B] per-stream override
        frames_each: Optional[np.ndarray] = None,  # [B] per-stream budgets
    ) -> flowlm.GenResult:
        """Prefill + frame loop for B ragged streams. The loop stops at
        each stream's true budget (``frames_each``, default max_frames) or
        EOS, whichever comes first, not at the frame bucket. With graphs
        the prompt lands in the cache the captured loop reads, and the host
        checks for the end once per flowlm.GRAPH_CHUNK frames."""
        cfg = self.flowlm_cfg
        B = len(prefixes)
        lengths = np.array([len(p) for p in prefixes], np.int32)
        T0 = _round_up(int(lengths.max()), self.prefix_bucket)
        frames = _round_up(max_frames, self.frame_bucket)

        padded = np.zeros((B, T0, cfg.d_model), np.float32)
        for b, p in enumerate(prefixes):
            padded[b, : len(p)] = p

        if noise is None:
            seed = params.seed if params.seed != -1 else int(time.time())
            noise = np.stack([
                frame_noise(seed + b, frames, cfg.latent_dim, temp=params.temp,
                            noise_clamp=params.noise_clamp)
                for b in range(B)
            ])
        elif noise.shape[1] < frames:
            pad = np.zeros((B, frames - noise.shape[1], cfg.latent_dim), np.float32)
            noise = np.concatenate([noise, pad], axis=1)
        elif noise.shape[1] > frames:
            noise = noise[:, :frames]

        budgets = np.broadcast_to(
            np.asarray(frames_each if frames_each is not None else max_frames, np.int32), (B,))
        graphs = self._graphs if self.graphs else None
        # the graph path's static cache and loop are shared by every call
        with self._graphs.lock if graphs is not None else contextlib.nullcontext():
            cache, x0 = flowlm.prefill_init(self.fw, self._tensor(padded),
                                            self._tensor(lengths, torch.int32), cfg,
                                            T0 + frames, self.prefill_impl, graphs=graphs)
            res = flowlm.generate_latents_while(
                self.fw, cache, x0, self._tensor(noise), cfg,
                max_frames=frames, num_steps=params.num_steps,
                # EOS disabled == a threshold that can never fire
                eos_threshold=params.eos_threshold if params.eos_enabled else 1e30,
                eos_min_frames=params.eos_min_frames,
                eos_after=self._tensor(eos_after if eos_after is not None else params.eos_after,
                                       torch.int32),
                max_frames_per_stream=self._tensor(budgets, torch.int32),
                flags=self.flags, graphs=graphs,
            )
        # cap frames_used at the caller's true max (bucketing may exceed it)
        capped = torch.clamp(res.frames_used, max=max_frames)
        sanitize.check_finite("generate_latents_batch", res.latents, res.eos_logits,
                              names=("latents", "eos_logits"))
        return res._replace(frames_used=capped, cache=None, x=None)

    @torch.inference_mode()
    def decode_audio_batch(self, scaled_latents: torch.Tensor) -> np.ndarray:
        """[B, F, latent_dim] scaled latents -> PCM [B, F * frame_samples] (f32)."""
        pcm = mimi.decode(self.mw, scaled_latents, self.mimi_cfg,
                          self.window_impl).float().cpu().numpy()
        sanitize.check_finite("decode_audio_batch", pcm, names=("pcm",))
        return pcm

    @torch.inference_mode()
    def generate_full(self, text: str, voice: Optional[str] = None,
                      params: Optional[api.Params] = None,
                      decode_audio: bool = True) -> GenerateOutput:
        p = (params or api.Params()).normalized()
        prepared, word_count, eos_after_guess = prepare_text(text)
        token_ids = self.ctx.tokenize(prepared)
        if p.num_frames <= 0:
            p = dataclasses.replace(p, num_frames=estimate_frames(word_count))
        if p.eos_after <= 0:
            p = dataclasses.replace(p, eos_after=eos_after_guess)
        cond, _ = self._voice_cond(voice)
        prefix = self._build_prefix(token_ids, cond)

        with span("FlowLM latents", f"{p.num_frames} frames"):
            res = self.generate_latents_batch([prefix], p.num_frames, p)
            used = int(res.frames_used[0])
        latents = res.latents[0, :used].float().cpu().numpy()

        audio = None
        if decode_audio:
            # decode on a bucketed frame count, slice after
            fbucket = min(res.latents.shape[1], _round_up(used, self.frame_bucket))
            scaled = flowlm.scale_latents(self.fw, res.latents[:, :fbucket])
            with span("Mimi decode", f"{used} frames"):
                pcm = self.decode_audio_batch(scaled)
            audio = Audio(sample_rate=p.sample_rate, channels=1,
                          samples=pcm[0, : used * self.mimi_cfg.frame_samples])

        return GenerateOutput(
            audio=audio,
            latents=latents,
            frames_used=used,
            first_eos_logit=float(res.eos_logits[0, 0]),
            first_cond=res.first_cond[0].float().cpu().numpy(),
            first_flow=res.first_flow[0].float().cpu().numpy(),
        )

    def generate(self, text: str, voice: Optional[str] = None,
                 params: Optional[api.Params] = None) -> Audio:
        out = self.generate_full(text, voice=voice, params=params)
        assert out.audio is not None
        return out.audio

    @torch.inference_mode()
    def warmup(self, batch_sizes: Sequence[int] = (1,),
               num_frames: Optional[int] = None, decode_audio: bool = True) -> float:
        """Run the pipeline once per batch size at the engine's shape buckets
        (builds the kernels, fills the allocator's pools) with EOS off, so
        that with graphs every chunk of the frame loop runs: the first
        chunk warms up, the second captures the chunk's graph, as the JAX
        engine's warm-up compiles. Returns wall seconds."""
        t0 = time.perf_counter()
        frames = num_frames if num_frames else self.frame_bucket
        p = api.Params(num_steps=1, seed=0, eos_enabled=False).normalized()
        prefix = np.zeros((self.prefix_bucket, self.flowlm_cfg.d_model), np.float32)
        for B in batch_sizes:
            res = self.generate_latents_batch([prefix] * B, frames, p)
            if decode_audio:
                self.decode_audio_batch(flowlm.scale_latents(self.fw, res.latents))
        return time.perf_counter() - t0

    def stats(self) -> dict:
        """Per-span timing summary (count, total, min, max), as the JAX
        engine reports it, over every span of the process (the engine's,
        the batcher's, the graphs'), and the tracer's counters under
        "counters"; the server's GET /stats reads it."""
        return {**GLOBAL_STATS.summary(), "counters": counters()}

    @torch.inference_mode()
    def batch_generate(self, texts: Sequence[str],
                       voices: Optional[Sequence[Optional[str]]] = None,
                       params: Optional[api.Params] = None,
                       length_buckets: int = 1) -> List[Audio]:
        """B independent utterances, run in lockstep in one batch (or, with
        ``length_buckets > 1``, in groups sorted by frame budget, each group
        stopping at its own longest stream). Stream i's noise is keyed by its
        index (seed + i), so grouping never changes a stream's output.

        Spans: ``ptts.batch_generate`` around the call; in it ``ptts.prompts``
        (tokenize, prompt assembly) and a ``ptts.group`` per length group
        (B, frames), which holds ``ptts.frame_loop`` (the call to
        generate_latents_batch and the readback of its frame counts) and
        ``ptts.mimi_decode`` (the decode and its readback)."""
        with span("ptts.batch_generate", texts=len(texts)):
            return self._batch_generate(texts, voices, params, length_buckets)

    def _batch_generate(self, texts, voices, params, length_buckets) -> List[Audio]:
        p = (params or api.Params()).normalized()
        if voices is None:
            voices = [None] * len(texts)

        prefixes, frames, eos_afters = [], [], []
        with span("ptts.prompts"):
            for text, voice in zip(texts, voices):
                prepared, wc, eos_after_guess = prepare_text(text)
                ids = self.ctx.tokenize(prepared)
                cond, _ = self._voice_cond(voice)
                prefixes.append(self._build_prefix(ids, cond))
                frames.append(p.num_frames if p.num_frames > 0 else estimate_frames(wc))
                eos_afters.append(p.eos_after if p.eos_after > 0 else eos_after_guess)

        B = len(texts)
        frames_np = np.asarray(frames, np.int32)
        eos_np = np.asarray(eos_afters, np.int32)
        G = max(1, min(length_buckets, B // 2)) if B >= 4 else 1
        if int(frames_np.max()) - int(frames_np.min()) < 16:
            G = 1  # near-uniform budgets: splitting only shrinks the GEMMs
        order = np.argsort(frames_np, kind="stable") if G > 1 else np.arange(B)
        gB = -(-B // G)
        seed = p.seed if p.seed != -1 else int(time.time())

        out: List[Optional[Audio]] = [None] * B
        for g in range(G):
            idx = order[g * gB : (g + 1) * gB]
            if idx.size == 0:
                continue
            pad = gB - idx.size if G > 1 else 0
            gidx = np.concatenate([idx, np.repeat(idx[-1:], pad)]) if pad else idx
            gmax = int(frames_np[gidx].max())
            with span("ptts.group", B=int(gidx.size), frames=gmax):
                noise = np.stack([
                    frame_noise(seed + int(i), gmax, self.flowlm_cfg.latent_dim,
                                temp=p.temp, noise_clamp=p.noise_clamp)
                    for i in gidx
                ])
                with span("ptts.frame_loop"):
                    # through self: a wrapper set on the engine sees the call
                    res = self.generate_latents_batch(
                        [prefixes[i] for i in gidx], gmax, p, noise=noise,
                        eos_after=eos_np[gidx], frames_each=frames_np[gidx])
                    used = np.minimum(res.frames_used.cpu().numpy(), frames_np[gidx])
                # vocoder at the group's own width, in 16-frame steps
                fmax = min(res.latents.shape[1], _round_up(max(int(used.max()), 1), 16))
                with span("ptts.mimi_decode"):
                    pcm = self.decode_audio_batch(
                        flowlm.scale_latents(self.fw, res.latents[:, :fmax]))
            for j, i in enumerate(idx):
                n = int(used[j]) * self.mimi_cfg.frame_samples
                out[i] = Audio(sample_rate=p.sample_rate, channels=1, samples=pcm[j, :n])
        assert all(a is not None for a in out)
        return out  # type: ignore[return-value]
