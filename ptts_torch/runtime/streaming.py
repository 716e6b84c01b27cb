"""Streaming synthesis: one 80 ms int16 PCM chunk per FlowLM frame (port of
ptts_tpu/runtime/streaming.py). A StreamingSession drives B lockstep
streams:

    session = StreamingSession.start(engine, texts, voices, params)
    for chunk in session:        # chunk.pcm_i16: [B, 1920] int16 @ 24 kHz
        play(chunk)

Each step runs one FlowLM frame and one streaming-Mimi chunk on the
engine's device (fused_stream_steps at k = 1, the body the continuous
batcher runs at every k) and quantizes the chunk to int16 there.
The session's per-frame host work is one launch sequence and one readback:
the noise table is uploaded once at start and each frame's row is gathered
on the device at the frame index, a device counter (as are the KV and Mimi
ring cursors), and the chunk with its liveness flags comes back in one copy
into pinned host memory, overlapped with the next frame's device work. With
engine.graphs the frame is one CUDA graph replay (runtime/graphs), the
counterpart of the JAX package's jitted fused_stream_step. The frame body
launches the marker kernels (ops/cuda/markers) before its FlowLM frames,
before its Mimi decode and at its end, so a device trace splits every
replayed step into its FlowLM and its Mimi stretch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .. import api
from ..config import FlowLMConfig, KernelFlags
from ..models import flowlm, mimi_stream
from ..ops.cuda import markers
from ..rng import frame_noise
from ..text import estimate_frames, prepare_text
from .graphs import GraphCache


def flow_frame_step(w, cache: flowlm.KVCache, x: torch.Tensor, noise: torch.Tensor,
                    time_embs: torch.Tensor, frame_idx, eos_step: torch.Tensor,
                    done: torch.Tensor, cfg: FlowLMConfig, eos_enabled: bool,
                    eos_threshold, eos_min_frames, eos_after: torch.Tensor,
                    max_frames: Optional[torch.Tensor] = None,
                    num_steps: Optional[torch.Tensor] = None,
                    flags: KernelFlags = flowlm.DEFAULT_FLAGS):
    """One generation frame: out_norm -> EOS -> LSD -> scale_latents ->
    input_linear -> decode_step. ``time_embs`` is a shared [S, fd] table or
    per-stream [B, S_max, fd] tables with ``num_steps`` [B]; ``frame_idx``
    is a host int or [B]; the threshold and min-frames are scalars or [B];
    ``flags`` chooses the decode attention (flowlm.decode_step).
    Returns (cache, x, scaled latent, eos, eos_step, done)."""
    cache, x, latent, eos, eos_step, done, _, _ = flowlm.frame_step(
        w, cache, x, noise, time_embs, frame_idx, eos_step, done, cfg,
        eos_enabled=eos_enabled, eos_threshold=eos_threshold,
        eos_min_frames=eos_min_frames, eos_after=eos_after, max_frames=max_frames,
        num_steps=num_steps, flags=flags)
    return cache, x, flowlm.scale_latents(w, latent), eos, eos_step, done


def quantize_i16_device(pcm: torch.Tensor) -> torch.Tensor:
    """PCM quantization on the device: clamp to [-1, 1] in f32, times 32767,
    truncate toward zero; bit-equal to ptts_tpu.io.wav.quantize_i16."""
    s = torch.clamp(pcm.float(), -1.0, 1.0)
    return torch.trunc(s * 32767.0).to(torch.int16)


def _noise_rows(noise_tab: torch.Tensor, frame_idx) -> torch.Tensor:
    """Row frame_idx (clamped to the table) of each stream's [B, F, latent]
    noise table, gathered on the device: a 0-d or [B] device index, or, for
    eager callers, a host int."""
    last = noise_tab.shape[1] - 1
    if isinstance(frame_idx, int):
        return noise_tab[:, min(max(frame_idx, 0), last)]
    fi = torch.clamp(frame_idx.long(), 0, last).expand(noise_tab.shape[0])
    return torch.take_along_dim(noise_tab, fi[:, None, None], dim=1)[:, 0]


def _pack(pcm: torch.Tensor, was_done: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """Append the int16 flag columns [..., S] = was_done, [..., S+1] = done,
    so one copy carries the PCM and the step's liveness."""
    flags = torch.stack([was_done.to(torch.int16), done.to(torch.int16)], dim=-1)
    return torch.cat([pcm, flags], dim=-1)


def fused_stream_steps(fw, mw, cache: flowlm.KVCache, mimi_state, x: torch.Tensor,
                       noise_tab: torch.Tensor, time_embs: torch.Tensor, frame_idx,
                       eos_step: torch.Tensor, done: torch.Tensor, cfg: FlowLMConfig, mcfg,
                       eos_enabled: bool, eos_threshold, eos_min_frames,
                       eos_after: torch.Tensor, max_frames: Optional[torch.Tensor] = None,
                       num_steps: Optional[torch.Tensor] = None, k: int = 1,
                       emit_i16: bool = True, flags: KernelFlags = flowlm.DEFAULT_FLAGS):
    """k serving frames: k FlowLM frames (flow_frame_step, each frame's
    noise row gathered from the [B, F, latent] ``noise_tab`` at its index),
    then ONE decode_stream over all k latents (Mimi does not feed back into
    FlowLM, and a k-frame chunk equals k one-frame chunks).

    ``emit_i16`` quantizes the PCM to int16 on the device
    (quantize_i16_device) and appends two flag columns to each chunk: the
    frame's pre-step done and the post-step done of the last frame, so one
    copy carries the chunks and the liveness; else the PCM stays float, with
    no flag columns. Returns (cache, mimi_state, x, pcm [k, B, S + 2] or [k,
    B, S], eos [k, B], eos_step, done, was_done [k, B], frame_idx): chunk j
    of stream b is live iff not was_done[j, b]."""
    markers.device_mark(markers.FLOWLM, x)
    scaled_k, eos_k, wd_k = [], [], []
    for _ in range(k):
        wd_k.append(done)
        cache, x, scaled, eos, eos_step, done = flow_frame_step(
            fw, cache, x, _noise_rows(noise_tab, frame_idx), time_embs, frame_idx,
            eos_step, done, cfg, eos_enabled, eos_threshold, eos_min_frames, eos_after,
            max_frames, num_steps, flags)
        scaled_k.append(scaled)
        eos_k.append(eos)
        frame_idx = frame_idx + 1
    markers.device_mark(markers.MIMI, x)
    mimi_state, pcm = mimi_stream.decode_stream(mw, mimi_state, torch.stack(scaled_k, 1), mcfg)
    B = pcm.shape[0]
    pcm_k = pcm.reshape(B, k, -1).transpose(0, 1)                # [k, B, S]
    wd_k = torch.stack(wd_k)
    if emit_i16:
        pcm_k = _pack(quantize_i16_device(pcm_k), wd_k, done.expand_as(wd_k))
    markers.device_mark(markers.END, x)
    return (cache, mimi_state, x, pcm_k, torch.stack(eos_k), eos_step, done, wd_k,
            frame_idx)


@dataclasses.dataclass
class StreamChunk:
    pcm_i16: np.ndarray      # [B, frame_samples] int16, quantized on the device
    frame_index: int
    active: np.ndarray       # [B] bool: the stream is still producing at this frame
    eos_logits: np.ndarray   # [B]

    @property
    def pcm(self) -> np.ndarray:
        """[B, frame_samples] f32 view (i16 / 32767)."""
        return self.pcm_i16.astype(np.float32) / np.float32(32767.0)


class StreamingSession:
    """B lockstep streams emitting one 80 ms chunk per step.

    Double-buffered by default (``pipeline=True``): ``step()`` dispatches
    frame N+1 before it waits for frame N's chunk. Each dispatched frame
    copies its packed chunk to its own pinned host buffer (non-blocking) and
    records a CUDA event; ``step()`` waits on that event only. On a CPU
    device the copy is simply synchronous. The output is chunk-identical to
    ``pipeline=False``; at most one frame of device work is wasted when
    every stream ends at once.

    All state lives in inference tensors: construction, ``_dispatch`` and
    ``step`` each run under ``torch.inference_mode()``, so a caller may
    iterate from plain code (Context.stream is such a generator). With
    engine.graphs the frame runs eagerly at the session's first two
    dispatches (graphs.WARMUP: the first chunk never waits for a capture),
    is captured at the third and replayed from then on; its parameters are
    fixed for the session, so the graph belongs to the session.
    """

    @torch.inference_mode()
    def __init__(self, engine, prefixes: List[np.ndarray], max_frames: int,
                 params: "api.Params", eos_after: np.ndarray, pipeline: bool = True,
                 frames_each: Optional[np.ndarray] = None):
        self.engine = engine
        cfg = engine.flowlm_cfg
        self.cfg = cfg
        self.params = params
        self.max_frames = max_frames
        B = len(prefixes)
        self.batch = B
        # per-stream budgets: a stream stops at ITS num_frames, not the max
        self.frames_each = engine._tensor(
            frames_each if frames_each is not None else np.full(B, max_frames), torch.int32)

        lengths = np.array([len(p) for p in prefixes], np.int32)
        T0 = int(lengths.max())  # the unrounded prefix length, as in the JAX session
        padded = np.zeros((B, T0, cfg.d_model), np.float32)
        for b, p in enumerate(prefixes):
            padded[b, : len(p)] = p

        seed = params.seed if params.seed != -1 else int(time.time())
        self._noise_dev = engine._tensor(np.stack([
            frame_noise(seed + b, max_frames, cfg.latent_dim, temp=params.temp,
                        noise_clamp=params.noise_clamp)
            for b in range(B)
        ]))
        cache = flowlm.make_cache(cfg, B, T0 + max_frames, engine.dtype, engine.device)
        self.cache, self.x = flowlm.prefill(engine.fw, cache, engine._tensor(padded),
                                            engine._tensor(lengths, torch.int32), cfg,
                                            engine.prefill_impl)
        self.time_embs = flowlm.lsd_time_embeds(engine.fw, params.num_steps, cfg)
        self.mimi_state = mimi_stream.init_state(engine.mw, engine.mimi_cfg, B, engine.dtype)
        self.eos_step = torch.full((B,), -1, dtype=torch.int32, device=engine.device)
        self.done = torch.zeros(B, dtype=torch.bool, device=engine.device)
        self.eos_after = engine._tensor(eos_after, torch.int32)
        self.frame = 0                      # next frame index to dispatch
        self._frame_dev = torch.zeros((), dtype=torch.int32, device=engine.device)
        self._graphs = GraphCache() if engine.graphs else None
        if self._graphs is not None:
            # replays advance the device cursor without the host seeing it
            self.cache = dataclasses.replace(self.cache, cursor_host=None)
        self.frames_used = np.zeros(B, np.int64)
        self.pipeline = pipeline
        self._pending = None                # (frame index, readback slot) not yet read
        self._host_all_done = False
        # one readback slot per frame in flight: packed int16 PCM + flags, f32 EOS logits
        S = engine.mimi_cfg.frame_samples
        on_card = engine.device.type == "cuda"
        self._slots = [
            (torch.empty((B, S + 2), dtype=torch.int16, pin_memory=on_card),
             torch.empty(B, dtype=torch.float32, pin_memory=on_card),
             torch.cuda.Event() if on_card else None)
            for _ in range(2)
        ]

    @classmethod
    def start(cls, engine, texts: Sequence[str],
              voices: Optional[Sequence[Optional[str]]] = None,
              params: Optional["api.Params"] = None,
              pipeline: bool = True) -> "StreamingSession":
        p = (params or api.Params()).normalized()
        if voices is None:
            voices = [None] * len(texts)
        prefixes, frames, eos_afters = [], [], []
        for text, voice in zip(texts, voices):
            prepared, wc, eos_after_guess = prepare_text(text)
            ids = engine.ctx.tokenize(prepared)
            cond, _ = engine._voice_cond(voice)
            prefixes.append(engine._build_prefix(ids, cond))
            frames.append(p.num_frames if p.num_frames > 0 else estimate_frames(wc))
            eos_afters.append(p.eos_after if p.eos_after > 0 else eos_after_guess)
        return cls(engine, prefixes, max(frames), p, np.asarray(eos_afters, np.int32),
                   pipeline=pipeline, frames_each=np.asarray(frames, np.int32))

    @property
    def all_done(self) -> bool:
        """No device read: whenever no frame is pending, the done flags of the
        last chunk read are the device's."""
        if self._pending is not None and not self._host_all_done:
            return False
        return self.frame >= self.max_frames or self._host_all_done

    def _frame_body(self):
        """One frame, the session's state updated in place; returns the
        packed int16 chunk and the f32 EOS logits to read back."""
        engine = self.engine
        cache, _, x, pcm, eos, eos_step, done, _, frame_idx = fused_stream_steps(
            engine.fw, engine.mw, self.cache, self.mimi_state, self.x, self._noise_dev,
            self.time_embs, self._frame_dev, self.eos_step, self.done, self.cfg,
            engine.mimi_cfg, bool(self.params.eos_enabled), self.params.eos_threshold,
            self.params.eos_min_frames, self.eos_after, self.frames_each, flags=engine.flags)
        self.cache = cache  # the same tensors; the eager path's cursor mirror advanced
        for dst, src in ((self.x, x), (self.eos_step, eos_step), (self.done, done),
                         (self._frame_dev, frame_idx)):
            dst.copy_(src)
        return pcm[0], eos[0].float()

    @torch.inference_mode()
    def _dispatch(self) -> None:
        """Launch one frame (a graph replay with graphs on); start its
        chunk's copy to the host, which follows it on the stream."""
        if self._graphs is None:
            pcm, eos = self._frame_body()
        else:
            pcm, eos = self._graphs.run("frame", self.engine.device, self._frame_body)
        slot = self.frame % len(self._slots)
        pcm_host, eos_host, ready = self._slots[slot]
        pcm_host.copy_(pcm, non_blocking=True)
        eos_host.copy_(eos, non_blocking=True)
        if ready is not None:
            ready.record()
        self._pending = (self.frame, slot)
        self.frame += 1

    @torch.inference_mode()
    def step(self) -> StreamChunk:
        """The next 80 ms chunk; the following frame is dispatched first
        (double buffering) so its device work overlaps this readback."""
        if self.all_done:
            raise StopIteration
        if self._pending is None:
            self._dispatch()
        idx, slot = self._pending
        self._pending = None
        if self.pipeline and self.frame < self.max_frames and not self._host_all_done:
            self._dispatch()
        pcm_host, eos_host, ready = self._slots[slot]
        if ready is not None:
            ready.synchronize()
        packed = pcm_host.numpy()
        S = packed.shape[1] - 2
        was_done, done = packed[:, S] != 0, packed[:, S + 1] != 0
        self._host_all_done = bool(done.all())
        active = ~was_done
        self.frames_used += active
        return StreamChunk(pcm_i16=packed[:, :S].copy(), frame_index=idx, active=active,
                           eos_logits=eos_host.numpy().copy())

    def __iter__(self) -> Iterator[StreamChunk]:
        while not self.all_done:
            yield self.step()
