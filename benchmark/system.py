"""The system under test, built from a configuration and a seed: the port's
TTSEngine over the benchmark's weights, and the two taps the correctness
check reads (the latents each frame produced, as the frame step hands them
to the Mimi decoder and back to the next frame).

The taps patch one function each at set-up, before any graph is captured,
so a replayed step records as an eager one does:

  * ``FrameTap`` wraps ``ptts_torch.runtime.streaming.flow_frame_step``, the
    serving step's per-frame body: each call records, for the rows that
    serve the few requests the check samples, the scaled latent, the EOS
    logit, the frame index and the first two noise values, in device
    buffers of a fixed size;
  * ``OfflineTap`` wraps the engine's ``generate_latents_batch``, the
    offline entry's frame loop, and keeps a copy of each call's latents,
    EOS logits and frame counts, with the noise it was given.
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from . import weights as W

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def model_configs(cfg: dict):
    from ptts_torch.config import FlowLMConfig, MimiConfig
    m = dict(cfg["mimi"])
    m["ratios"] = tuple(m["ratios"])
    return FlowLMConfig(**cfg["flowlm"]), MimiConfig(**m)


@dataclasses.dataclass
class System:
    engine: object
    weights: Dict[str, torch.Tensor]   # the benchmark's tensors, for the reference
    voices: torch.Tensor               # [n, frames, d] in the served dtype
    cfg: dict
    device: torch.device

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg["dtype"]]


def build(cfg: dict, seed: int, device, n_voices: int, text_dir: Optional[str] = None
          ) -> System:
    """Weights and voices from ``seed`` on ``device``; the port's engine
    loads the weights through its own loader. ``text_dir``: where the text
    path's tokenizer and voice file go (the offline entry takes text)."""
    from ptts_torch.runtime.engine import TTSEngine

    dev = torch.device(device)
    w = W.make_weights(cfg, seed, dev)
    voices = W.make_voices(cfg, n_voices, seed, dev)
    fcfg, mcfg = model_configs(cfg)
    ctx = types.SimpleNamespace(device=dev, weights=W.MemCheckpoint(w), flowlm_cfg=fcfg,
                                mimi_cfg=mcfg, model_dir=None, tokenize=None)
    if text_dir is not None:
        from ptts_torch.tokenizer import load_tokenizer
        W.write_text_dir(text_dir, voices[0].float().cpu().numpy())
        tok = load_tokenizer(os.path.join(text_dir, "tokenizer.model"))
        ctx.model_dir, ctx.tokenize = text_dir, tok.encode
    engine = TTSEngine(ctx, dtype=DTYPES[cfg["dtype"]])
    ctx.weights.close()
    return System(engine=engine, weights=w, voices=voices, cfg=cfg, device=dev)


class FrameTap:
    """Device records of the frames of a few watched requests (see the
    module docstring): ``watch`` slots of [frames, latent + 4] float32
    records (scaled latent, EOS logit, frame index, first two noise values),
    and a record of which pool row serves which watched request.

    A request is watched by its first frame's noise (``watch_request``),
    which the benchmark made and hands to the program: when a row starts a
    request (frame index 0, not done) whose noise is a watched request's,
    the row is that request's until its next start, and each of its frames
    is written to the request's slot at its frame index. Every other row
    writes to a slot that is never read. The work per frame is a few small
    kernels whatever the pool's rate, and the memory a few megabytes.

    The pool's shards (``bind``) each step their own rows, on their own
    device: the row map, the watched keys and the records are per shard,
    indexed by the shard's local rows. A frame call finds its shard by the
    KV cache it is handed, and records there; ``find`` says which shard
    served each request."""

    def __init__(self, latent: int, watch: int, frames: int):
        self.latent, self.watch, self.frames = latent, watch, frames
        self.shard_of: Dict[int, int] = {}                    # a shard's cache -> its index
        self.keys: List[torch.Tensor] = []                    # per shard [watch, latent]
        self.buf: List[torch.Tensor] = []                     # per shard records
        self.row_slot: List[torch.Tensor] = []                # per shard [rows]
        self.slot_of: Dict[object, int] = {}
        self._orig = None

    def bind(self, shards) -> None:
        """Keys, records and a row map for each shard (with ``cache``,
        ``rows`` and ``device``), in shard order. Call before any frame
        runs."""
        W, L = self.watch, self.latent
        for sh in shards:
            dev = sh.device
            self.shard_of[sh.cache.k.data_ptr()] = len(self.buf)
            self.keys.append(torch.full((W, L), float("nan"), device=dev))
            buf = torch.zeros(W + 1, self.frames, L + 4, device=dev)
            buf[:, :, L + 1] = -1.0
            self.buf.append(buf)
            self.row_slot.append(torch.full((sh.rows,), W, dtype=torch.long, device=dev))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.keys + self.buf + self.row_slot)

    def watch_request(self, key, noise: np.ndarray) -> bool:
        """Watch the request ``key`` whose frame noise (in the served
        values) is ``noise`` [F, latent]; False when every slot is taken.
        Call before the request is admitted."""
        if key in self.slot_of:
            return True
        if len(self.slot_of) >= self.watch:
            return False
        i = len(self.slot_of)
        first = torch.as_tensor(np.asarray(noise[0], np.float32))
        for keys in self.keys:
            keys[i].copy_(first)
        self.slot_of[key] = i
        return True

    def record(self, cache, scaled, eos, frame_idx, done, noise) -> None:
        """The per-frame work of the shard whose KV cache is ``cache``:
        called inside the frame step, graph-safe."""
        s = self.shard_of[cache.k.data_ptr()]
        keys, buf, row_slot = self.keys[s], self.buf[s], self.row_slot[s]
        B, L, W = scaled.shape[0], self.latent, self.watch
        fi = (frame_idx.expand(B) if torch.is_tensor(frame_idx) else torch.full(
            (B,), int(frame_idx), device=scaled.device)).long()
        nz = noise.float()
        match = (nz[:, None, :] == keys[None]).all(-1)                  # [B, W]
        hit = torch.where(match.any(1), match.float().argmax(1), W)
        start = (fi == 0) & ~done
        row_slot.copy_(torch.where(start, hit, row_slot))
        keep = ~done & (fi >= 0) & (fi < self.frames)
        slot = torch.where(keep, row_slot, W)
        rec = torch.cat([scaled.float(), eos.float().reshape(B, 1), fi.float().reshape(B, 1),
                         nz[:, :2]], dim=1)
        buf.index_put_((slot, fi.clamp(0, self.frames - 1)), rec)

    def install(self) -> None:
        from ptts_torch.runtime import streaming
        self._orig = orig = streaming.flow_frame_step
        tap = self

        def flow_frame_step(w, cache, x, noise, time_embs, frame_idx, eos_step, done, *a, **k):
            out = orig(w, cache, x, noise, time_embs, frame_idx, eos_step, done, *a, **k)
            tap.record(cache, out[2], out[3], frame_idx, done, noise)
            return out

        streaming.flow_frame_step = flow_frame_step

    def uninstall(self) -> None:
        if self._orig is not None:
            from ptts_torch.runtime import streaming
            streaming.flow_frame_step = self._orig
            self._orig = None

    def find(self, requests: List[dict]) -> Dict[object, dict]:
        """For each watched request {"key", "frames"}: its frames' records,
        {"scaled" [F, latent], "eos" [F], "noise2" [F, 2]}, with the index
        of the shard that served it and that shard's device ("shard",
        "device"); missing where a frame 0..F-1 was not recorded."""
        L = self.latent
        out = {}
        for r in requests:
            i, F = self.slot_of.get(r["key"]), r["frames"]
            if i is None or F > self.frames:
                continue
            for s, buf in enumerate(self.buf):
                seg = buf[i, :F].cpu()
                if torch.equal(seg[:, L + 1], torch.arange(F, dtype=torch.float32)):
                    out[r["key"]] = {"scaled": seg[:, :L], "eos": seg[:, L],
                                     "noise2": seg[:, L + 2:], "shard": s,
                                     "device": str(buf.device)}
                    break
        return out


class OfflineTap:
    """Keeps each offline frame loop's outputs (see the module docstring)."""

    def __init__(self, engine):
        self.engine = engine
        self.calls: List[dict] = []
        self.keep = False
        orig = engine.generate_latents_batch
        tap = self

        def generate_latents_batch(prefixes, max_frames, params, noise=None, eos_after=None,
                                   frames_each=None):
            res = orig(prefixes, max_frames, params, noise=noise, eos_after=eos_after,
                       frames_each=frames_each)
            if tap.keep:
                tap.calls.append({"latents": res.latents.float().clone(),
                                  "eos": res.eos_logits.float().clone(),
                                  "frames": res.frames_used.clone(),
                                  "noise": None if noise is None else noise[:, :1, :4].copy()})
            return res

        engine.generate_latents_batch = generate_latents_batch
