"""Public API of the PyTorch port, mirroring the reference's ptts.h (the
port's counterpart of ptts_tpu/api.py).

ptts.h symbol -> here:
  ptts_load_dir / ptts_free          -> load_dir() / Context (GC'd)
  ptts_params / PTTS_PARAMS_DEFAULT  -> Params (same defaults, ptts.h:27-40)
  ptts_get_error                     -> exceptions (PttsError)
  ptts_print_info / list / find      -> Context.info / list_tensors / find_tensors
  ptts_verify_weights                -> Context.verify_weights
  ptts_tokenize / ptts_token_piece   -> Context.tokenize / token_piece
  ptts_load_voice_conditioning       -> load_voice_conditioning
  ptts_generate                      -> Context.generate (engine-backed)
  ptts_generate_dummy                -> generate_dummy
  ptts_audio_save_wav                -> io.wav.save_wav

    from ptts_torch import api
    ctx = api.load_dir(model_dir, device="cuda")
    audio = ctx.generate("Hello world!", params=api.Params(seed=1))
    for chunk in ctx.stream("Hello world!"):   # one 80 ms Audio per frame
        play(chunk.pcm_i16)
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_FLOWLM, DEFAULT_MIMI, FlowLMConfig, MimiConfig
from .io.safetensors import SafetensorsFile
from .io.wav import Audio, audio_create
from .tokenizer import load_tokenizer
from .verify import VerifyReport, verify_weights

DEFAULT_SAMPLE_RATE = 24000
PREFERRED_WEIGHTS = "tts_b6369a24.safetensors"


class PttsError(RuntimeError):
    """API error (the reference reports these via ptts_get_error())."""


@dataclasses.dataclass
class Params:
    """Generation parameters; defaults match PTTS_PARAMS_DEFAULT (ptts.h:40)."""

    sample_rate: int = DEFAULT_SAMPLE_RATE
    num_steps: int = 1
    num_frames: int = 0          # 0 = auto (estimate_frames)
    seed: int = -1               # -1 = random (time-based)
    temp: float = 0.7
    noise_clamp: float = 0.0
    eos_enabled: bool = True
    eos_threshold: float = -4.0
    eos_min_frames: int = 1
    eos_after: int = 0           # 0 = auto (from prepare_text)

    def normalized(self) -> "Params":
        """Clamping rules from ptts_generate (ptts.c:1018-1025)."""
        p = dataclasses.replace(self)
        p.num_frames = max(p.num_frames, 0)
        p.num_steps = max(p.num_steps, 1)
        p.eos_min_frames = max(p.eos_min_frames, 1)
        p.eos_after = max(p.eos_after, 0)
        if p.sample_rate <= 0:
            p.sample_rate = DEFAULT_SAMPLE_RATE
        if p.temp < 0.0:
            p.temp = 1.0
        return p


# ---------------------------------------------------------------------------
# File discovery (ptts.c:82-213)
# ---------------------------------------------------------------------------


def find_weights_file(model_dir: str) -> Optional[str]:
    if model_dir.endswith(".safetensors") and os.path.isfile(model_dir):
        return model_dir
    if not os.path.isdir(model_dir):
        return None
    preferred = os.path.join(model_dir, PREFERRED_WEIGHTS)
    if os.path.isfile(preferred):
        return preferred
    for name in sorted(os.listdir(model_dir)):
        if name.startswith("."):
            continue
        if name.endswith(".safetensors"):
            path = os.path.join(model_dir, name)
            if os.path.isfile(path):
                return path
    return None


def find_tokenizer_file(model_dir: str) -> Optional[str]:
    base = os.path.dirname(model_dir) if model_dir.endswith(".safetensors") else model_dir
    cand = os.path.join(base or ".", "tokenizer.model")
    return cand if os.path.isfile(cand) else None


def voice_is_disabled(voice: Optional[str]) -> bool:
    return voice in ("none", "off", "null")


def resolve_voice_path(model_dir: Optional[str], voice: Optional[str]) -> Optional[str]:
    """Voice name/path resolution (ptts.c:147-213)."""
    name = voice if voice else "alba"
    if voice_is_disabled(name):
        return None
    if os.path.isfile(name):
        return name
    if not model_dir:
        return None
    base = os.path.dirname(model_dir) if model_dir.endswith(".safetensors") else model_dir
    candidates = []
    if "/" in name or name.endswith(".safetensors"):
        candidates.append(os.path.join(base, name))
    candidates += [
        os.path.join(base, "embeddings", name + ".safetensors"),
        os.path.join(base, "voices", name + ".safetensors"),
        os.path.join(base, name + ".safetensors"),
    ]
    for cand in candidates:
        if os.path.isfile(cand):
            return cand
    return None


def load_voice_conditioning(
    model_dir: Optional[str], voice: Optional[str], d_model: int = 1024
) -> Tuple[Optional[np.ndarray], int]:
    """Read the audio_prompt tensor ([1, N, d] or [N, d]) from a voice file
    (ptts.c:293-364). Returns (cond [N, d] f32 or None, N)."""
    name = voice if voice else "alba"
    if voice_is_disabled(name):
        return None, 0
    resolved = resolve_voice_path(model_dir, name)
    if resolved is None:
        raise PttsError(
            "Voice prompt not found (run download_model.py --voice alba or pass --voice PATH)"
        )
    with SafetensorsFile(resolved) as sf:
        t = sf.find("audio_prompt")
        if t is None:
            raise PttsError("Voice prompt missing audio_prompt tensor")
        if t.ndim == 3:
            if t.shape[0] != 1:
                raise PttsError("Voice prompt batch dimension must be 1")
            frames, dim = t.shape[1], t.shape[2]
        elif t.ndim == 2:
            frames, dim = t.shape
        else:
            raise PttsError("Voice prompt has unexpected rank")
        if dim != d_model:
            raise PttsError("Voice prompt has unexpected embedding dim")
        cond = sf.get_f32(t).reshape(frames, dim)
    return cond, int(frames)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


class Context:
    """Model directory handle: weights file + tokenizer (ptts_ctx analogue),
    whose engine runs on ``device`` ("cuda" or "cpu"; an engine asked for
    "cuda" raises when CUDA is not available).

    The engine (device weights + the PyTorch pipeline) is built lazily on
    first generate and cached -- the expensive part happens once, not per
    call.
    """

    def __init__(self, model_dir: str,
                 flowlm_cfg: FlowLMConfig = DEFAULT_FLOWLM,
                 mimi_cfg: MimiConfig = DEFAULT_MIMI, device="cuda"):
        weights_path = find_weights_file(model_dir)
        if weights_path is None:
            raise PttsError("No .safetensors file found in model directory")
        self.model_dir = model_dir
        self.weights_path = weights_path
        self.weights = SafetensorsFile(weights_path)
        self.flowlm_cfg = flowlm_cfg
        self.mimi_cfg = mimi_cfg
        self.sample_rate = DEFAULT_SAMPLE_RATE

        self.tokenizer_path = find_tokenizer_file(model_dir)
        self.tokenizer = None  # NativeTokenizer or SentencePieceModel
        if self.tokenizer_path:
            try:
                self.tokenizer = load_tokenizer(self.tokenizer_path)
            except (ValueError, OSError):
                self.tokenizer_path = None

        self.device = torch.device(device)
        self._engine = None

    # -- introspection ----------------------------------------------------

    def info(self) -> str:
        lines = [
            "Pocket-TTS model info",
            f"  Weights: {self.weights_path}",
            f"  Tokenizer: {self.tokenizer_path or '(not found)'}",
        ]
        if self.tokenizer:
            lines.append(f"  Vocab size: {self.tokenizer.vocab_size}")
        lines.append(f"  Tensors: {self.weights.num_tensors}")
        lines.append(f"  Sample rate (default): {self.sample_rate}")
        return "\n".join(lines)

    def list_tensors(self) -> str:
        return self.weights.format_all()

    def find_tensors(self, substr: str) -> List[str]:
        return [
            self.weights.format_tensor(t)
            for t in self.weights.tensors
            if substr in t.name
        ]

    def verify_weights(self) -> VerifyReport:
        return verify_weights(self.weights, self.flowlm_cfg, self.mimi_cfg)

    # -- tokenization ------------------------------------------------------

    def tokenize(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise PttsError("Tokenizer not loaded (tokenizer.model missing or failed to parse)")
        return self.tokenizer.encode(text)

    def token_piece(self, token_id: int) -> Optional[bytes]:
        if self.tokenizer is None:
            return None
        return self.tokenizer.piece(token_id)

    # -- generation --------------------------------------------------------

    @property
    def engine(self):
        if self._engine is None:
            from .runtime.engine import TTSEngine

            self._engine = TTSEngine(self)
        return self._engine

    def generate(self, text: str, voice: Optional[str] = None,
                 params: Optional[Params] = None) -> Audio:
        """End-to-end text -> Audio (ptts_generate, ptts.c:1011-1161)."""
        return self.engine.generate(text, voice=voice, params=params)

    def stream(self, text: str, voice: Optional[str] = None,
               params: Optional[Params] = None, pipeline: bool = True) -> Iterator[Audio]:
        """Yield one 80 ms Audio chunk (int16 in ``pcm_i16``) per frame as it
        is produced, through runtime/streaming.StreamingSession; stops at
        the stream's first inactive chunk. The reference only emits the
        finished WAV (ptts.c:1011-1161)."""
        from .runtime.streaming import StreamingSession

        p = (params or Params()).normalized()
        sess = StreamingSession.start(self.engine, [text], voices=[voice],
                                      params=p, pipeline=pipeline)
        for chunk in sess:
            if not chunk.active[0]:
                break
            yield Audio(sample_rate=p.sample_rate, channels=1,
                        samples=chunk.pcm[0], pcm_i16=chunk.pcm_i16[0])

    def close(self) -> None:
        self.weights.close()


def load_dir(model_dir: str, **kwargs) -> Context:
    return Context(model_dir, **kwargs)


# ---------------------------------------------------------------------------
# Dummy generator (ptts.c:1167-1231) -- CLI/WAV plumbing test without weights
# ---------------------------------------------------------------------------


def _char_frequency(c: int) -> float:
    if c in (0x20, 0x0A, 0x09):
        return 0.0
    return 180.0 + float(c % 48) * 12.0


def generate_dummy(text: str, params: Optional[Params] = None) -> Audio:
    p = (params or Params()).normalized()
    char_sec, space_sec, tail_sec = 0.06, 0.04, 0.15
    data = text.encode("utf-8")

    total = int(tail_sec * p.sample_rate)
    for c in data:
        total += int((space_sec if c in (0x20, 0x0A, 0x09) else char_sec) * p.sample_rate)

    audio = audio_create(p.sample_rate, 1, total)
    fade = int(0.004 * p.sample_rate)
    amp = 0.2
    pos = 0
    for c in data:
        freq = _char_frequency(c)
        seg = int((space_sec if c in (0x20, 0x0A, 0x09) else char_sec) * p.sample_rate)
        if seg <= 0:
            continue
        n = min(seg, total - pos)
        if n <= 0:
            break
        s = np.arange(n, dtype=np.float32)
        env = np.ones(n, dtype=np.float32)
        if fade > 0:
            env = np.minimum(env, s / fade)
            env = np.minimum(env, np.maximum((seg - s) / fade, 0.0))
        if freq > 0.0:
            phase_inc = 2.0 * math.pi * freq / p.sample_rate
            audio.samples[pos : pos + n] = np.sin(s * phase_inc) * amp * env
        pos += n
    return audio
