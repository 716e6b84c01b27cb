"""Public API of the PyTorch port (mirror of ptts_tpu/api.py).

``Context`` is ptts_tpu's model-directory handle (weights file, tokenizer,
introspection, verify) with one difference: its engine is the PyTorch
TTSEngine on an explicit device.

    from ptts_torch import api
    ctx = api.load_dir(model_dir, device="cuda")
    audio = ctx.generate("Hello world!", params=api.Params(seed=1))
    for chunk in ctx.stream("Hello world!"):   # one 80 ms Audio per frame
        play(chunk.pcm_i16)
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch

from ptts_tpu import api as _api
from ptts_tpu.api import DEFAULT_SAMPLE_RATE, Params, PttsError, generate_dummy  # noqa: F401
from ptts_tpu.config import DEFAULT_FLOWLM, DEFAULT_MIMI, FlowLMConfig, MimiConfig
from ptts_tpu.io.wav import Audio


class Context(_api.Context):
    """Model directory handle whose engine runs on ``device`` ("cuda" or
    "cpu"; an engine asked for "cuda" raises when CUDA is not available)."""

    def __init__(self, model_dir: str, flowlm_cfg: FlowLMConfig = DEFAULT_FLOWLM,
                 mimi_cfg: MimiConfig = DEFAULT_MIMI, device="cuda"):
        super().__init__(model_dir, flowlm_cfg, mimi_cfg)
        self.device = torch.device(device)

    @property
    def engine(self):
        if self._engine is None:
            from .runtime.engine import TTSEngine

            self._engine = TTSEngine(self)
        return self._engine

    def stream(self, text: str, voice: Optional[str] = None,
               params: Optional[Params] = None, pipeline: bool = True) -> Iterator[Audio]:
        """Yield one 80 ms Audio chunk (int16 in ``pcm_i16``) per frame as it
        is produced, through runtime/streaming.StreamingSession; stops at
        the stream's first inactive chunk."""
        from .runtime.streaming import StreamingSession

        p = (params or Params()).normalized()
        sess = StreamingSession.start(self.engine, [text], voices=[voice], params=p,
                                      pipeline=pipeline)
        for chunk in sess:
            if not chunk.active[0]:
                break
            yield Audio(sample_rate=p.sample_rate, channels=1, samples=chunk.pcm[0],
                        pcm_i16=chunk.pcm_i16[0])


def load_dir(model_dir: str, **kwargs) -> Context:
    return Context(model_dir, **kwargs)
