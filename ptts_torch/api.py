"""Public API of the PyTorch port (mirror of ptts_tpu/api.py).

``Context`` is ptts_tpu's model-directory handle (weights file, tokenizer,
introspection, verify) with one difference: its engine is the PyTorch
TTSEngine on an explicit device.

    from ptts_torch import api
    ctx = api.load_dir(model_dir, device="cuda")
    audio = ctx.generate("Hello world!", params=api.Params(seed=1))
"""

from __future__ import annotations

import torch

from ptts_tpu import api as _api
from ptts_tpu.api import Params, PttsError  # noqa: F401
from ptts_tpu.config import DEFAULT_FLOWLM, DEFAULT_MIMI, FlowLMConfig, MimiConfig


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

    def stream(self, *args, **kwargs):
        raise NotImplementedError("streaming is not ported to ptts_torch yet")


def load_dir(model_dir: str, **kwargs) -> Context:
    return Context(model_dir, **kwargs)
