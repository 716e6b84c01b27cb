"""ptts-torch: Pocket-TTS on PyTorch and CUDA (NVIDIA H100).

The port of ``ptts_tpu`` (JAX/XLA/Pallas), which stays in the repository as
the reference. Module names mirror ``ptts_tpu``'s so each counterpart is easy
to find. The framework-free host layer (configs, text prep, tokenizer,
safetensors, WAV, host RNG, native host library) is the port's own copy:
nothing here imports jax or any module of ``ptts_tpu``.

    from ptts_torch import api
    ctx = api.load_dir("pocket-tts-model", device="cuda")
    audio = ctx.generate("Hello world!", params=api.Params(seed=1))
"""

__version__ = "0.1.0"

from .config import FlowLMConfig, MimiConfig  # noqa: F401

__all__ = ["api", "FlowLMConfig", "MimiConfig", "__version__"]
