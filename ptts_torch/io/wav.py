"""WAV audio container matching reference/ptts_audio.c.

16-bit PCM RIFF/WAVE with the reference's exact quantization:
clamp to [-1, 1] then ``int16(s * 32767.0)`` (C float->int truncation,
ptts_audio.c:82-88).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Audio:
    """f32 interleaved samples, mirror of ptts_audio (ptts_audio.h).

    ``pcm_i16``, when present, carries already-quantized int16 PCM (e.g.
    device-quantized by the serving path); WAV writers emit those exact
    bytes instead of re-quantizing ``samples`` (re-quantizing a dequantized
    value can flip LSBs through f32 roundoff).
    """

    sample_rate: int
    channels: int
    samples: np.ndarray  # float32 [num_samples * channels]
    pcm_i16: np.ndarray | None = None  # int16, same layout as samples

    @property
    def num_samples(self) -> int:
        return len(self.samples) // self.channels

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate


def audio_create(sample_rate: int, channels: int, num_samples: int) -> Audio:
    if sample_rate <= 0 or channels <= 0 or num_samples < 0:
        raise ValueError("invalid audio dimensions")
    return Audio(
        sample_rate=sample_rate,
        channels=channels,
        samples=np.zeros(num_samples * channels, dtype=np.float32),
    )


def quantize_i16(samples: np.ndarray) -> np.ndarray:
    """Reference quantization: clamp then truncate toward zero (C cast)."""
    s = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    scaled = s * np.float32(32767.0)
    # C `(int16_t)f` truncates toward zero; numpy astype(int16) also truncates.
    return np.trunc(scaled).astype(np.int16)


def save_wav(audio: Audio, path: str) -> None:
    """Write 16-bit PCM WAV with the reference's exact header layout."""
    bits_per_sample = 16
    bytes_per_sample = bits_per_sample // 8
    num_channels = audio.channels
    sample_rate = audio.sample_rate
    total_samples = audio.num_samples * num_channels
    data_bytes = total_samples * bytes_per_sample
    byte_rate = sample_rate * num_channels * bytes_per_sample
    block_align = num_channels * bytes_per_sample

    if audio.pcm_i16 is not None:
        pcm = np.asarray(audio.pcm_i16[:total_samples], np.int16)
    else:
        pcm = quantize_i16(audio.samples[:total_samples])
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_bytes))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate,
                            byte_rate, block_align, bits_per_sample))
        f.write(b"data")
        f.write(struct.pack("<I", data_bytes))
        f.write(pcm.astype("<i2").tobytes())


def load_wav(path: str) -> Audio:
    """Minimal 16-bit PCM WAV reader (for golden-test comparisons)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            pcm = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or pcm is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format != 1 or bits != 16:
        raise ValueError(f"{path}: only 16-bit PCM supported")
    samples = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32767.0
    return Audio(sample_rate=sample_rate, channels=channels, samples=samples)
