"""Bit-compatible host RNG for parity with the reference sampler.

The reference draws frame noise from xorshift64* + Box-Muller on the host
(reference/ptts_flowlm.c:1013-1025, 1211-1231). To reproduce its output
exactly at a given seed, the engine precomputes the noise tensor
``[frames, latent_dim]`` on the host with this module and uploads it with
the rest of the generation's inputs. The port's copy of ptts_tpu/rng.py.

All arithmetic is float32 to match the C float path.
"""

from __future__ import annotations

import numpy as np

_MULT = np.uint64(2685821657736338717)
_TWO32 = np.float32(4294967296.0)
_PI = np.float32(np.pi)


class Xorshift64Star:
    """xorshift64* matching ptts_flowlm.c:1013-1020."""

    def __init__(self, seed: int):
        # C: uint64_t rng = (uint64_t)seed;  (reinterpret int64 bits as uint64)
        self.state = np.array(seed, dtype=np.int64).view(np.uint64).reshape(())[()]

    def next_u32(self) -> np.uint32:
        x = self.state
        with np.errstate(over="ignore"):
            x ^= x >> np.uint64(12)
            x ^= np.uint64((int(x) << 25) & 0xFFFFFFFFFFFFFFFF)
            x ^= x >> np.uint64(27)
            self.state = x
            prod = np.uint64((int(x) * int(_MULT)) & 0xFFFFFFFFFFFFFFFF)
        return np.uint32(int(prod) >> 32)

    def next_f01(self) -> np.float32:
        u = self.next_u32()
        return (np.float32(u) + np.float32(1.0)) / _TWO32


def gaussian_pairs(rng: Xorshift64Star, n_pairs: int, std: np.float32) -> np.ndarray:
    """Box-Muller pairs exactly as ptts_flowlm.c:1211-1222 (float32 math)."""
    out = np.empty(2 * n_pairs, dtype=np.float32)
    for i in range(n_pairs):
        u1 = rng.next_f01()
        u2 = rng.next_f01()
        r = np.float32(np.sqrt(np.float32(-2.0) * np.log(u1, dtype=np.float32)))
        theta = np.float32(2.0) * _PI * u2
        out[2 * i] = r * np.cos(theta, dtype=np.float32) * std
        out[2 * i + 1] = r * np.sin(theta, dtype=np.float32) * std
    return out


def frame_noise(
    seed: int,
    frames: int,
    latent_dim: int = 32,
    temp: float = 0.7,
    noise_clamp: float = 0.0,
) -> np.ndarray:
    """Noise tensor [frames, latent_dim] matching the reference draw order.

    The reference draws latent_dim/2 Box-Muller pairs per frame, threading one
    RNG state across frames (ptts_flowlm.c:1187-1231). When temp <= 0 the RNG
    is never advanced and the noise is all zeros.

    Dispatches to the C++ implementation (csrc/ptts_host.cpp
    ptts_frame_noise) when available -- this runs once per admitted request
    on the serving host path and the Python pair loop is ~100x slower.
    Within one process every caller sees the same implementation, so
    batcher-vs-offline equality is unaffected (numpy/libm differ from glibc
    by <=1 ulp in the transcendentals, inside every parity gate).
    """
    from . import native

    out = native.frame_noise(seed, frames, latent_dim, float(temp),
                             float(noise_clamp))
    if out is not None:
        return out
    noise = np.zeros((frames, latent_dim), dtype=np.float32)
    if temp <= 0.0:
        return noise
    std = np.float32(np.sqrt(np.float32(temp)))
    rng = Xorshift64Star(seed)
    n_pairs = (latent_dim + 1) // 2
    for f in range(frames):
        z = gaussian_pairs(rng, n_pairs, std)[:latent_dim]
        if noise_clamp > 0.0:
            z = np.clip(z, np.float32(-noise_clamp), np.float32(noise_clamp))
        noise[f] = z
    return noise
