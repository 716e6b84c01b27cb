"""The reference's text front end and noise, written from the published C
algorithms (pocket-tts.c: ptts_prepare_text, the SentencePiece unigram
Viterbi, the xorshift64* + Box-Muller frame noise), independent of the
program: prompt preparation, tokenization, frame budgets and the per-stream
noise a text-driven engine derives from a seed."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def prepare_text(text: str) -> Tuple[str, int]:
    """(prepared text, word count): whitespace collapsed and stripped, the
    first ASCII letter upper-cased, '.' appended after a final letter or
    digit, 8 leading spaces when there are fewer than 5 words."""
    words = text.split()
    if not words:
        raise ValueError("empty prompt")
    out = " ".join(words)
    for i, c in enumerate(out):
        if c.isascii() and c.isalpha():
            out = out[:i] + c.upper() + out[i + 1:]
            break
    if out[-1].isascii() and out[-1].isalnum():
        out += "."
    if len(words) < 5:
        out = " " * 8 + out
    return out, len(words)


def frame_budget(words: int) -> int:
    """(words + 2) seconds at 12.5 frames per second."""
    return max(int((max(words, 1) + 2.0) * 12.5), 1)


def tokenize(text: str, pieces: Sequence[Tuple[str, float]]) -> List[int]:
    """Unigram Viterbi over ``pieces`` ([(piece, score)], id = index, 0 =
    unknown) after the normalization of a SentencePiece model with a dummy
    prefix: whitespace runs collapsed, ends stripped, spaces as U+2581."""
    norm = "▁" + "▁".join(text.split())
    n = len(norm)
    best = [-1e30] * (n + 1)
    back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)
    best[0] = 0.0
    table = {p: (i, s) for i, (p, s) in enumerate(pieces) if i >= 2}
    longest = max(len(p) for p, _ in pieces)
    for i in range(n):
        if best[i] <= -1e29:
            continue
        matched = False
        for j in range(i + 1, min(n, i + longest) + 1):
            hit = table.get(norm[i:j])
            if hit is not None:
                matched = True
                if best[i] + hit[1] > best[j]:
                    best[j], back[j] = best[i] + hit[1], (i, hit[0])
        if not matched and best[i] + pieces[0][1] > best[i + 1]:
            best[i + 1], back[i + 1] = best[i] + pieces[0][1], (i, 0)
    ids, j = [], n
    while j > 0:
        i, pid = back[j]
        ids.append(pid)
        j = i
    return ids[::-1]


def frame_noise(seeds: Sequence[int], frames: int, latent: int, temp: float) -> np.ndarray:
    """[len(seeds), frames, latent] float32: stream s threads one xorshift64*
    state (seeded with its seed's 64-bit pattern) through latent/2
    Box-Muller pairs per frame, scaled by sqrt(temp)."""
    n = len(seeds)
    out = np.zeros((n, frames, latent), np.float32)
    if temp <= 0:
        return out
    state = np.array([s & 0xFFFFFFFFFFFFFFFF for s in seeds], np.uint64)
    std = np.float32(np.sqrt(np.float32(temp)))
    mult = np.uint64(2685821657736338717)
    pairs = (latent + 1) // 2

    def nxt():
        nonlocal state
        x = state
        x = x ^ (x >> np.uint64(12))
        x = x ^ (x << np.uint64(25))
        x = x ^ (x >> np.uint64(27))
        state = x
        with np.errstate(over="ignore"):
            u = (x * mult) >> np.uint64(32)
        return (u.astype(np.float32) + np.float32(1.0)) / np.float32(4294967296.0)

    for f in range(frames):
        z = np.empty((n, 2 * pairs), np.float32)
        for p in range(pairs):
            u1, u2 = nxt(), nxt()
            r = np.sqrt(np.float32(-2.0) * np.log(u1)).astype(np.float32)
            th = (np.float32(2.0) * np.float32(np.pi) * u2).astype(np.float32)
            z[:, 2 * p] = r * np.cos(th) * std
            z[:, 2 * p + 1] = r * np.sin(th) * std
        out[:, f] = z[:, :latent]
    return out
