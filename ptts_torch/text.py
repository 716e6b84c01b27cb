"""Prompt preparation heuristics, byte-exact with reference/ptts.c:219-291.

The C code operates on raw bytes with C-locale ctype; this module mirrors that
(ASCII-only isalpha/isalnum/toupper) so token streams match exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple


class EmptyPromptError(ValueError):
    pass


def _is_ascii_alpha(b: int) -> bool:
    return (0x41 <= b <= 0x5A) or (0x61 <= b <= 0x7A)


def _is_ascii_alnum(b: int) -> bool:
    return _is_ascii_alpha(b) or (0x30 <= b <= 0x39)


def prepare_text(text: str) -> Tuple[str, int, int]:
    """Normalize a prompt; returns (prepared, word_count, eos_after).

    Mirrors ptts_prepare_text (ptts.c:219-283):
      * \\n/\\r/\\t -> space, collapse runs, strip leading/trailing space
      * count words (space-delimited runs)
      * uppercase the first ASCII letter
      * append '.' if the last char is ASCII alphanumeric
      * eos_after = 5 if words <= 4 else 3
      * prepend 8 spaces when words < 5
    """
    raw = text.encode("utf-8")
    out = bytearray()
    in_space = True
    words = 0
    for b in raw:
        if b in (0x0A, 0x0D, 0x09):  # \n \r \t
            b = 0x20
        if b == 0x20:
            if not in_space:
                out.append(0x20)
                in_space = True
            continue
        if in_space:
            words += 1
        in_space = False
        out.append(b)
    if out and out[-1] == 0x20:
        out.pop()
    if not out:
        raise EmptyPromptError("Text prompt cannot be empty")

    for i, b in enumerate(out):
        if _is_ascii_alpha(b):
            out[i] = b & ~0x20  # toupper for ASCII
            break

    last = len(out) - 1
    while last >= 0 and out[last] == 0x20:
        last -= 1
    if last >= 0 and _is_ascii_alnum(out[last]):
        out.append(0x2E)  # '.'

    eos_after = 5 if words <= 4 else 3

    if words < 5:
        out = bytearray(b" " * 8) + out

    return out.decode("utf-8"), words, eos_after


def estimate_frames(word_count: int) -> int:
    """frames = (words*1.0 + 2.0 seconds) * 12.5 fps  (ptts.c:285-291)."""
    if word_count < 1:
        word_count = 1
    gen_len_sec = float(word_count) * 1.0 + 2.0
    frames = int(gen_len_sec * 12.5)
    return max(frames, 1)
