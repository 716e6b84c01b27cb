"""Tokenizer loading: prefer the C++ native implementation, fall back to the
pure-Python one (identical algorithms; cross-checked in tests/test_native.py).

Set PTTS_NATIVE=0 to force the Python path.
"""

from __future__ import annotations

import os

from .spm import SentencePieceModel


def load_tokenizer(path: str):
    if os.environ.get("PTTS_NATIVE", "1") != "0":
        try:
            from .. import native

            if native.available():
                return native.NativeTokenizer.load(path)
        except (RuntimeError, ValueError, OSError):
            pass
    return SentencePieceModel.load(path)
