"""SentencePiece unigram tokenizer.

Behavior-compatible rebuild of reference/ptts_spm.c:
  * hand-rolled ModelProto protobuf walk (pieces + scores + types,
    NormalizerSpec with precompiled charsmap, TrainerSpec whitespace flag)
  * normalization through the precompiled-charsmap XCDA double-array trie
    with prefix replacements, UTF-8 validation with U+FFFD fallback, and
    SentencePiece dummy-prefix / whitespace-escape handling
  * unigram Viterbi DP over UTF-8 boundaries

The reference scans every vocab piece at every position
(ptts_spm.c:665-698, O(positions x vocab)); this implementation builds a
byte-trie over the pieces once at load for O(positions x max_piece_len)
matching with identical results (ties resolve to the lowest piece id, as the
reference's in-order strict-greater update does).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_UNK_SURROGATE = b"\xef\xbf\xbd"  # U+FFFD


# ---------------------------------------------------------------------------
# Protobuf primitives
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    val = 0
    shift = 0
    while pos < len(buf) and shift < 64:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, pos
        shift += 7
    raise ValueError("truncated varint")


def _skip_field(wire: int, buf: bytes, pos: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == 1:
        return pos + 8
    if wire == 2:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire == 5:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire}")


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass
class Piece:
    bytes_: bytes
    score: float
    type: int  # 1 normal, 2 unk, 3 control, 4 user-defined, 6 byte


class _TrieNode:
    __slots__ = ("children", "piece_id", "score")

    def __init__(self) -> None:
        self.children: Dict[int, "_TrieNode"] = {}
        self.piece_id: int = -1
        self.score: float = 0.0


class SentencePieceModel:
    def __init__(self) -> None:
        self.pieces: List[Piece] = []
        self.unk_id: int = -1
        self.max_piece_len: int = 0
        self.add_dummy_prefix = True
        self.remove_extra_whitespaces = True
        self.escape_whitespaces = True
        self.treat_whitespace_as_suffix = False
        self.charsmap: bytes = b""
        self._xcda: Optional[memoryview] = None  # uint32 view
        self._xcda_size = 0
        self._prefix_replacements: bytes = b""
        self._user_pieces: List[bytes] = []
        self._trie = _TrieNode()

    # -- loading -----------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, buf: bytes) -> "SentencePieceModel":
        spm = cls()
        pos = 0
        n = len(buf)
        while pos < n:
            key, pos = _read_varint(buf, pos)
            fieldno, wire = key >> 3, key & 0x7
            if fieldno == 1 and wire == 2:  # repeated SentencePiece
                mlen, pos = _read_varint(buf, pos)
                spm._parse_piece(buf[pos : pos + mlen])
                pos += mlen
            elif fieldno == 2 and wire == 2:  # TrainerSpec
                mlen, pos = _read_varint(buf, pos)
                spm._parse_trainer_spec(buf[pos : pos + mlen])
                pos += mlen
            elif fieldno == 3 and wire == 2:  # NormalizerSpec
                mlen, pos = _read_varint(buf, pos)
                spm._parse_normalizer_spec(buf[pos : pos + mlen])
                pos += mlen
            else:
                pos = _skip_field(wire, buf, pos)
        if not spm.pieces:
            raise ValueError("no pieces in SentencePiece model")
        spm._setup_charsmap()
        spm._build_trie()
        return spm

    def _parse_piece(self, buf: bytes) -> None:
        pos = 0
        raw = b""
        score = 0.0
        ptype = 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            fieldno, wire = key >> 3, key & 0x7
            if fieldno == 1 and wire == 2:
                n, pos = _read_varint(buf, pos)
                raw = buf[pos : pos + n]
                pos += n
            elif fieldno == 2 and wire == 5:
                (score,) = struct.unpack_from("<f", buf, pos)
                pos += 4
            elif fieldno == 3 and wire == 0:
                ptype, pos = _read_varint(buf, pos)
            else:
                pos = _skip_field(wire, buf, pos)
        pid = len(self.pieces)
        self.pieces.append(Piece(raw, score, ptype))
        self.max_piece_len = max(self.max_piece_len, len(raw))
        if ptype == 2 or raw == b"<unk>":
            self.unk_id = pid
        if ptype == 4 and raw:
            self._user_pieces.append(raw)

    def _parse_trainer_spec(self, buf: bytes) -> None:
        pos = 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            fieldno, wire = key >> 3, key & 0x7
            if fieldno == 24 and wire == 0:
                v, pos = _read_varint(buf, pos)
                self.treat_whitespace_as_suffix = v != 0
            else:
                pos = _skip_field(wire, buf, pos)

    def _parse_normalizer_spec(self, buf: bytes) -> None:
        pos = 0
        while pos < len(buf):
            key, pos = _read_varint(buf, pos)
            fieldno, wire = key >> 3, key & 0x7
            if fieldno == 2 and wire == 2:
                n, pos = _read_varint(buf, pos)
                self.charsmap = buf[pos : pos + n]
                pos += n
            elif fieldno == 3 and wire == 0:
                v, pos = _read_varint(buf, pos)
                self.add_dummy_prefix = v != 0
            elif fieldno == 4 and wire == 0:
                v, pos = _read_varint(buf, pos)
                self.remove_extra_whitespaces = v != 0
            elif fieldno == 5 and wire == 0:
                v, pos = _read_varint(buf, pos)
                self.escape_whitespaces = v != 0
            else:
                pos = _skip_field(wire, buf, pos)

    def _setup_charsmap(self) -> None:
        """Split the precompiled charsmap blob: u32 size, XCDA array, strings."""
        if len(self.charsmap) < 4:
            return
        (blob_size,) = struct.unpack_from("<I", self.charsmap, 0)
        if 4 + blob_size > len(self.charsmap) or blob_size % 4 != 0:
            return
        self._xcda = memoryview(self.charsmap)[4 : 4 + blob_size].cast("I")
        self._xcda_size = blob_size // 4
        self._prefix_replacements = self.charsmap[4 + blob_size :]

    def _build_trie(self) -> None:
        for pid, piece in enumerate(self.pieces):
            if not piece.bytes_:
                continue
            node = self._trie
            for b in piece.bytes_:
                nxt = node.children.get(b)
                if nxt is None:
                    nxt = _TrieNode()
                    node.children[b] = nxt
                node = nxt
            # Keep the winner the reference's in-order strict-greater scan
            # would keep for duplicate byte strings: higher score, then lower id.
            if node.piece_id < 0 or piece.score > node.score:
                node.piece_id = pid
                node.score = piece.score

    # -- introspection -------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def piece(self, pid: int) -> Optional[bytes]:
        if 0 <= pid < len(self.pieces):
            return self.pieces[pid].bytes_
        return None

    def piece_str(self, pid: int) -> Optional[str]:
        raw = self.piece(pid)
        return raw.decode("utf-8", errors="replace") if raw is not None else None

    # -- XCDA double-array trie (charsmap normalization) ---------------------

    def _xcda_base(self, idx: int) -> int:
        node = self._xcda[idx]
        return (node >> 10) << ((node & (1 << 9)) >> 6)

    def _xcda_lcheck(self, idx: int) -> int:
        node = self._xcda[idx]
        return node & ((1 << 31) | 0xFF)

    def _xcda_leaf(self, idx: int) -> int:
        return (self._xcda[idx] >> 8) & 1

    def _xcda_value(self, idx: int) -> int:
        return self._xcda[idx] & ((1 << 31) - 1)

    def _user_defined_match(self, data: bytes, offset: int) -> int:
        best = 0
        for up in self._user_pieces:
            if len(up) > best and data.startswith(up, offset):
                best = len(up)
        return best

    def _normalize_prefix(self, data: bytes, offset: int) -> Tuple[bytes, int]:
        """Longest charsmap replacement (or passthrough) at ``offset``.

        Returns (normalized_bytes, consumed_input) per spm_normalize_prefix
        (ptts_spm.c:358-407).
        """
        if offset >= len(data):
            return b"", 0

        user = self._user_defined_match(data, offset)
        if user > 0:
            return data[offset : offset + user], user

        longest_len = 0
        longest_value = 0
        if self._xcda_size > 0:
            node = self._xcda_base(0)
            for i in range(offset, len(data)):
                c = data[i]
                if c == 0:
                    break
                node ^= c
                if node >= self._xcda_size:
                    break
                if self._xcda_lcheck(node) != c:
                    break
                is_leaf = self._xcda_leaf(node)
                node ^= self._xcda_base(node)
                if node >= self._xcda_size:
                    break
                if is_leaf:
                    longest_len = i - offset + 1
                    longest_value = self._xcda_value(node)

        if longest_len > 0:
            if longest_value >= len(self._prefix_replacements):
                return data[offset : offset + 1], 1
            end = self._prefix_replacements.find(b"\x00", longest_value)
            if end < 0:
                end = len(self._prefix_replacements)
            return self._prefix_replacements[longest_value:end], longest_len

        clen = _utf8_decode_len(data, offset)
        if clen > 0:
            return data[offset : offset + clen], clen
        return _UNK_SURROGATE, 1

    def normalize(self, text: str) -> bytes:
        """SentencePiece normalization (ptts_spm.c:424-492)."""
        data = text.encode("utf-8")
        if not data:
            return b""

        space = b"\xe2\x96\x81" if self.escape_whitespaces else b" "
        prepend = (not self.treat_whitespace_as_suffix) and self.add_dummy_prefix
        append = self.treat_whitespace_as_suffix and self.add_dummy_prefix
        merge = self.remove_extra_whitespaces

        out = bytearray()
        space_prepended = False
        in_non_ws = False

        offset = 0
        while offset < len(data):
            normalized, consumed = self._normalize_prefix(data, offset)
            for c in normalized:
                if c != 0x20:
                    if not in_non_ws:
                        in_non_ws = True
                        if (prepend and not space_prepended) or merge:
                            out += space
                            space_prepended = True
                    out.append(c)
                else:
                    if in_non_ws:
                        in_non_ws = False
                    if not merge:
                        out += space
            offset += consumed

        if append:
            out += space
        return bytes(out)

    # -- encode --------------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        """Unigram Viterbi over UTF-8 boundaries (ptts_spm.c:617-738)."""
        norm = self.normalize(text)
        if not norm:
            return []

        # UTF-8 lead-byte boundaries plus the end sentinel.
        bounds: List[int] = [i for i in range(len(norm)) if (norm[i] & 0xC0) != 0x80]
        bounds.append(len(norm))
        n_pos = len(bounds)
        bound_index = {b: i for i, b in enumerate(bounds)}

        NEG = float("-1e30")
        dp = [NEG] * n_pos
        prev = [-1] * n_pos
        best_id = [-1] * n_pos
        dp[0] = 0.0

        for i in range(n_pos - 1):
            if dp[i] <= NEG / 2:
                continue
            start = bounds[i]
            matched = False
            node = self._trie
            base = dp[i]
            for end in range(start, len(norm)):
                node = node.children.get(norm[end])
                if node is None:
                    break
                if node.piece_id >= 0:
                    # A piece only counts as matched if it ends on a UTF-8
                    # boundary (reference checks this before setting matched,
                    # ptts_spm.c:677-687).
                    end_idx = bound_index.get(end + 1)
                    if end_idx is not None:
                        matched = True
                        score = base + node.score
                        if score > dp[end_idx]:
                            dp[end_idx] = score
                            prev[end_idx] = i
                            best_id[end_idx] = node.piece_id
            if not matched and self.unk_id >= 0:
                score = base + self.pieces[self.unk_id].score
                if score > dp[i + 1]:
                    dp[i + 1] = score
                    prev[i + 1] = i
                    best_id[i + 1] = self.unk_id

        if prev[n_pos - 1] < 0:
            raise ValueError("tokenization failed (no Viterbi path)")

        ids: List[int] = []
        idx = n_pos - 1
        while idx > 0:
            ids.append(best_id[idx])
            idx = prev[idx]
        ids.reverse()
        return ids

    def decode(self, ids: List[int]) -> str:
        """Join pieces, unescape the SentencePiece whitespace (utility)."""
        raw = b"".join(self.piece(i) or b"" for i in ids)
        text = raw.replace(b"\xe2\x96\x81", b" ").decode("utf-8", errors="replace")
        return text.lstrip(" ") if self.add_dummy_prefix else text


def _utf8_decode_len(data: bytes, offset: int) -> int:
    """Strict UTF-8 char length (0 = invalid), mirrors ptts_spm.c:281-318."""
    avail = len(data) - offset
    if avail <= 0:
        return 0
    c0 = data[offset]
    if c0 < 0x80:
        return 1
    if c0 < 0xC2:
        return 0
    if c0 < 0xE0:
        if avail < 2 or (data[offset + 1] & 0xC0) != 0x80:
            return 0
        return 2
    if c0 < 0xF0:
        if avail < 3:
            return 0
        c1, c2 = data[offset + 1], data[offset + 2]
        if (c1 & 0xC0) != 0x80 or (c2 & 0xC0) != 0x80:
            return 0
        if c0 == 0xE0 and c1 < 0xA0:
            return 0  # overlong
        if c0 == 0xED and c1 >= 0xA0:
            return 0  # surrogate
        return 3
    if c0 < 0xF5:
        if avail < 4:
            return 0
        c1, c2, c3 = data[offset + 1], data[offset + 2], data[offset + 3]
        if (c1 & 0xC0) != 0x80 or (c2 & 0xC0) != 0x80 or (c3 & 0xC0) != 0x80:
            return 0
        if c0 == 0xF0 and c1 < 0x90:
            return 0  # overlong
        if c0 == 0xF4 and c1 > 0x8F:
            return 0  # > U+10FFFF
        return 4
    return 0
