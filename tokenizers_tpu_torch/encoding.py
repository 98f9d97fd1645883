"""Encoding: the columnar output container of the tokenization pipeline.

Mirrors the behavior of the reference `tokenizers/src/tokenizer/encoding.rs:11-31`
(7 parallel vectors + overflowing + sequence_ranges) but is designed SoA-first so a
batch of encodings maps 1:1 onto packed device arrays (see `ops/packing.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class Encoding:
    """Output of the tokenization pipeline for one input (or one pair of inputs).

    Columnar layout: parallel lists `ids / type_ids / tokens / words / offsets /
    special_tokens_mask / attention_mask`, plus `overflowing` windows produced by
    truncation and `sequence_ranges` mapping sequence index -> token index range.
    """

    __slots__ = (
        "ids",
        "type_ids",
        "tokens",
        "words",
        "offsets",
        "special_tokens_mask",
        "attention_mask",
        "overflowing",
        "sequence_ranges",
    )

    def __init__(
        self,
        ids: Optional[List[int]] = None,
        type_ids: Optional[List[int]] = None,
        tokens: Optional[List[str]] = None,
        words: Optional[List[Optional[int]]] = None,
        offsets: Optional[List[Tuple[int, int]]] = None,
        special_tokens_mask: Optional[List[int]] = None,
        attention_mask: Optional[List[int]] = None,
        overflowing: Optional[List["Encoding"]] = None,
        sequence_ranges: Optional[Dict[int, range]] = None,
    ):
        n = len(ids) if ids is not None else 0
        self.ids: List[int] = list(ids) if ids else []
        self.type_ids: List[int] = list(type_ids) if type_ids else [0] * n
        self.tokens: List[str] = list(tokens) if tokens else [""] * n
        self.words: List[Optional[int]] = list(words) if words else [None] * n
        self.offsets: List[Tuple[int, int]] = list(offsets) if offsets else [(0, 0)] * n
        self.special_tokens_mask: List[int] = (
            list(special_tokens_mask) if special_tokens_mask else [0] * n
        )
        self.attention_mask: List[int] = (
            list(attention_mask) if attention_mask else [1] * n
        )
        self.overflowing: List[Encoding] = list(overflowing) if overflowing else []
        self.sequence_ranges: Dict[int, range] = dict(sequence_ranges or {})

    # ------------------------------------------------------------------ basics

    def __len__(self) -> int:
        return len(self.ids)

    def is_empty(self) -> bool:
        return len(self.ids) == 0

    def __eq__(self, other) -> bool:
        if not isinstance(other, Encoding):
            return NotImplemented
        return (
            self.ids == other.ids
            and self.type_ids == other.type_ids
            and self.tokens == other.tokens
            and self.words == other.words
            and self.offsets == other.offsets
            and self.special_tokens_mask == other.special_tokens_mask
            and self.attention_mask == other.attention_mask
            and self.overflowing == other.overflowing
            and self.sequence_ranges == other.sequence_ranges
        )

    def __repr__(self) -> str:
        return (
            f"Encoding(num_tokens={len(self.ids)}, "
            f"attributes=[ids, type_ids, tokens, offsets, attention_mask, "
            f"special_tokens_mask, overflowing])"
        )

    @property
    def word_ids(self) -> List[Optional[int]]:
        return self.words

    @property
    def n_sequences(self) -> int:
        if not self.sequence_ranges:
            return 1 if len(self.ids) > 0 else 0
        return len(self.sequence_ranges)

    @property
    def sequence_ids(self) -> List[Optional[int]]:
        out: List[Optional[int]] = []
        for i in range(len(self.ids)):
            out.append(self.token_to_sequence(i))
        return out

    def set_sequence_id(self, sequence_id: int) -> None:
        """Mark the whole encoding as belonging to the given sequence."""
        self.sequence_ranges[sequence_id] = range(0, len(self.ids))
        for enc in self.overflowing:
            enc.set_sequence_id(sequence_id)

    # ------------------------------------------------------------------ mappings

    def token_to_sequence(self, token: int) -> Optional[int]:
        if token >= len(self.ids):
            return None
        if not self.sequence_ranges:
            return 0
        for seq_id, rng in self.sequence_ranges.items():
            if token in rng:
                return seq_id
        return None

    def _sequence_tokens(self, sequence_id: int) -> range:
        # unknown sequence ids fall back to the full token range
        # (reference `encoding.rs` sequence_range unwrap_or(0..len))
        return self.sequence_ranges.get(sequence_id, range(0, len(self.ids)))

    def word_to_tokens(
        self, word: int, sequence_id: int = 0
    ) -> Optional[Tuple[int, int]]:
        start = None
        end = None
        for i in self._sequence_tokens(sequence_id):
            if self.words[i] == word:
                if start is None or i < start:
                    start = i
                if end is None or i >= end:
                    end = i + 1
        if start is None or end is None:
            return None
        return (start, end)

    def word_to_chars(
        self, word: int, sequence_id: int = 0
    ) -> Optional[Tuple[int, int]]:
        tok = self.word_to_tokens(word, sequence_id)
        if tok is None:
            return None
        start, end = tok
        return (self.offsets[start][0], self.offsets[end - 1][1])

    def token_to_chars(self, token: int) -> Optional[Tuple[int, int]]:
        """None for tokens outside any sequence (e.g. special tokens)
        (reference `encoding.rs:269`)."""
        if token >= len(self.ids) or self.token_to_sequence(token) is None:
            return None
        return self.offsets[token]

    def token_to_word(self, token: int) -> Optional[int]:
        if token >= len(self.ids) or self.token_to_sequence(token) is None:
            return None
        return self.words[token]

    def char_to_token(self, pos: int, sequence_id: int = 0) -> Optional[int]:
        for i in self._sequence_tokens(sequence_id):
            start, end = self.offsets[i]
            if start <= pos < end:
                return i
        return None

    def char_to_word(self, pos: int, sequence_id: int = 0) -> Optional[int]:
        tok = self.char_to_token(pos, sequence_id)
        if tok is None:
            return None
        return self.words[tok]

    # ------------------------------------------------------------------ slicing

    def _slice(self, start: int, stop: int) -> "Encoding":
        """A sub-window of this encoding (overflowing/sequence_ranges dropped,
        sequence ranges re-derived by the caller when needed)."""
        return Encoding(
            ids=self.ids[start:stop],
            type_ids=self.type_ids[start:stop],
            tokens=self.tokens[start:stop],
            words=self.words[start:stop],
            offsets=self.offsets[start:stop],
            special_tokens_mask=self.special_tokens_mask[start:stop],
            attention_mask=self.attention_mask[start:stop],
        )

    # ------------------------------------------------------------------ truncate

    def truncate(self, max_length: int, stride: int = 0, direction: str = "right"):
        """Truncate to `max_length`, moving the rest into overflowing windows of
        `max_length` with `stride` tokens of overlap (reference `encoding.rs:307`)."""
        total = len(self.ids)
        if max_length >= total:
            return
        if direction not in ("left", "right"):
            raise ValueError(f"Invalid truncation direction: {direction}")

        if max_length == 0:
            whole = self._slice(0, total)
            whole.overflowing = []
            self.ids = []
            self.type_ids = []
            self.tokens = []
            self.words = []
            self.offsets = []
            self.special_tokens_mask = []
            self.attention_mask = []
            self.overflowing = [whole]
            self.sequence_ranges = {}
            return

        if stride >= max_length:
            raise ValueError("stride must be strictly less than max_length")

        step = max_length - stride
        if direction == "right":
            parts = []
            pos = 0
            while pos < total:
                parts.append(self._slice(pos, min(pos + max_length, total)))
                if pos + max_length >= total:
                    break
                pos += step
        else:  # left: windows counted from the end, main part is the last window
            parts = []
            pos = total
            while pos > 0:
                parts.append(self._slice(max(pos - max_length, 0), pos))
                if pos - max_length <= 0:
                    break
                pos -= step
        main = parts[0]
        self.ids = main.ids
        self.type_ids = main.type_ids
        self.tokens = main.tokens
        self.words = main.words
        self.offsets = main.offsets
        self.special_tokens_mask = main.special_tokens_mask
        self.attention_mask = main.attention_mask
        self.overflowing = parts[1:]

    # ------------------------------------------------------------------ merge

    @staticmethod
    def merge(encodings: Sequence["Encoding"], growing_offsets: bool = False) -> "Encoding":
        out = Encoding()
        for enc in encodings:
            out.merge_with(enc, growing_offsets)
        return out

    def merge_with(self, other: "Encoding", growing_offsets: bool = False) -> None:
        """Append `other`, cross-producting overflowing windows
        (reference `encoding.rs:407-463`)."""
        new_overflowing: List[Encoding] = []
        # 1. all our overflowings with the pair (recursively) and its overflowings
        for self_o in self.overflowing:
            n = self_o.copy()
            n.merge_with(other.copy(), growing_offsets)
            new_overflowing.append(n)
            for other_o in other.overflowing:
                n = self_o.copy()
                n.merge_with(other_o.copy(), growing_offsets)
                new_overflowing.append(n)
        # 2. ourself with all the other overflowings
        for other_o in other.overflowing:
            n = self._copy_no_overflow()
            n.merge_with(other_o.copy(), growing_offsets)
            new_overflowing.append(n)

        self._append(other, growing_offsets)
        self.overflowing = new_overflowing

    def _copy_no_overflow(self) -> "Encoding":
        c = self._slice(0, len(self.ids))
        c.sequence_ranges = dict(self.sequence_ranges)
        return c

    def copy(self) -> "Encoding":
        """Deep copy including overflowing windows."""
        c = self._copy_no_overflow()
        c.overflowing = [o.copy() for o in self.overflowing]
        return c

    def _append(self, other: "Encoding", growing_offsets: bool) -> None:
        original_len = len(self.ids)
        starting_offset = 0
        if growing_offsets and self.offsets:
            starting_offset = self.offsets[-1][1]
        # shift sequence ranges of `other`
        for seq_id, rng in other.sequence_ranges.items():
            self.sequence_ranges[seq_id] = range(
                rng.start + original_len, rng.stop + original_len
            )
        self.ids.extend(other.ids)
        self.type_ids.extend(other.type_ids)
        self.tokens.extend(other.tokens)
        self.words.extend(other.words)
        self.offsets.extend(
            [(s + starting_offset, e + starting_offset) for (s, e) in other.offsets]
        )
        self.special_tokens_mask.extend(other.special_tokens_mask)
        self.attention_mask.extend(other.attention_mask)

    # ------------------------------------------------------------------ pad

    def pad(
        self,
        target_length: int,
        pad_id: int = 0,
        pad_type_id: int = 0,
        pad_token: str = "[PAD]",
        direction: str = "right",
    ) -> None:
        for enc in self.overflowing:
            enc.pad(target_length, pad_id, pad_type_id, pad_token, direction)
        n = len(self.ids)
        if n >= target_length:
            return
        pad_len = target_length - n
        if direction == "right":
            self.ids += [pad_id] * pad_len
            self.type_ids += [pad_type_id] * pad_len
            self.tokens += [pad_token] * pad_len
            self.words += [None] * pad_len
            self.offsets += [(0, 0)] * pad_len
            self.special_tokens_mask += [1] * pad_len
            self.attention_mask += [0] * pad_len
        elif direction == "left":
            self.ids = [pad_id] * pad_len + self.ids
            self.type_ids = [pad_type_id] * pad_len + self.type_ids
            self.tokens = [pad_token] * pad_len + self.tokens
            self.words = [None] * pad_len + self.words
            self.offsets = [(0, 0)] * pad_len + self.offsets
            self.special_tokens_mask = [1] * pad_len + self.special_tokens_mask
            self.attention_mask = [0] * pad_len + self.attention_mask
            # shift sequence ranges
            self.sequence_ranges = {
                k: range(r.start + pad_len, r.stop + pad_len)
                for k, r in self.sequence_ranges.items()
            }
        else:
            raise ValueError(f"Invalid padding direction: {direction}")

    # ------------------------------------------------------------------ misc

    def token_boundaries_words(self) -> List[Optional[int]]:
        return self.words
