"""PreTokenizedString: the general host pipeline's string, from split to
Encoding; port of `tokenizers_tpu.pretokenized` (reference
`tokenizer/pre_tokenizer.rs`).

A list of `Split`s, each a NormalizedString slice of one original string
with the tokens the model gave it (None before `tokenize`, or the
added token's for one the added vocabulary extracted).  Pre-tokenizers
`split` the untokenized ones; `into_encoding` maps each token's offsets
in its split's normalized bytes back to the original string, in bytes or
chars.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

from .encoding import Encoding
from .normalized import NormalizedString

# offset types
BYTE = "byte"
CHAR = "char"
NONE = "none"

# offset referentials (get_splits)
ORIGINAL = "original"
NORMALIZED = "normalized"


class Token:
    __slots__ = ("id", "value", "offsets")

    def __init__(self, id: int, value: str, offsets: Tuple[int, int]):
        self.id = id
        self.value = value
        self.offsets = offsets

    def __repr__(self):
        return f"Token(id={self.id}, value={self.value!r}, offsets={self.offsets})"

    def __eq__(self, other):
        return (isinstance(other, Token) and self.id == other.id and self.value == other.value
                and self.offsets == other.offsets)


class Split:
    __slots__ = ("normalized", "tokens")

    def __init__(self, normalized: NormalizedString, tokens: Optional[List[Token]] = None):
        self.normalized = normalized
        self.tokens = tokens


class PreTokenizedString:
    __slots__ = ("original", "splits")

    def __init__(self, s):
        normalized = s if isinstance(s, NormalizedString) else NormalizedString(s)
        self.original: str = normalized.get_original()
        self.splits: List[Split] = [Split(normalized)]

    def split(self, split_fn: Callable[[int, NormalizedString], Iterable]) -> None:
        """`split_fn(index, normalized)` on every untokenized split; it gives
        NormalizedStrings, (NormalizedString, tokens or None) pairs or
        Splits, which replace it (empty ones dropped)."""
        new_splits: List[Split] = []
        for i, original_split in enumerate(self.splits):
            if original_split.tokens is not None:
                new_splits.append(original_split)
                continue
            for item in split_fn(i, original_split.normalized):
                if isinstance(item, Split):
                    split = item
                elif isinstance(item, tuple):
                    split = Split(item[0], item[1])
                else:
                    split = Split(item)
                if not split.normalized.is_empty():
                    new_splits.append(split)
        self.splits = new_splits

    def normalize(self, normalize_fn: Callable[[NormalizedString], None]) -> None:
        for split in self.splits:
            if split.tokens is None:
                normalize_fn(split.normalized)

    def tokenize(self, tokenize_fn: Callable[[NormalizedString], List[Token]]) -> None:
        for split in self.splits:
            if split.tokens is None:
                split.tokens = tokenize_fn(split.normalized)

    def into_encoding(self, word_idx: Optional[int] = None, type_id: int = 0,
                      offset_type: str = BYTE) -> Encoding:
        """The tokens of every split as one Encoding: word index the
        split's (or `word_idx`), offsets in the original string's bytes or
        chars (`offset_type` "byte" or "char"), or with "none" ids alone
        (tokens "", offsets (0, 0), no word ids, type ids 0)."""
        if not self.splits:
            return Encoding()
        if any(split.tokens is None for split in self.splits):
            raise RuntimeError("Split has not been tokenized, call "
                               "`PreTokenizedString.tokenize` first")
        ids: List[int] = []
        if offset_type == NONE:
            for split in self.splits:
                ids.extend(t.id for t in split.tokens)
            n = len(ids)
            return Encoding(ids=ids, type_ids=[0] * n, tokens=[""] * n, words=[None] * n,
                            offsets=[(0, 0)] * n)
        tokens: List[str] = []
        offsets: List[Tuple[int, int]] = []
        words: List[Optional[int]] = []
        converter = BytesToCharOffsetConverter(self.original) if offset_type == CHAR else None
        for idx, split in enumerate(self.splits):
            normalized = split.normalized
            base = normalized.original_shift
            al = normalized.alignments
            for token in split.tokens:
                a, b = token.offsets  # normalized bytes (`convert_offsets`)
                sub = al[a:b] if a < b else None
                if a == b:
                    off = (base + a, base + b)
                elif sub:
                    off = (base + sub[0][0], base + sub[-1][1])
                else:
                    off = token.offsets
                if converter is not None:
                    off = converter.convert(off) or off
                ids.append(token.id)
                tokens.append(token.value)
                offsets.append(off)
                words.append(word_idx if word_idx is not None else idx)
        n = len(ids)
        return Encoding(ids=ids, type_ids=[type_id] * n, tokens=tokens, words=words,
                        offsets=offsets)

    def get_splits(self, offset_ref: str = ORIGINAL, offset_type: str = BYTE
                   ) -> List[Tuple[str, Tuple[int, int], Optional[List[Token]]]]:
        """(normalized text, offsets, tokens) of each split: offsets in the
        original string or in the concatenated normalized text, in bytes
        or chars of the original."""
        converter = BytesToCharOffsetConverter(self.original) if offset_type == CHAR else None
        out = []
        offset = 0
        for split in self.splits:
            if offset_ref == ORIGINAL:
                offsets = split.normalized.offsets_original()
            else:
                n = len(split.normalized)
                offset += n
                offsets = (offset - n, offset)
            if converter is not None:
                offsets = converter.convert(offsets) or offsets
            out.append((split.normalized.get(), offsets, split.tokens))
        return out


class BytesToCharOffsetConverter:
    """Original byte offsets to char offsets (reference `pre_tokenizer.rs:267`)."""

    __slots__ = ("map",)

    def __init__(self, sequence: str):
        self.map = None  # ASCII: bytes are chars
        if sequence.isascii():
            return
        m = {}
        b = 0
        for i, c in enumerate(sequence):
            n = len(c.encode("utf-8"))
            for k in range(n):
                m[b + k] = i
            b += n
        self.map = m

    def convert(self, offsets: Tuple[int, int]) -> Optional[Tuple[int, int]]:
        if self.map is None:
            return offsets
        start = self.map.get(offsets[0])
        end = self.map.get(offsets[1])
        if start is not None and end is not None:
            return (start, end)
        if start is not None and end is None:
            last = self.map.get(offsets[1] - 1)
            if last is None:
                last = start + 1
            return (start, last + 1)
        return None
