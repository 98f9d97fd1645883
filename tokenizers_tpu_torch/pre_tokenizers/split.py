"""The Split and Sequence pre-tokenizers of the llama-3 pipeline, host
path.

`Split` admits one pattern, the llama-3 split (`LLAMA3_PATTERN`, copied
from `tokenizers_tpu.ops.bpe_engine`), with the Isolated behaviour and no
inversion.  It does not run the regex: it cuts the text at the match
starts of `ops.llama3_presplit.llama3_boundaries`, the rule the device
program uses, run on the CPU over one row.  Every char of a text lies in
some match of that pattern, so the match starts are the whole split.

`Sequence` is exactly [Split, ByteLevel(use_regex=False)]: the split,
then each piece as byte-level chars.  Both give each piece's byte span
in the text too (`pre_tokenize_spans`).
"""

from __future__ import annotations

from typing import List, Tuple

from .byte_level import BYTES_CHAR, ByteLevel, boundary_spans

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


class Split:
    """Split(LLAMA3_PATTERN, "Isolated", invert=False)."""

    def spans(self, data: bytes) -> List[Tuple[int, int]]:
        """The byte spans of the llama-3 pieces of UTF-8 bytes."""
        from ..ops.llama3_presplit import llama3_boundaries

        return boundary_spans(data, llama3_boundaries)


class Sequence:
    """[Split, ByteLevel(use_regex=False, add_prefix_space=False)]."""

    def __init__(self, split: Split, byte_level: ByteLevel):
        self.split = split
        self.byte_level = byte_level

    def pre_tokenize(self, text: str) -> List[str]:
        return [w for w, _s, _e in self.pre_tokenize_spans(text)[0]]

    def pre_tokenize_spans(self, text: str) -> Tuple[List[Tuple[str, int, int]], int]:
        """(words, 0): each piece as byte-level chars with its byte span in
        `text` (the ByteLevel adds no prefix space and keeps a piece whole)."""
        data = text.encode("utf-8")
        return [("".join(BYTES_CHAR[b] for b in data[s:e]), s, e)
                for s, e in self.split.spans(data)], 0
