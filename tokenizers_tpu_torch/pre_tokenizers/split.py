"""The Split and Sequence pre-tokenizers of the llama-3 pipeline, host
path.

`Split` admits one pattern, the llama-3 split (`LLAMA3_PATTERN`, copied
from `tokenizers_tpu.ops.bpe_engine`), with the Isolated behaviour and no
inversion.  It does not run the regex: it cuts the text at the match
starts of `ops.llama3_presplit.llama3_boundaries`, the rule the device
program uses, run on the CPU over one row.  Every char of a text lies in
some match of that pattern, so the match starts are the whole split.

`Sequence` is exactly [Split, ByteLevel(use_regex=False)]: the split,
then each piece as byte-level chars.
"""

from __future__ import annotations

from typing import List

from .byte_level import ByteLevel, split_at_boundaries

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def llama3_split(data: bytes) -> List[bytes]:
    """The llama-3 pieces of UTF-8 bytes."""
    from ..ops.llama3_presplit import llama3_boundaries

    return split_at_boundaries(data, llama3_boundaries)


class Split:
    """Split(LLAMA3_PATTERN, "Isolated", invert=False)."""

    def pre_tokenize(self, text: str) -> List[str]:
        return [w.decode("utf-8") for w in llama3_split(text.encode("utf-8"))]


class Sequence:
    """[Split, ByteLevel(use_regex=False)]."""

    def __init__(self, split: Split, byte_level: ByteLevel):
        self.split = split
        self.byte_level = byte_level

    def pre_tokenize(self, text: str) -> List[str]:
        return [w for piece in self.split.pre_tokenize(text)
                for w in self.byte_level.pre_tokenize(piece)]
