"""The llama-3 split pattern and the fast host path's rule for it.

`LLAMA3_PATTERN` is copied from `tokenizers_tpu.ops.bpe_engine`.  A
`Split` of it (Isolated, not inverted) before a `ByteLevel` without its
regex is the llama-3 pipeline, which the device engine runs
(`ops/bpe_engine.py` compares the pattern string, as JAX does).  The fast
host path does not run that regex: `llama3_spans` cuts the text at the
match starts of `ops.llama3_presplit.llama3_boundaries`, the rule the
device program uses, run on the CPU over one row.  Every char of a text
lies in some match of that pattern, so the match starts are the whole
split.  The general pipeline matches the pattern itself (`pattern.py`).
"""

from __future__ import annotations

from typing import List, Tuple

from .byte_level import boundary_spans

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def llama3_spans(data: bytes) -> List[Tuple[int, int]]:
    """The byte spans of the llama-3 pieces of UTF-8 bytes."""
    from ..ops.llama3_presplit import llama3_boundaries

    return boundary_spans(data, llama3_boundaries)
