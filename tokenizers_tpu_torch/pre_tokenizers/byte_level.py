"""ByteLevel pre-tokenizer of the host path: the GPT-2 byte -> printable
char table (copied from `tokenizers_tpu.pre_tokenizers.byte_level`) and
the GPT-2 split, which `use_regex=False` leaves out.

The split does not run the GPT-2 regex.  It takes the match starts of
`'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
\\s+(?!\\S)|\\s+` from `ops.bpe_encode.gpt2_boundaries`, the rule the
device program uses, run on the CPU over one row as long as the text.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def bytes_char() -> Dict[int, str]:
    """GPT-2 byte -> unicode printable char table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTES_CHAR: Dict[int, str] = bytes_char()
CHAR_BYTES: Dict[str, int] = {c: b for b, c in BYTES_CHAR.items()}

_cls_table = None


def _cpu_cls_table() -> torch.Tensor:
    global _cls_table
    if _cls_table is None:
        from ..ops.unicode_tables import char_class_flat

        _cls_table = torch.from_numpy(char_class_flat())
    return _cls_table


class ByteLevel:
    def __init__(self, add_prefix_space: bool = True, trim_offsets: bool = True,
                 use_regex: bool = True):
        self.add_prefix_space = add_prefix_space
        self.trim_offsets = trim_offsets
        self.use_regex = use_regex

    def pre_tokenize(self, text: str) -> List[str]:
        """`text` -> its words, each as byte-level chars: the GPT-2 words,
        or without the regex the whole text as one word."""
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        data = text.encode("utf-8")
        words = gpt2_split(data) if self.use_regex else [data] if data else []
        return ["".join(BYTES_CHAR[b] for b in w) for w in words]


def split_at_boundaries(data: bytes, boundaries) -> List[bytes]:
    """The words of UTF-8 bytes, cut at the match starts that
    `boundaries(b, inb, cls_table, ascii_only)` (a pre-split rule of the
    device program) finds, run on the CPU over one row."""
    if not data:
        return []
    b = torch.from_numpy(np.frombuffer(data, np.uint8).astype(np.int32))[None]
    ascii_only = max(data) < 128
    bnd, _ = boundaries(
        b, torch.ones_like(b, dtype=torch.bool),
        None if ascii_only else _cpu_cls_table(), ascii_only=ascii_only,
    )
    starts = torch.nonzero(bnd[0]).flatten().tolist()
    return [data[s:e] for s, e in zip(starts, starts[1:] + [len(data)])]


def gpt2_split(data: bytes) -> List[bytes]:
    """The GPT-2 words of UTF-8 bytes."""
    from ..ops.bpe_encode import gpt2_boundaries

    return split_at_boundaries(data, gpt2_boundaries)
