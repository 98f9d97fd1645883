"""ByteLevel pre-tokenizer of the host path: the GPT-2 byte -> printable
char table (copied from `tokenizers_tpu.pre_tokenizers.byte_level`) and
the GPT-2 split, which `use_regex=False` leaves out; and, as a
post-processor, the trimming of whitespace from token offsets
(`process_offsets`, copied from the same module); as a decoder
(`decode_chain`), the byte-level chars back to bytes and UTF-8 text.

The fast host path's split does not run the GPT-2 regex.  It takes the
match starts of `GPT2_SPLIT_PATTERN` from `ops.bpe_encode.gpt2_boundaries`, the
rule the device program uses, run on the CPU over one row as long as the
text.  The general pipeline's `pre_tokenize` of a PreTokenizedString
(reference `pre_tokenizers/byte_level.rs:126-150`) prepends the space to
each split that lacks one, splits it by the pattern (`pattern.SysRegex`),
and maps every byte of each part to its char.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .base import PreTokenizer

GPT2_SPLIT_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


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


_GPT2_RE = None


def _gpt2_re():
    global _GPT2_RE
    if _GPT2_RE is None:
        from ..pattern import SysRegex

        _GPT2_RE = SysRegex(GPT2_SPLIT_PATTERN)
    return _GPT2_RE


def to_byte_chars(ns) -> None:
    """Every byte of the NormalizedString `ns` as its char, in place (a
    char's first byte takes its place, the others are insertions)."""
    ns.transform([(BYTES_CHAR[b], 1 if k else 0) for c in ns.get()
                  for k, b in enumerate(c.encode("utf-8"))])


class ByteLevel(PreTokenizer):
    def __init__(self, add_prefix_space: bool = True, trim_offsets: bool = True,
                 use_regex: bool = True):
        self.add_prefix_space = add_prefix_space
        self.trim_offsets = trim_offsets
        self.use_regex = use_regex

    def words(self, text: str) -> List[str]:
        """`text` -> its words, each as byte-level chars: the GPT-2 words,
        or without the regex the whole text as one word."""
        return [w for w, _s, _e in self.pre_tokenize_spans(text)[0]]

    def _split(self, pretokenized) -> None:
        from ..normalized import ISOLATED

        def split_fn(_i, ns):
            if self.add_prefix_space and not ns.get().startswith(" "):
                ns.prepend(" ")
            return ns.split(_gpt2_re(), ISOLATED) if self.use_regex else [ns]

        pretokenized.split(split_fn)
        pretokenized.normalize(to_byte_chars)

    def pre_tokenize_spans(self, text: str) -> Tuple[List[Tuple[str, int, int]], int]:
        """(words, shift): each word as byte-level chars with its byte span
        in the prepared text (`text`, after the prefix space when one is
        added), and shift = 1 when it was (0 else): a prepared byte p is
        the text's byte max(p - shift, 0)."""
        shift = int(self.add_prefix_space and not text.startswith(" "))
        data = (" " * shift + text).encode("utf-8")
        if self.use_regex:
            from ..ops.bpe_encode import gpt2_boundaries

            spans = boundary_spans(data, gpt2_boundaries)
        else:
            spans = [(0, len(data))] if data else []
        return [("".join(BYTES_CHAR[b] for b in data[s:e]), s, e) for s, e in spans], shift


    def decode_chain(self, tokens: List[str]) -> List[str]:
        """One string: each token's chars mapped back to their bytes (a
        token with a char outside the table keeps its own UTF-8 bytes),
        all decoded with U+FFFD for what is not UTF-8 (reference
        `byte_level.rs:160-180`, `from_utf8_lossy`)."""
        out = bytearray()
        for t in tokens:
            bs = [CHAR_BYTES.get(c) for c in t]
            out.extend(t.encode("utf-8") if None in bs else bs)
        return [out.decode("utf-8", errors="replace")]

    def decode(self, tokens: List[str]) -> str:
        return "".join(self.decode_chain(tokens))

    # the post-processor role: no tokens added, offsets trimmed
    @staticmethod
    def alphabet():
        return set(BYTES_CHAR.values())

    def added_tokens(self, is_pair: bool) -> int:
        return 0

    def process_encodings(self, encodings, add_special_tokens: bool):
        if self.trim_offsets:
            for encoding in encodings:
                process_offsets(encoding, self.add_prefix_space)
                for overflow in encoding.overflowing:
                    process_offsets(overflow, self.add_prefix_space)
        for i, encoding in enumerate(encodings):
            encoding.set_sequence_id(i)
        return encodings

    def process(self, encoding, pair_encoding=None, add_special_tokens: bool = True):
        from ..processors import process_pair

        return process_pair(self, encoding, pair_encoding, add_special_tokens)


def boundary_spans(data: bytes, boundaries) -> List[Tuple[int, int]]:
    """The byte spans of the words of UTF-8 bytes, cut at the match starts
    that `boundaries(b, inb, cls_table, ascii_only)` (a pre-split rule of
    the device program) finds, run on the CPU over one row."""
    if not data:
        return []
    b = torch.from_numpy(np.frombuffer(data, np.uint8).astype(np.int32))[None]
    ascii_only = max(data) < 128
    bnd, _ = boundaries(
        b, torch.ones_like(b, dtype=torch.bool),
        None if ascii_only else _cpu_cls_table(), ascii_only=ascii_only,
    )
    starts = torch.nonzero(bnd[0]).flatten().tolist()
    return list(zip(starts, starts[1:] + [len(data)]))


def gpt2_split(data: bytes) -> List[bytes]:
    """The GPT-2 words of UTF-8 bytes."""
    from ..ops.bpe_encode import gpt2_boundaries

    return [data[s:e] for s, e in boundary_spans(data, gpt2_boundaries)]


# Oniguruma's \s, which the reference's `char::is_whitespace` matches here
_WHITESPACE_CPS = frozenset(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B))
    + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)
_SPACE_CHAR = BYTES_CHAR[ord(" ")]


def _is_space(c: str) -> bool:
    return c == _SPACE_CHAR or ord(c) in _WHITESPACE_CPS


def process_offsets(encoding, add_prefix_space: bool) -> None:
    """Trim leading and trailing spaces (`Ġ` or whitespace) of each token
    from its offsets, in place (reference `byte_level.rs:202-234`).  A
    first token (the first, or one at offset 0) keeps one leading space
    when `add_prefix_space`: that space was added, not in the text."""
    if not any(encoding.tokens):  # the ids-only paths' empty tokens
        return
    for i, token in enumerate(encoding.tokens):
        leading = 0
        while leading < len(token) and _is_space(token[leading]):
            leading += 1
        trailing = 0
        while trailing < len(token) and _is_space(token[-1 - trailing]):
            trailing += 1
        if leading == 0 and trailing == 0:
            continue
        start, end = encoding.offsets[i]
        if leading > 0:
            if (i == 0 or start == 0) and add_prefix_space and leading == 1:
                leading = 0
            start = min(start + leading, end)
        if trailing > 0 and end >= trailing:
            end = max(end - trailing, start)
        encoding.offsets[i] = (start, end)
