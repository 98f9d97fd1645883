"""BertNormalizer of the host path; copy of
`tokenizers_tpu.normalizers.BertNormalizer` and its predicates.

Four per-char transforms, in order: clean_text (drop NUL, U+FFFD and
control chars, map whitespace to a space), CJK padding (a space on each
side of a CJK ideograph), strip_accents (NFD, then drop the Mn marks; on
by default when lowercase is) and lowercase (char by char, as the
reference's `char::to_lowercase`).  Every stage maps one char to an
independent string, so the normalizer is a per-char map (`char_map`):
the device tables (`ops/bert_tables.py`) are built from the same
function, so host and device agree byte for byte.  NFD's canonical
reordering only permutes the Mn marks that strip_accents then drops.

`normalize_chars` gives the normalized text and, per normalized char,
the index of the source char it came from, through which the WordPiece
path maps offsets back to the original text.  `normalize` applies the
same map to a `NormalizedString` (each output char aligned to its source
char, as the reference's chain of filter, map, NFD and lowercase aligns
it), for the pipelines whose offsets map through alignments.
"""

from __future__ import annotations

import functools
import unicodedata
from typing import List, Optional, Tuple

from . import Normalizer

# the Unicode White_Space property (Rust `char::is_whitespace`); not
# Python's str.isspace(), which also holds 0x1C-0x1F
WHITESPACE_CPS = frozenset(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B))
    + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)
WHITESPACE = "".join(map(chr, sorted(WHITESPACE_CPS)))


def is_whitespace(c: str) -> bool:
    return ord(c) in WHITESPACE_CPS


def is_bert_whitespace(c: str) -> bool:
    return c in "\t\n\r" or is_whitespace(c)


def is_bert_control(c: str) -> bool:
    if c in "\t\n\r":
        return False
    return unicodedata.category(c).startswith("C")


def is_chinese_char(cp: int) -> bool:
    """The CJK Unified Ideographs blocks (reference `normalizers/bert.rs:37-48`)."""
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B920 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class _CharTable(dict):
    """codepoint -> normalized string, each computed at its first lookup."""

    def __init__(self, char_map):
        super().__init__()
        self.char_map = char_map

    def __missing__(self, cp: int) -> str:
        self[cp] = out = self.char_map(chr(cp))
        return out


class BertNormalizer(Normalizer):
    def __init__(self, clean_text: bool = True, handle_chinese_chars: bool = True,
                 strip_accents: Optional[bool] = None, lowercase: bool = True):
        self.clean_text = bool(clean_text)
        self.handle_chinese_chars = bool(handle_chinese_chars)
        self.strip_accents = strip_accents
        self.lowercase = bool(lowercase)
        self.char_map = functools.lru_cache(maxsize=1 << 16)(self._char_map)
        self._table = _CharTable(self._char_map)  # `str.translate`'s, filled as met

    @property
    def flags(self) -> Tuple[bool, bool, Optional[bool], bool]:
        return (self.clean_text, self.handle_chinese_chars, self.strip_accents,
                self.lowercase)

    def _char_map(self, c: str) -> str:
        """The normalized string of one char."""
        s = c
        cp = ord(c)
        if self.clean_text:
            if cp == 0 or cp == 0xFFFD or is_bert_control(c):
                return ""
            if is_bert_whitespace(c):
                s = " "
        if self.handle_chinese_chars and is_chinese_char(ord(s)):
            s = " " + s + " "
        strip = self.strip_accents if self.strip_accents is not None else self.lowercase
        if strip:
            s = "".join(ch for ch in unicodedata.normalize("NFD", s)
                        if unicodedata.category(ch) != "Mn")
        if s and self.lowercase:
            s = "".join(ch.lower() for ch in s)
        return s

    def normalize_chars(self, text: str) -> Tuple[str, List[int]]:
        """(normalized text, source char index of each normalized char)."""
        out: List[str] = []
        src: List[int] = []
        for i, c in enumerate(text):
            s = self.char_map(c)
            if s:
                out.append(s)
                src += [i] * len(s)
        return "".join(out), src

    def normalize_str(self, sequence: str) -> str:
        return sequence.translate(self._table)

    def normalize(self, normalized) -> None:
        """Normalize the NormalizedString `normalized` in place: drop the chars that
        map to nothing, then replace each other char by its string."""
        text = normalized.get()
        if text.isascii():
            mapped = text.translate(self._table)
            if len(mapped) == len(text):  # one char for one: the alignments stay
                normalized.normalized = mapped
                return
        normalized.filter(lambda c: bool(self.char_map(c)))
        normalized.transform([(o, 1 if k else 0) for c in normalized.get()
                      for k, o in enumerate(self.char_map(c))])
