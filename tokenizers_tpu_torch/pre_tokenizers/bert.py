"""BertPreTokenizer of the host path (reference `pre_tokenizers/bert.rs`):
whitespace splits the text and is removed; each punctuation char is a
word of its own.  Runs on the normalized text."""

from __future__ import annotations

import unicodedata
from typing import List, Tuple

from ..normalizers.bert import is_whitespace
from .base import PreTokenizer, slices

_ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def is_punc(c: str) -> bool:
    """ASCII punctuation or a char of a Unicode P* category."""
    return c in _ASCII_PUNCT or unicodedata.category(c).startswith("P")


class BertPreTokenizer(PreTokenizer):
    def pre_tokenize_spans(self, text: str) -> List[Tuple[str, int, int]]:
        """(word, start, end) of each word, spans in chars of `text`."""
        out = []
        start = -1
        for i, c in enumerate(text):
            if is_whitespace(c) or is_punc(c):
                if start >= 0:
                    out.append((text[start:i], start, i))
                    start = -1
                if not is_whitespace(c):
                    out.append((c, i, i + 1))
            elif start < 0:
                start = i
        if start >= 0:
            out.append((text[start:], start, len(text)))
        return out

    def words(self, text: str) -> List[str]:
        return [w for w, _s, _e in self.pre_tokenize_spans(text)]

    def _split(self, pretokenized) -> None:
        pretokenized.split(lambda _i, ns: slices(
            ns, [(s, e) for _w, s, e in self.pre_tokenize_spans(ns.get())]))
