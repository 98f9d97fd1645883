"""Whitespace and WhitespaceSplit of the host path (reference
`pre_tokenizers/whitespace.rs`): `\\w+|[^\\w\\s]+` matches, and runs of
non-whitespace.  They split by the same committed class tables as the
device program (`ops/wordlevel_encode.wordlevel_class_tables`), not by a
regex, so host and card split alike."""

from __future__ import annotations

from typing import List, Tuple

from ..ops.wordlevel_encode import WL_END, WL_PUNCT, WL_WS, char_classes
from .base import PreTokenizer, slices


def class_spans(classes) -> List[Tuple[int, int]]:
    """(start, end) of each word of a run of char classes: whitespace
    splits and is removed, a change of class starts a word, and a
    WL_PUNCT char is a word of its own (`wordlevel_encode.word_boundaries`)."""
    out = []
    start, prev = -1, WL_END
    for i, c in enumerate(classes):
        if c == WL_WS or start < 0 or c != prev or c == WL_PUNCT:
            if start >= 0:
                out.append((start, i))
            start = -1 if c == WL_WS else i
        prev = c
    if start >= 0:
        out.append((start, len(classes)))
    return out


class _ClassSplit(PreTokenizer):
    kind = ""

    def pre_tokenize_spans(self, text: str) -> List[Tuple[str, int, int]]:
        """(word, start, end) of each word, spans in chars of `text`."""
        return [(text[s:e], s, e) for s, e in class_spans(char_classes(self.kind, text))]

    def words(self, text: str) -> List[str]:
        return [w for w, _s, _e in self.pre_tokenize_spans(text)]

    def _split(self, pretokenized) -> None:
        pretokenized.split(lambda _i, ns: slices(
            ns, class_spans(char_classes(self.kind, ns.get()))))


class Whitespace(_ClassSplit):
    kind = "whitespace"


class WhitespaceSplit(_ClassSplit):
    kind = "whitespace_split"
