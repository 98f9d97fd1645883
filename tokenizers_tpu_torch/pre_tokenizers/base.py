"""The PreTokenizer base of the host path.

`pre_tokenize` takes either a `PreTokenizedString`, which it splits in
place (the JAX package's and the reference's method, the general host
pipeline's), or a `str`, for which it returns the words (the fast host
path and the trainers' feed).  `pre_tokenize_str` gives each split's
text and char offsets in the original, as the reference binding does.
A subclass implements `_split(pretokenized)`, and may give `words` a
faster form.
"""

from __future__ import annotations

from typing import List, Tuple

from ..normalized import NormalizedString, char_to_byte_offsets
from ..pretokenized import PreTokenizedString


class PreTokenizer:
    def _split(self, pretokenized: PreTokenizedString) -> None:
        raise NotImplementedError

    def pre_tokenize(self, pretokenized):
        """Split a PreTokenizedString in place; for a str, its words."""
        if isinstance(pretokenized, str):
            return self.words(pretokenized)
        self._split(pretokenized)
        return None

    def words(self, text: str) -> List[str]:
        """The text of each split of `text`."""
        p = PreTokenizedString(text)
        self._split(p)
        return [s for s, _o, _t in p.get_splits("original", "byte")]

    def pre_tokenize_str(self, sequence: str) -> List[Tuple[str, Tuple[int, int]]]:
        p = PreTokenizedString(sequence)
        self._split(p)
        return [(s, o) for s, o, _t in p.get_splits("original", "char")]

    @staticmethod
    def custom(obj) -> "CustomPreTokenizer":
        """Wrap a user object with a `pre_tokenize(PreTokenizedString)`
        method (reference `bindings/python/src/pre_tokenizers.rs:146`):
        host only, and `to_str` refuses it."""
        return CustomPreTokenizer(obj)


class CustomPreTokenizer(PreTokenizer):
    def __init__(self, obj):
        if not callable(getattr(obj, "pre_tokenize", None)):
            raise TypeError("custom pre-tokenizer must have a "
                            "pre_tokenize(PreTokenizedString) method")
        self.obj = obj

    def _split(self, pretokenized: PreTokenizedString) -> None:
        self.obj.pre_tokenize(pretokenized)


def slices(ns: NormalizedString, spans) -> List[NormalizedString]:
    """The parts of `ns` on char spans of its normalized text."""
    text = ns.get()
    nb, ob = text.encode("utf-8"), ns.original.encode("utf-8")
    if text.isascii():
        return [ns._slice(nb, ob, s, e, "normalized") for s, e in spans]
    cb = char_to_byte_offsets(text)
    return [ns._slice(nb, ob, cb[s], cb[e], "normalized") for s, e in spans]
