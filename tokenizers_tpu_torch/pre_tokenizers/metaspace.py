"""Metaspace pre-tokenizer of the host path; copy of
`tokenizers_tpu.pre_tokenizers.metaspace` (reference
`pre_tokenizers/metaspace.rs:123-147`): every space becomes the
replacement char, which is prepended to the text where the prepend
scheme asks ("always"; "first": only the text's first piece; "never")
and it does not already start with one; with `split` each replacement
char starts a word (MergedWithNext).  `pre_tokenize` of a
PreTokenizedString (the general pipeline) takes any replacement and
`split`; the fast host path's `apply`, `words` and `word_spans` serve
the replacement `▁` with its split.  As a decoder
(`decode_chain`, `metaspace.rs:150-170`) every replacement char becomes a
space, and the first token's are dropped unless the scheme is "never";
the decoder may name another replacement char."""

from __future__ import annotations

from typing import List, Tuple

from .base import PreTokenizer

REPLACEMENT = "▁"
PREPEND_FIRST = "first"
PREPEND_NEVER = "never"
PREPEND_ALWAYS = "always"


class Metaspace(PreTokenizer):
    def __init__(self, replacement: str = REPLACEMENT, prepend_scheme: str = PREPEND_ALWAYS,
                 split: bool = True):
        """The decoder does not use `split`."""
        if len(replacement) != 1:
            raise ValueError("replacement must be a single char")
        if prepend_scheme not in (PREPEND_FIRST, PREPEND_NEVER, PREPEND_ALWAYS):
            raise ValueError(f"Invalid prepend_scheme: {prepend_scheme}")
        self.prepend_scheme = prepend_scheme
        self.replacement = replacement
        self.split = split

    def apply(self, ns, first: bool) -> None:
        """Replace and prepend on the NormalizedString `ns` in place;
        `first`: `ns` starts the text (the "first" scheme prepends there
        only)."""
        ns.replace(" ", REPLACEMENT)
        if self._prepends(ns.get(), first):
            ns.prepend(REPLACEMENT)

    def _prepends(self, text: str, first: bool) -> bool:
        return (self.prepend_scheme == "always" or (self.prepend_scheme == "first" and first)) \
            and not text.startswith(REPLACEMENT)

    def _split(self, pretokenized) -> None:
        from ..normalized import MERGED_WITH_NEXT

        rep = self.replacement

        def split_fn(_i, ns):
            ns.replace(" ", rep)
            if not ns.get().startswith(rep) and (self.prepend_scheme == "always" or (
                    self.prepend_scheme == "first" and ns.original_shift == 0)):
                ns.prepend(rep)
            return ns.split(rep, MERGED_WITH_NEXT) if self.split else [ns]

        pretokenized.split(split_fn)

    def words(self, text: str, first: bool = True) -> List[str]:
        """The words of `text` (replaced and prepended as `apply` does)."""
        text = text.replace(" ", REPLACEMENT)
        if self._prepends(text, first):
            text = REPLACEMENT + text
        return [text[s:e] for s, e in self.word_spans(text)]

    @staticmethod
    def word_spans(text: str) -> List[Tuple[int, int]]:
        """(start, end) in chars of each word of the replaced text."""
        heads = [i for i, c in enumerate(text) if c == REPLACEMENT and i > 0]
        return list(zip([0] + heads, heads + [len(text)])) if text else []

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out = []
        for i, token in enumerate(tokens):
            drop = i == 0 and self.prepend_scheme != "never"
            out.append("".join(("" if drop else " ") if c == self.replacement else c
                               for c in token))
        return out

    def decode(self, tokens: List[str]) -> str:
        return "".join(self.decode_chain(tokens))
