"""Metaspace pre-tokenizer of the host path; copy of
`tokenizers_tpu.pre_tokenizers.metaspace` (reference
`pre_tokenizers/metaspace.rs:123-147`) for the replacement `▁` with its
split (the loader admits no other): every space becomes `▁`, which is
prepended to the text where the prepend scheme asks ("always"; "first":
only the text's first piece; "never") and it does not already start
with one; each `▁` starts a word (MergedWithNext)."""

from __future__ import annotations

from typing import List, Tuple


REPLACEMENT = "▁"


class Metaspace:
    def __init__(self, prepend_scheme: str = "always"):
        if prepend_scheme not in ("always", "first", "never"):
            raise ValueError(f"Invalid prepend_scheme: {prepend_scheme}")
        self.prepend_scheme = prepend_scheme

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

    def pre_tokenize(self, text: str, first: bool = True) -> List[str]:
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
