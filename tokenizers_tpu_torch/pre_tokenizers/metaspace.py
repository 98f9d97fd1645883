"""Metaspace pre-tokenizer of the host path; copy of
`tokenizers_tpu.pre_tokenizers.metaspace` (reference
`pre_tokenizers/metaspace.rs:123-147`) for the replacement `▁` with its
split (the loader admits no other): every space becomes `▁`, which is
prepended to the text where the prepend scheme asks ("always"; "first":
only the text's first piece; "never") and it does not already start
with one; each `▁` starts a word (MergedWithNext).  As a decoder
(`decode_chain`, `metaspace.rs:150-170`) every replacement char becomes a
space, and the first token's are dropped unless the scheme is "never";
the decoder may name another replacement char."""

from __future__ import annotations

from typing import List, Tuple


REPLACEMENT = "▁"


class Metaspace:
    def __init__(self, prepend_scheme: str = "always", replacement: str = REPLACEMENT,
                 split: bool = True):
        """`split` is kept for `tokenizer.json`: the pre-tokenizer always
        splits (the loader refuses `split: false` there), the decoder
        does not use it."""
        if prepend_scheme not in ("always", "first", "never"):
            raise ValueError(f"Invalid prepend_scheme: {prepend_scheme}")
        if len(replacement) != 1:
            raise ValueError("replacement must be a single char")
        self.prepend_scheme = prepend_scheme
        self.replacement = replacement  # the decoder's; the split is `▁`'s
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

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out = []
        for i, token in enumerate(tokens):
            drop = i == 0 and self.prepend_scheme != "never"
            out.append("".join(("" if drop else " ") if c == self.replacement else c
                               for c in token))
        return out

    def decode(self, tokens: List[str]) -> str:
        return "".join(self.decode_chain(tokens))
