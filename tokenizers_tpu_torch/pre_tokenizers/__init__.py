"""Pre-tokenizers of the host path; port of `tokenizers_tpu.pre_tokenizers`
(reference `pre_tokenizers/`).

Each splits a `PreTokenizedString` in place (`pre_tokenize`, the general
pipeline) and gives `pre_tokenize_str` (`base.py`).  Whitespace,
WhitespaceSplit, BertPreTokenizer, ByteLevel and Metaspace also keep the
span methods the device engines and the fast host path call
(`pre_tokenize_spans`, `words`); a `Sequence` of the llama-3 `Split` and
a `ByteLevel` without its regex or a prefix space gives the llama-3
pieces by the device's rule (`split.llama3_spans`).
"""

from __future__ import annotations

import unicodedata
from typing import List, Tuple

from ..normalized import (
    BEHAVIORS,
    CONTIGUOUS,
    ISOLATED,
    MERGED_WITH_NEXT,
    MERGED_WITH_PREVIOUS,
    REMOVED,
    NormalizedString,
)
from ..pattern import Invert, SysRegex
from ..pretokenized import PreTokenizedString
from .base import CustomPreTokenizer, PreTokenizer, slices
from .bert import BertPreTokenizer, is_punc
from .byte_level import BYTES_CHAR, ByteLevel
from .metaspace import PREPEND_ALWAYS, PREPEND_FIRST, PREPEND_NEVER, Metaspace
from .split import LLAMA3_PATTERN, llama3_spans
from .unicode_scripts import UnicodeScripts
from .whitespace import Whitespace, WhitespaceSplit

class Sequence(PreTokenizer):
    def __init__(self, pretokenizers: List[PreTokenizer]):
        self.pretokenizers = list(pretokenizers)

    def _split(self, pretokenized) -> None:
        for p in self.pretokenizers:
            p.pre_tokenize(pretokenized)

    def __getitem__(self, i):
        return self.pretokenizers[i]

    def __len__(self):
        return len(self.pretokenizers)

    def is_llama3(self, prefix_space: bool = False) -> bool:
        """Whether this is [Split(LLAMA3_PATTERN, Isolated), ByteLevel without
        its regex], the ByteLevel adding a prefix space iff `prefix_space`."""
        if len(self.pretokenizers) != 2:
            return False
        sp, bl = self.pretokenizers
        return (isinstance(sp, Split) and sp.is_llama3() and isinstance(bl, ByteLevel)
                and not bl.use_regex and bl.add_prefix_space == prefix_space)

    def pre_tokenize_spans(self, text: str) -> Tuple[List[Tuple[str, int, int]], int]:
        """(words, 0) of the llama-3 Sequence (`is_llama3()`): each piece as
        byte-level chars with its byte span in `text`."""
        data = text.encode("utf-8")
        return [("".join(BYTES_CHAR[b] for b in data[s:e]), s, e)
                for s, e in llama3_spans(data)], 0

    def words(self, text: str) -> List[str]:
        if self.is_llama3():
            return [w for w, _s, _e in self.pre_tokenize_spans(text)[0]]
        return super().words(text)


class CharDelimiterSplit(PreTokenizer):
    def __init__(self, delimiter: str):
        if len(delimiter) != 1:
            raise ValueError("delimiter must be a single char")
        self.delimiter = delimiter

    def _split(self, pretokenized) -> None:
        d = self.delimiter
        pretokenized.split(lambda _i, ns: ns.split(lambda c: c == d, REMOVED))


class Punctuation(PreTokenizer):
    """Each punctuation char (ASCII or a P* category) as the behaviour
    says (reference `pre_tokenizers/punctuation.rs`)."""

    def __init__(self, behavior: str = ISOLATED):
        if behavior not in BEHAVIORS:
            raise ValueError(f"Unknown split behavior: {behavior}")
        self.behavior = behavior

    def _split(self, pretokenized) -> None:
        pretokenized.split(lambda _i, ns: ns.split(is_punc, self.behavior))


def is_numeric(c: str) -> bool:
    """Rust's `char::is_numeric`: categories Nd, Nl, No."""
    return unicodedata.category(c)[0] == "N"


class Digits(PreTokenizer):
    def __init__(self, individual_digits: bool = False):
        self.individual_digits = individual_digits

    def _split(self, pretokenized) -> None:
        behavior = ISOLATED if self.individual_digits else CONTIGUOUS
        pretokenized.split(lambda _i, ns: ns.split(is_numeric, behavior))


class Split(PreTokenizer):
    """A pattern, a behaviour and `invert` (reference
    `pre_tokenizers/split.rs`): `pattern` is a literal string, a
    `pattern.Regex`/`SysRegex`, or ("Regex", text) as the JAX package
    takes it."""

    def __init__(self, pattern, behavior: str, invert: bool = False):
        if isinstance(pattern, tuple) and len(pattern) == 2 and pattern[0] == "Regex":
            pattern = SysRegex(pattern[1])
        if isinstance(pattern, SysRegex):
            self.pattern_kind, self.pattern_str, self.regex = "Regex", pattern.pattern, pattern
        elif isinstance(pattern, str):
            self.pattern_kind, self.pattern_str, self.regex = "String", pattern, pattern
        else:
            raise TypeError(f"a Split pattern is a str or a Regex, not {type(pattern)}")
        if behavior not in BEHAVIORS:
            raise ValueError(f"Unknown split behavior: {behavior}")
        self.behavior = behavior
        self.invert = invert

    def is_llama3(self) -> bool:
        return (self.pattern_kind, self.pattern_str, self.behavior, self.invert) == (
            "Regex", LLAMA3_PATTERN, ISOLATED, False)

    def _split(self, pretokenized) -> None:
        pat = Invert(self.regex) if self.invert else self.regex
        pretokenized.split(lambda _i, ns: ns.split(pat, self.behavior))


class FixedLength(PreTokenizer):
    """Pieces of `length` chars (reference `pre_tokenizers/fixed_length.rs`)."""

    def __init__(self, length: int = 5):
        self.length = length

    def _split(self, pretokenized) -> None:
        def split_fn(_i, ns: NormalizedString):
            n = len(ns.get())
            return slices(ns, [(s, min(s + self.length, n)) for s in range(0, n, self.length)])

        pretokenized.split(split_fn)


__all__ = [
    "PreTokenizer", "CustomPreTokenizer", "Sequence", "Whitespace", "WhitespaceSplit",
    "BertPreTokenizer", "CharDelimiterSplit", "Punctuation", "Digits", "Split",
    "FixedLength", "ByteLevel", "Metaspace", "UnicodeScripts", "PREPEND_ALWAYS",
    "PREPEND_FIRST", "PREPEND_NEVER",
]

BEHAVIOR_TO_JSON = {"removed": "Removed", "isolated": "Isolated",
                    "merged_with_previous": "MergedWithPrevious",
                    "merged_with_next": "MergedWithNext", "contiguous": "Contiguous"}
BEHAVIOR_FROM_JSON = {v: k for k, v in BEHAVIOR_TO_JSON.items()}


def _pattern_from_json(d: dict):
    if "String" in d:
        return d["String"]
    if "Regex" in d:
        return SysRegex(d["Regex"])
    from ..errors import SerdeError

    raise SerdeError(f"Unknown pattern: {d}")


def from_json(d):
    """The pre-tokenizer of a tokenizer.json node, as the JAX package's
    `pre_tokenizer_from_dict` reads it (keys it does not read are
    ignored; an unknown type raises SerdeError)."""
    if d is None:
        return None
    t = d.get("type")
    if t == "Sequence":
        return Sequence([from_json(x) for x in d["pretokenizers"]])
    if t == "ByteLevel":
        return ByteLevel(d.get("add_prefix_space", True), d.get("trim_offsets", True),
                         d.get("use_regex", True))
    if t in ("BertPreTokenizer", "Whitespace", "WhitespaceSplit", "UnicodeScripts"):
        return {"BertPreTokenizer": BertPreTokenizer, "Whitespace": Whitespace,
                "WhitespaceSplit": WhitespaceSplit, "UnicodeScripts": UnicodeScripts}[t]()
    if t == "Metaspace":
        scheme = d.get("prepend_scheme", PREPEND_ALWAYS)
        if d.get("add_prefix_space") is False:
            scheme = PREPEND_NEVER
        elif d.get("add_prefix_space") is True and "prepend_scheme" not in d:
            scheme = PREPEND_ALWAYS
        return Metaspace(d["replacement"], scheme, d.get("split", True))
    if t == "Split":
        return Split(_pattern_from_json(d["pattern"]), BEHAVIOR_FROM_JSON[d["behavior"]],
                     d.get("invert", False))
    if t == "CharDelimiterSplit":
        return CharDelimiterSplit(d["delimiter"])
    if t == "Punctuation":
        return Punctuation(BEHAVIOR_FROM_JSON[d.get("behavior", "Isolated")])
    if t == "Digits":
        return Digits(d.get("individual_digits", False))
    if t == "FixedLength":
        return FixedLength(d.get("length", 5))
    from ..errors import SerdeError

    raise SerdeError(f"Unknown pre-tokenizer type: {t}")
