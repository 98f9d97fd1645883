"""Normalizers of the host path; copies of those of
`tokenizers_tpu.normalizers` that the WordLevel, char-level BPE and
Unigram pipelines use.  Each normalizes a `NormalizedString` in place
(`normalize`), so offsets map back through its alignments.
`normalize_str` gives the same text without the alignments, by string
operations (the ids path prepares every input with it; the tests hold
the two equal).  `BertNormalizer` (`bert.py`) has the same two methods.
`from_json` reads a tokenizer.json normalizer node of these types and
raises `NotImplementedError` on any other.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List


class Normalizer:
    def normalize(self, ns) -> None:
        raise NotImplementedError

    def normalize_str(self, s: str) -> str:
        raise NotImplementedError


class Sequence(Normalizer):
    def __init__(self, normalizers: List[Normalizer]):
        self.normalizers = list(normalizers)

    def normalize(self, ns) -> None:
        for n in self.normalizers:
            n.normalize(ns)

    def normalize_str(self, s: str) -> str:
        for n in self.normalizers:
            s = n.normalize_str(s)
        return s


class Lowercase(Normalizer):
    def normalize(self, ns) -> None:
        if ns.get().isascii():  # one byte for one byte: the alignments stay
            ns.normalized = ns.get().lower()
        else:
            ns.lowercase()

    def normalize_str(self, s: str) -> str:
        # char by char, as the reference (no final-sigma context)
        return s.lower() if s.isascii() else "".join(c.lower() for c in s)


class _Unicode(Normalizer):
    form = ""

    def normalize(self, ns) -> None:
        if not unicodedata.is_normalized(self.form, ns.get()):  # else the identity
            getattr(ns, self.form.lower())()

    def normalize_str(self, s: str) -> str:
        return s if s.isascii() else unicodedata.normalize(self.form, s)


class NFD(_Unicode):
    form = "NFD"


class NFKD(_Unicode):
    form = "NFKD"


class NFC(_Unicode):
    form = "NFC"


class NFKC(_Unicode):
    form = "NFKC"


class Strip(Normalizer):
    def __init__(self, left: bool = True, right: bool = True):
        self.left, self.right = bool(left), bool(right)

    def normalize(self, ns) -> None:
        ns.strip(self.left, self.right)

    def normalize_str(self, s: str) -> str:
        from .bert import WHITESPACE

        if self.left:
            s = s.lstrip(WHITESPACE)
        return s.rstrip(WHITESPACE) if self.right else s


_MARKS = None


class StripAccents(Normalizer):
    """Drops the combining marks (category M*), with no NFD of its own
    (reference `normalizers/strip.rs:48`)."""

    def normalize(self, ns) -> None:
        if not ns.get().isascii():  # ASCII has no marks
            ns.filter(lambda c: not unicodedata.category(c).startswith("M"))

    def normalize_str(self, s: str) -> str:
        global _MARKS
        if s.isascii():
            return s
        if _MARKS is None:
            _MARKS = dict.fromkeys(cp for cp in range(0x110000)
                                   if unicodedata.category(chr(cp)).startswith("M"))
        return s.translate(_MARKS)


class Prepend(Normalizer):
    def __init__(self, prepend: str):
        self.prepend = prepend

    def normalize(self, ns) -> None:
        if not ns.is_empty():
            ns.prepend(self.prepend)

    def normalize_str(self, s: str) -> str:
        return self.prepend + s if s else s


class Replace(Normalizer):
    """A literal pattern replaced by `content`; with `regex`, the one regex
    pattern the port admits, `" {2,}"` (a run of two or more spaces),
    matched with `re` on the UTF-8 bytes (a space byte never lies inside a
    multi-byte char).  As for a literal, the content takes the alignment
    of the match's last byte (reference `normalizer.rs:571`)."""

    REGEX_PATTERNS = (" {2,}",)  # the only ones `from_json` admits

    def __init__(self, pattern: str, content: str, regex: bool = False):
        self.pattern, self.content, self.regex = pattern, content, regex
        if regex:
            self._re = re.compile(pattern)
            self._re_bytes = re.compile(pattern.encode("utf-8"))

    def normalize(self, ns) -> None:
        ns.replace(self._re_bytes if self.regex else self.pattern, self.content)

    def normalize_str(self, s: str) -> str:
        if self.regex:
            return self._re.sub(self.content, s)
        return s.replace(self.pattern, self.content) if self.pattern else s


class Nmt(Normalizer):
    """NMT char filtering and whitespace mapping (reference
    `normalizers/unicode.rs:44-77`): the `FILTERED` control chars are
    removed, the `TO_SPACE` ones become a space."""

    FILTERED = frozenset(
        list(range(0x0001, 0x0009))
        + [0x000B]
        + list(range(0x000E, 0x0020))
        + [0x007F, 0x008F, 0x009F]
    )
    TO_SPACE = frozenset(
        [0x0009, 0x000A, 0x000C, 0x000D, 0x1680]
        + list(range(0x200B, 0x2010))
        + [0x2028, 0x2029, 0x2581, 0xFEFF, 0xFFFD]
    )
    _TABLE = {**dict.fromkeys(FILTERED), **dict.fromkeys(TO_SPACE, " ")}
    _ANY = re.compile("[%s]" % "".join(map(re.escape, map(chr, sorted(FILTERED | TO_SPACE)))))

    def normalize(self, ns) -> None:
        if not self._ANY.search(ns.get()):  # else the identity
            return
        if any(ord(c) in self.FILTERED for c in ns.get()):
            ns.filter(lambda c: ord(c) not in self.FILTERED)
        ns.map(lambda c: " " if ord(c) in self.TO_SPACE else c)

    def normalize_str(self, s: str) -> str:
        return s.translate(self._TABLE) if self._ANY.search(s) else s


_SIMPLE = {"Lowercase": Lowercase, "NFD": NFD, "NFKD": NFKD, "NFC": NFC, "NFKC": NFKC,
           "StripAccents": StripAccents, "Nmt": Nmt}
_BERT_KEYS = {"type", "clean_text", "handle_chinese_chars", "strip_accents", "lowercase"}


def from_json(d: dict):
    """The normalizer of a tokenizer.json node: Lowercase, NFD, NFKD, NFC,
    NFKC, StripAccents, Nmt, Strip, Replace (a String pattern, or the
    Regex `" {2,}"`), Prepend, BertNormalizer or a Sequence of them."""
    from .bert import BertNormalizer

    t = d.get("type")

    def refuse(what):
        raise NotImplementedError(f"{what} is not ported yet: it waits for a later slice")

    if t in _SIMPLE:
        if set(d) != {"type"}:
            refuse(f"normalizer {t} with options {sorted(set(d) - {'type'})}")
        return _SIMPLE[t]()
    if t == "Sequence" and set(d) == {"type", "normalizers"}:
        return Sequence([from_json(n) for n in d["normalizers"]])
    if t == "Strip" and set(d) <= {"type", "strip_left", "strip_right"}:
        return Strip(d.get("strip_left", True), d.get("strip_right", True))
    if t == "Prepend" and set(d) == {"type", "prepend"}:
        return Prepend(d["prepend"])
    if t == "Replace" and set(d) == {"type", "pattern", "content"}:
        pat = d["pattern"]
        if set(pat) == {"Regex"} and pat["Regex"] in Replace.REGEX_PATTERNS:
            return Replace(pat["Regex"], d["content"], regex=True)
        if set(pat) != {"String"}:
            refuse(f"a Replace normalizer with the pattern {pat}")
        return Replace(pat["String"], d["content"])
    if t == "BertNormalizer" and set(d) <= _BERT_KEYS:
        return BertNormalizer(d.get("clean_text", True), d.get("handle_chinese_chars", True),
                              d.get("strip_accents"), d.get("lowercase", True))
    refuse(f"normalizer {t!r}")
