"""Normalizers of the host path; copies of `tokenizers_tpu.normalizers`.
Each normalizes a `NormalizedString` in place (`normalize`), so offsets
map back through its alignments.  `normalize_str` gives the same text
without the alignments, by string operations where the normalizer has a
faster form (the ids paths prepare every input with it; the tests hold
the two equal), else through a NormalizedString.  The package exports
the JAX package's names: `BertNormalizer` and `is_chinese_char`
(`bert.py`), `Precompiled`, `NormalizedString` and `SysRegex`.  `Replace` matches a literal or a
regex of the reference's syntax (`pattern.py`); `CustomNormalizer` wraps
a user object (host only; `to_str` refuses it); `ByteLevel` maps every
byte to its byte-level char; `Precompiled` (`precompiled.py`) applies a
SentencePiece charsmap.  `from_json` reads every normalizer node the JAX
package reads (`tokenizers_tpu/serialization.py:109-150`).
"""

from __future__ import annotations

import base64
import re
import unicodedata
from typing import List


class Normalizer:
    def normalize(self, normalized) -> None:
        raise NotImplementedError

    def normalize_str(self, sequence: str) -> str:
        ns = NormalizedString(sequence)
        self.normalize(ns)
        return ns.get()

    @staticmethod
    def custom(obj) -> "CustomNormalizer":
        """Wrap a user object with a `normalize(NormalizedString)` method
        (reference `bindings/python/src/normalizers.rs:146`)."""
        return CustomNormalizer(obj)


class CustomNormalizer(Normalizer):
    def __init__(self, obj):
        if not callable(getattr(obj, "normalize", None)):
            raise TypeError("custom normalizer must have a normalize(NormalizedString) method")
        self.obj = obj

    def normalize(self, normalized) -> None:
        self.obj.normalize(normalized)


class Sequence(Normalizer):
    def __init__(self, normalizers: List[Normalizer]):
        self.normalizers = list(normalizers)

    def normalize(self, normalized) -> None:
        for n in self.normalizers:
            n.normalize(normalized)

    def normalize_str(self, sequence: str) -> str:
        for n in self.normalizers:
            sequence = n.normalize_str(sequence)
        return sequence


class Lowercase(Normalizer):
    def normalize(self, normalized) -> None:
        if normalized.get().isascii():  # one byte for one byte: the alignments stay
            normalized.normalized = normalized.get().lower()
        else:
            normalized.lowercase()

    def normalize_str(self, sequence: str) -> str:
        # char by char, as the reference (no final-sigma context)
        return sequence.lower() if sequence.isascii() else "".join(c.lower() for c in sequence)


class _Unicode(Normalizer):
    form = ""

    def normalize(self, normalized) -> None:
        if not unicodedata.is_normalized(self.form, normalized.get()):  # else the identity
            getattr(normalized, self.form.lower())()

    def normalize_str(self, sequence: str) -> str:
        return sequence if sequence.isascii() else unicodedata.normalize(self.form, sequence)


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

    def normalize(self, normalized) -> None:
        normalized.strip(self.left, self.right)

    def normalize_str(self, sequence: str) -> str:
        from .bert import WHITESPACE

        if self.left:
            sequence = sequence.lstrip(WHITESPACE)
        return sequence.rstrip(WHITESPACE) if self.right else sequence


_MARKS = None


class StripAccents(Normalizer):
    """Drops the combining marks (category M*), with no NFD of its own
    (reference `normalizers/strip.rs:48`)."""

    def normalize(self, normalized) -> None:
        if not normalized.get().isascii():  # ASCII has no marks
            normalized.filter(lambda c: not unicodedata.category(c).startswith("M"))

    def normalize_str(self, sequence: str) -> str:
        global _MARKS
        if sequence.isascii():
            return sequence
        if _MARKS is None:
            _MARKS = dict.fromkeys(cp for cp in range(0x110000)
                                   if unicodedata.category(chr(cp)).startswith("M"))
        return sequence.translate(_MARKS)


class Prepend(Normalizer):
    def __init__(self, prepend: str):
        self.prepend = prepend

    def normalize(self, normalized) -> None:
        if not normalized.is_empty():
            normalized.prepend(self.prepend)

    def normalize_str(self, sequence: str) -> str:
        return self.prepend + sequence if sequence else sequence


class Replace(Normalizer):
    """Every match of `pattern` replaced by `content` (reference
    `normalizers/replace.rs`); as for any replace, the content takes the
    alignment of the match's last byte.  `pattern`: a literal string (a
    regex of the reference's syntax with `regex=True`), a
    `pattern.Regex`, or ("Regex", text) as the JAX package takes it."""

    def __init__(self, pattern, content: str, regex: bool = False):
        if isinstance(pattern, tuple) and len(pattern) == 2 and pattern[0] == "Regex":
            pattern, regex = pattern[1], True
        elif isinstance(pattern, SysRegex):
            pattern, regex = pattern.pattern, True
        self.pattern, self.content, self.regex = pattern, content, regex
        self._re = SysRegex(pattern) if regex else None

    def normalize(self, normalized) -> None:
        normalized.replace(self._re if self.regex else self.pattern, self.content)

    def normalize_str(self, sequence: str) -> str:
        if self.regex:
            return self._re.compiled.sub(lambda _m: self.content, sequence)
        return sequence.replace(self.pattern, self.content) if self.pattern else sequence


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

    def normalize(self, normalized) -> None:
        if not self._ANY.search(normalized.get()):  # else the identity
            return
        if any(ord(c) in self.FILTERED for c in normalized.get()):
            normalized.filter(lambda c: ord(c) not in self.FILTERED)
        normalized.map(lambda c: " " if ord(c) in self.TO_SPACE else c)

    def normalize_str(self, sequence: str) -> str:
        return sequence.translate(self._TABLE) if self._ANY.search(sequence) else sequence


class ByteLevel(Normalizer):
    """Every byte as its byte-level char (reference
    `normalizers/byte_level.rs:9`): a char's first byte takes its place,
    the others are insertions."""

    def normalize(self, normalized) -> None:
        from ..pre_tokenizers.byte_level import to_byte_chars

        if not normalized.is_empty():
            to_byte_chars(normalized)

    def normalize_str(self, sequence: str) -> str:
        from ..pre_tokenizers.byte_level import BYTES_CHAR

        return "".join(BYTES_CHAR[b] for b in sequence.encode("utf-8"))

    @staticmethod
    def alphabet():
        from ..pre_tokenizers.byte_level import BYTES_CHAR

        return set(BYTES_CHAR.values())


_SIMPLE = {"Lowercase": Lowercase, "NFD": NFD, "NFKD": NFKD, "NFC": NFC, "NFKC": NFKC,
           "StripAccents": StripAccents, "Nmt": Nmt}


def from_json(d: dict):
    """The normalizer of a tokenizer.json node, as the JAX package's
    `normalizer_from_dict` reads it (keys it does not read are ignored);
    an unknown type raises SerdeError, a charsmap under 4 bytes ValueError."""
    from ..errors import SerdeError
    from .bert import BertNormalizer

    if d is None:
        return None
    t = d.get("type")
    if t in _SIMPLE:
        return _SIMPLE[t]()
    if t == "Sequence":
        return Sequence([from_json(n) for n in d["normalizers"]])
    if t == "Strip":
        return Strip(d.get("strip_left", True), d.get("strip_right", True))
    if t == "Prepend":
        return Prepend(d["prepend"])
    if t == "Replace":
        pat = d["pattern"]
        if "String" in pat:
            return Replace(pat["String"], d["content"])
        if "Regex" in pat:
            return Replace(pat["Regex"], d["content"], regex=True)
        raise SerdeError(f"Unknown pattern: {pat}")
    if t == "BertNormalizer":
        return BertNormalizer(d.get("clean_text", True), d.get("handle_chinese_chars", True),
                              d.get("strip_accents"), d.get("lowercase", True))
    if t == "ByteLevel":
        return ByteLevel()
    if t == "Precompiled":
        from .precompiled import Precompiled

        return Precompiled(base64.b64decode(d["precompiled_charsmap"]))
    raise SerdeError(f"Unknown normalizer type: {t}")


from ..normalized import NormalizedString  # noqa: E402
from ..pattern import SysRegex  # noqa: E402
from .bert import BertNormalizer, is_chinese_char  # noqa: E402
from .precompiled import Precompiled  # noqa: E402

__all__ = [
    "Normalizer",
    "Sequence",
    "Lowercase",
    "NFD",
    "NFKD",
    "NFC",
    "NFKC",
    "Nmt",
    "Strip",
    "StripAccents",
    "Prepend",
    "Replace",
    "BertNormalizer",
    "ByteLevel",
    "Precompiled",
    "is_chinese_char",
]
