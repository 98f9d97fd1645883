"""NormalizedString: a string under normalization that keeps, for every
byte of the normalized text, the span of original bytes it came from;
copy of the part of `tokenizers_tpu.normalized` that the port's
normalizers and the Metaspace pre-tokenizer use (reference
`tokenizer/normalizer.rs`).

Changes go through `transform_range`, which takes a stream of
`(char, change)` pairs (`unicode_norm`): a char that replaces an input
char takes that char's alignment, an inserted one the alignment of the
byte before it (`replace` splices the same alignments by slices, and the
normalizers skip the transforms that leave the text as it is).  Offsets of tokens in the normalized text then map back
to the original text: a span's start from its first byte's alignment,
its end from its last byte's (`engine_base` and the host pipeline).
All ranges here are byte offsets.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional, Tuple

from . import unicode_norm as _un
from .normalizers.bert import is_whitespace


def utf8_len(c: str) -> int:
    cp = ord(c)
    return 1 if cp < 0x80 else 2 if cp < 0x800 else 3 if cp < 0x10000 else 4


def char_to_byte_offsets(s: str) -> List[int]:
    """Byte offset of each char of `s`, then its byte length."""
    out = [0]
    for c in s:
        out.append(out[-1] + utf8_len(c))
    return out


class NormalizedString:
    __slots__ = ("original", "normalized", "alignments")

    def __init__(self, s: str = ""):
        self.original = s
        self.normalized = s
        if s.isascii():
            self.alignments: List[Tuple[int, int]] = list(zip(range(len(s)),
                                                                range(1, len(s) + 1)))
            return
        self.alignments = []
        b = 0
        for c in s:
            n = utf8_len(c)
            self.alignments.extend([(b, b + n)] * n)
            b += n

    def get(self) -> str:
        return self.normalized

    def __len__(self) -> int:
        """Byte length of the normalized text."""
        return len(self.alignments)

    def is_empty(self) -> bool:
        return not self.alignments

    # ------------------------------------------------------------- transforms

    def transform_range(self, start: int, end: Optional[int], dest: Iterable[Tuple[str, int]],
                        initial_offset: int = 0) -> None:
        """Replace the normalized bytes [start, end) by the chars of `dest`
        (reference `normalizer.rs:318-429`).  `initial_offset` chars of
        the range are removed before the first."""
        if end is None:
            end = len(self.alignments)
        nb = self.normalized.encode("utf-8")
        replaced = iter(nb[start:end].decode("utf-8"))
        initial_removed = 0
        for _ in range(initial_offset):
            c = next(replaced, None)
            if c is None:
                break
            initial_removed += utf8_len(c)

        offset = initial_removed + start
        new_alignments: List[Tuple[int, int]] = []
        out_chars: List[str] = []
        for c, changes in dest:
            idx = offset
            if changes > 0:
                align = self.alignments[idx - 1] if idx >= 1 else (0, 0)
            else:
                align = self.alignments[idx]
            replaced_size = 0
            if changes <= 0:
                rc = next(replaced, None)
                if rc is not None:
                    replaced_size = utf8_len(rc)
            removed_bytes = 0
            for _ in range(-changes if changes < 0 else 0):
                rc = next(replaced, None)
                if rc is None:
                    break
                removed_bytes += utf8_len(rc)
            offset += replaced_size + removed_bytes
            new_alignments.extend([align] * utf8_len(c))
            out_chars.append(c)

        self.alignments[start:end] = new_alignments
        self.normalized = (nb[:start] + "".join(out_chars).encode("utf-8")
                           + nb[end:]).decode("utf-8")

    def transform(self, dest: Iterable[Tuple[str, int]], initial_offset: int = 0) -> None:
        self.transform_range(0, None, dest, initial_offset)

    # ------------------------------------------------------------ normalizers

    def nfd(self) -> "NormalizedString":
        self.transform(_un.nfd_transform(self.normalized))
        return self

    def nfkd(self) -> "NormalizedString":
        self.transform(_un.nfd_transform(self.normalized, compat=True))
        return self

    def nfc(self) -> "NormalizedString":
        self.transform(*_un.nfc_transform(self.normalized))
        return self

    def nfkc(self) -> "NormalizedString":
        self.transform(*_un.nfc_transform(self.normalized, compat=True))
        return self

    def filter(self, keep: Callable[[str], bool]) -> "NormalizedString":
        """Drop the chars that `keep` refuses; each kept char carries the
        removal of the dropped ones after it."""
        removed = removed_start = 0
        transforms: List[Tuple[str, int]] = []
        last_c: Optional[str] = None
        for c in self.normalized:
            if keep(c):
                if last_c is not None:
                    transforms.append((last_c, -removed))
                else:
                    removed_start = removed
                last_c = c
                removed = 0
            else:
                removed += 1
        if last_c is not None:
            transforms.append((last_c, -removed))
        self.transform(transforms, removed_start)
        return self

    def lowercase(self) -> "NormalizedString":
        self.transform([(lc, 1 if i else 0) for c in self.normalized
                        for i, lc in enumerate(c.lower())])
        return self

    def map(self, f: Callable[[str], str]) -> "NormalizedString":
        """Each char replaced by the one char `f` gives; it takes the
        alignment of the char it replaces (reference `normalizer.rs:522`)."""
        al, out, out_al, p = self.alignments, [], [], 0
        for c in self.normalized:
            m = f(c)
            out.append(m)
            out_al.extend([al[p]] * utf8_len(m))
            p += utf8_len(c)
        self.normalized, self.alignments = "".join(out), out_al
        return self

    def replace(self, pattern, content: str) -> "NormalizedString":
        """Replace every match of `pattern` by `content` (reference
        `normalizer.rs:571`): the content's chars are insertions that take
        the alignment of the match's last byte.  `pattern` is a literal
        string or a compiled bytes regex; either is matched on the UTF-8
        bytes (a valid literal only matches whole chars; the port's one
        regex, `" {2,}"`, only spaces), with the alignments spliced by
        slices."""
        nb = self.normalized.encode("utf-8")
        if isinstance(pattern, re.Pattern):
            spans = [m.span() for m in pattern.finditer(nb)]
        elif pattern:
            pb, spans = pattern.encode("utf-8"), []
            start = nb.find(pb)
            while start >= 0:
                spans.append((start, start + len(pb)))
                start = nb.find(pb, start + len(pb))
        else:
            return self
        if not spans:
            return self
        cb = content.encode("utf-8")
        al, out, parts, pos = self.alignments, [], [], 0
        for start, end in spans:
            out.extend(al[pos:start])
            out.extend([al[end - 1]] * len(cb))
            parts += [nb[pos:start], cb]
            pos = end
        out.extend(al[pos:])
        parts.append(nb[pos:])
        self.alignments = out
        self.normalized = b"".join(parts).decode("utf-8")
        return self

    def prepend(self, s: str) -> "NormalizedString":
        """`s` before the text; its chars take the first char's alignment."""
        if not self.normalized:
            return self
        first = self.normalized[0]
        dest = [(c, 0 if i == 0 else 1) for i, c in enumerate(s)] + [(first, 1)]
        self.transform_range(0, utf8_len(first), dest)
        return self

    def strip(self, left: bool = True, right: bool = True) -> "NormalizedString":
        """Remove the whitespace at either end."""
        chars = self.normalized
        n = len(chars)
        lcount = 0
        while left and lcount < n and is_whitespace(chars[lcount]):
            lcount += 1
        rcount = 0
        while right and rcount < n - lcount and is_whitespace(chars[n - 1 - rcount]):
            rcount += 1
        if rcount:
            self.transform_range(sum(utf8_len(c) for c in chars[: n - rcount]), None, [],
                                 rcount)
        if lcount:
            self.transform_range(0, sum(utf8_len(c) for c in chars[:lcount]), [], lcount)
        return self
