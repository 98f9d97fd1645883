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

The rest of the JAX package's NormalizedString (reference
`normalizer.rs:105-700`) serves the general host pipeline
(`pretokenized.py`): `original_shift` (where a slice's original starts
in the whole text), `convert_offsets` between the original and the
normalized referential, `get_range(_original)`, `slice` at char
boundaries, `split` by a pattern (`pattern.py`) with the five delimiter
behaviours, `lstrip`/`rstrip`, `append`, `uppercase`, `clear` and
`for_each`.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional, Tuple

from .utils import unicode_norm as _un

# split delimiter behaviours (reference `normalizer.rs:82`)
REMOVED = "removed"
ISOLATED = "isolated"
MERGED_WITH_PREVIOUS = "merged_with_previous"
MERGED_WITH_NEXT = "merged_with_next"
CONTIGUOUS = "contiguous"
BEHAVIORS = (REMOVED, ISOLATED, MERGED_WITH_PREVIOUS, MERGED_WITH_NEXT, CONTIGUOUS)


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
    __slots__ = ("original", "normalized", "alignments", "original_shift")

    def __init__(self, s: str = ""):
        self.original = s
        self.normalized = s
        self.original_shift = 0
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

    @classmethod
    def _raw(cls, original: str, normalized: str, alignments, original_shift: int):
        out = cls.__new__(cls)
        out.original, out.normalized = original, normalized
        out.alignments, out.original_shift = alignments, original_shift
        return out

    def get(self) -> str:
        return self.normalized

    def get_original(self) -> str:
        return self.original

    def __len__(self) -> int:
        """Byte length of the normalized text."""
        return len(self.alignments)

    def len_original(self) -> int:
        return len(self.original.encode("utf-8"))

    def is_empty(self) -> bool:
        return not self.alignments

    def offsets_original(self) -> Tuple[int, int]:
        """This string's original bytes in the whole text."""
        return (self.original_shift, self.original_shift + self.len_original())

    def __eq__(self, other):
        if not isinstance(other, NormalizedString):
            return NotImplemented
        return (self.original, self.normalized, self.alignments, self.original_shift) == (
            other.original, other.normalized, other.alignments, other.original_shift)

    def __repr__(self):
        return f"NormalizedString(original={self.original!r}, normalized={self.normalized!r})"

    # ------------------------------------------------------------ conversions

    def convert_offsets(self, start: int, end: Optional[int],
                        referential: str = "original") -> Optional[Tuple[int, int]]:
        """The byte range [start, end) of one referential ("original" or
        "normalized") in the other (reference `normalizer.rs:156-215`);
        None where it has no counterpart."""
        len_original, len_normalized = self.len_original(), len(self.alignments)
        original = referential == "original"
        if end is None:
            end = len_original if original else len_normalized
        if start == end:
            return (start, end)
        if start > end:
            return None
        if not original:
            sub = self.alignments[start:end]
            return (sub[0][0], sub[-1][1]) if sub else None
        s = e = None
        for i, (a0, a1) in enumerate(self.alignments):
            if end < a1:
                break
            if s is None and start <= a0 and a0 != a1:
                s = i
            if end >= a1:
                e = i + 1
        if s is not None and e is None:
            return (s, s)
        if s is None and e is not None:
            return (e, e)
        if s is not None:
            return (s, e)
        return None

    def get_range(self, start: int = 0, end: Optional[int] = None,
                  referential: str = "normalized") -> Optional[str]:
        """The normalized text of a byte range (of either referential)."""
        nb = self.normalized.encode("utf-8")
        if referential == "original":
            conv = self.convert_offsets(start, end, "original")
            if conv is None:
                return None
            start, end = conv
        return _decode_range(nb, start, len(nb) if end is None else end)

    def get_range_original(self, start: int = 0, end: Optional[int] = None,
                           referential: str = "normalized") -> Optional[str]:
        """The original text of a byte range (of either referential)."""
        ob = self.original.encode("utf-8")
        if referential == "normalized":
            conv = self.convert_offsets(start, end, "normalized")
            if conv is None:
                return None
            start, end = conv
        return _decode_range(ob, start, len(ob) if end is None else end)

    # ------------------------------------------------------------- transforms

    def transform_range(self, start: int, end: Optional[int], dest: Iterable[Tuple[str, int]],
                        initial_offset: int = 0, referential: str = "normalized") -> None:
        """Replace the normalized bytes [start, end) by the chars of `dest`
        (reference `normalizer.rs:318-429`).  `initial_offset` chars of
        the range are removed before the first.  With `referential`
        "original" the range is in original bytes, converted first (an
        unconvertible range changes nothing)."""
        if referential == "original":
            conv = self.convert_offsets(
                start, end if end is not None else self.len_original(), "original")
            if conv is None:
                return
            start, end = conv
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

    def uppercase(self) -> "NormalizedString":
        self.transform([(uc, 1 if i else 0) for c in self.normalized
                        for i, uc in enumerate(c.upper())])
        return self

    def for_each(self, fn: Callable[[str], None]) -> "NormalizedString":
        for c in self.normalized:
            fn(c)
        return self

    def clear(self) -> "NormalizedString":
        self.transform([], len(self.normalized))
        return self

    def append(self, s: str) -> "NormalizedString":
        """`s` after the text; its chars take the last char's alignment."""
        if self.normalized:
            last = self.normalized[-1]
            self.transform_range(len(self.alignments) - utf8_len(last), None,
                                 [(last, 0)] + [(c, 1) for c in s])
        else:
            self.transform_range(0, None, [(c, 1) for c in s])
        return self

    def map(self, fn: Callable[[str], str]) -> "NormalizedString":
        """Each char replaced by the one char `fn` gives; it takes the
        alignment of the char it replaces (reference `normalizer.rs:522`)."""
        al, out, out_al, p = self.alignments, [], [], 0
        for c in self.normalized:
            m = fn(c)
            out.append(m)
            out_al.extend([al[p]] * utf8_len(m))
            p += utf8_len(c)
        self.normalized, self.alignments = "".join(out), out_al
        return self

    def replace(self, pattern, content: str) -> "NormalizedString":
        """Replace every match of `pattern` by `content` (reference
        `normalizer.rs:571`): the content's chars are insertions that take
        the alignment of the match's last byte (of the byte before an empty
        match; (0, 0) at the start).  `pattern` is a literal string or a
        compiled bytes regex, matched on the UTF-8 bytes (a valid literal
        only matches whole chars), or any pattern of `pattern.py`, matched
        on the chars; the alignments are spliced by slices."""
        nb = self.normalized.encode("utf-8")
        if isinstance(pattern, re.Pattern) and isinstance(pattern.pattern, bytes):
            spans = [m.span() for m in pattern.finditer(nb)]
        elif isinstance(pattern, str):
            if not pattern:
                return self
            pb, spans = pattern.encode("utf-8"), []
            start = nb.find(pb)
            while start >= 0:
                spans.append((start, start + len(pb)))
                start = nb.find(pb, start + len(pb))
        else:
            from .pattern import match_spans

            spans = match_spans(pattern, self.normalized)
            if spans and not self.normalized.isascii():
                cb_ = char_to_byte_offsets(self.normalized)
                spans = [(cb_[a], cb_[b]) for a, b in spans]
        if not spans:
            return self
        cb = content.encode("utf-8")
        al, out, parts, pos = self.alignments, [], [], 0
        for start, end in spans:
            out.extend(al[pos:start])
            out.extend([al[end - 1] if end else (0, 0)] * len(cb))
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
        from .normalizers.bert import is_whitespace

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

    def lstrip(self) -> "NormalizedString":
        return self.strip(True, False)

    def rstrip(self) -> "NormalizedString":
        return self.strip(False, True)

    # ------------------------------------------------------------ slice, split

    def slice(self, start: int, end: Optional[int],
              referential: str = "normalized") -> Optional["NormalizedString"]:
        """The part of this string on the byte range [start, end) of either
        referential, cut at char boundaries, as a NormalizedString of its
        own (its original the part's original text, `original_shift` where
        that starts in the whole text); None off a char boundary
        (reference `normalizer.rs:272`)."""
        return self._slice(self.normalized.encode("utf-8"), self.original.encode("utf-8"),
                           start, end, referential)

    def _slice(self, nb: bytes, ob: bytes, start: int, end: Optional[int],
               referential: str) -> Optional["NormalizedString"]:
        """`slice` with the normalized and original UTF-8 bytes given."""
        if referential == "normalized":
            end = len(nb) if end is None else end
            if not (_is_char_boundary(nb, start) and _is_char_boundary(nb, end)):
                return None
            n_range, o_range = (start, end), self.convert_offsets(start, end, "normalized")
        else:
            end = len(ob) if end is None else end
            if not (_is_char_boundary(ob, start) and _is_char_boundary(ob, end)):
                return None
            o_range, n_range = (start, end), self.convert_offsets(start, end, "original")
        if o_range is None or n_range is None:
            return None
        shift = o_range[0]
        return NormalizedString._raw(
            ob[o_range[0]:o_range[1]].decode("utf-8", errors="replace"),
            nb[n_range[0]:n_range[1]].decode("utf-8", errors="replace"),
            [(max(a0 - shift, 0), max(a1 - shift, 0))
             for a0, a1 in self.alignments[n_range[0]:n_range[1]]],
            self.original_shift + shift)

    def split(self, pattern, behavior: str) -> List["NormalizedString"]:
        """The parts of this string around the matches of `pattern`
        (`pattern.find_matches`), each match treated as `behavior` says:
        removed, isolated, merged with the previous or the next part, or
        contiguous matches merged (reference `normalizer.rs:695`)."""
        from .pattern import find_matches

        matches = find_matches(pattern, self.normalized)
        if behavior == ISOLATED:
            parts = [rng for rng, _m in matches]
        elif behavior == REMOVED:
            parts = [rng for rng, m in matches if not m]
        elif behavior == MERGED_WITH_PREVIOUS:
            parts, prev_match = [], False
            for rng, m in matches:
                if m and parts and not prev_match:
                    parts[-1] = (parts[-1][0], rng[1])
                else:
                    parts.append(rng)
                prev_match = m
        elif behavior == MERGED_WITH_NEXT:
            parts, prev_match = [], False
            for rng, m in reversed(matches):
                if m and parts and not prev_match:
                    parts[-1] = (rng[0], parts[-1][1])
                else:
                    parts.append(rng)
                prev_match = m
            parts.reverse()
        elif behavior == CONTIGUOUS:
            parts, prev_match = [], None
            for rng, m in matches:
                if parts and m == prev_match:
                    parts[-1] = (parts[-1][0], rng[1])
                else:
                    parts.append(rng)
                prev_match = m
        else:
            raise ValueError(f"Unknown split behavior: {behavior}")
        cb = None if self.normalized.isascii() else char_to_byte_offsets(self.normalized)
        nb, ob = self.normalized.encode("utf-8"), self.original.encode("utf-8")
        out: List[NormalizedString] = []
        for cs, ce in parts:
            if cs == ce:
                continue
            sliced = self._slice(nb, ob, cs if cb is None else cb[cs],
                                 ce if cb is None else cb[ce], "normalized")
            if sliced is not None:
                out.append(sliced)
        return out


def _is_char_boundary(b: bytes, pos: int) -> bool:
    if pos == 0 or pos == len(b):
        return True
    if pos > len(b):
        return False
    return (b[pos] & 0xC0) != 0x80


def _decode_range(b: bytes, start: int, end: int) -> Optional[str]:
    if start > len(b) or end > len(b):
        return None
    try:
        return b[start:end].decode("utf-8")
    except UnicodeDecodeError:
        return None
