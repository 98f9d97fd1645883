"""Unicode normalization with provenance; copy of
`tokenizers_tpu.utils.unicode_norm`.

`unicodedata.normalize` does not say which input char each output char
came from, but offsets must map back through the normalizer.  So NFD,
NFKD, NFC and NFKC are computed here from the Unicode data (decomposition,
canonical ordering, composition) and emitted as `(char, change)` streams
for `NormalizedString.transform`:

  - change == 0 : the char replaces the next not yet consumed input char
  - change == 1 : the char is inserted (it takes the previous char's
                  alignment)
  - change == -N: the char replaces the next input char and consumes N more

Python's `unicodedata` decides the data on both sides, so the host pipeline
and the reference agree where their Unicode versions do.
"""

from __future__ import annotations

import unicodedata
from functools import lru_cache
from typing import List, Optional, Tuple

# Hangul syllables (UAX#15), composed and decomposed arithmetically
_SBASE = 0xAC00
_LBASE = 0x1100
_VBASE = 0x1161
_TBASE = 0x11A7
_LCOUNT = 19
_VCOUNT = 21
_TCOUNT = 28
_NCOUNT = _VCOUNT * _TCOUNT
_SCOUNT = _LCOUNT * _NCOUNT


def _hangul_decompose(cp: int) -> Optional[List[int]]:
    s_index = cp - _SBASE
    if s_index < 0 or s_index >= _SCOUNT:
        return None
    lead = _LBASE + s_index // _NCOUNT
    vowel = _VBASE + (s_index % _NCOUNT) // _TCOUNT
    trail = _TBASE + s_index % _TCOUNT
    return [lead, vowel] if trail == _TBASE else [lead, vowel, trail]


def _hangul_compose(a: int, b: int) -> Optional[int]:
    if _LBASE <= a < _LBASE + _LCOUNT and _VBASE <= b < _VBASE + _VCOUNT:  # L + V
        return _SBASE + ((a - _LBASE) * _VCOUNT + (b - _VBASE)) * _TCOUNT
    s_index = a - _SBASE  # LV + T
    if 0 <= s_index < _SCOUNT and s_index % _TCOUNT == 0 and _TBASE < b < _TBASE + _TCOUNT:
        return a + (b - _TBASE)
    return None


@lru_cache(maxsize=None)
def canonical_decomposition(cp: int) -> Tuple[int, ...]:
    """Full recursive canonical decomposition of a codepoint (no reordering)."""
    h = _hangul_decompose(cp)
    if h is not None:
        return tuple(h)
    d = unicodedata.decomposition(chr(cp))
    if not d or d.startswith("<"):
        return (cp,)
    out: List[int] = []
    for part in d.split():
        out.extend(canonical_decomposition(int(part, 16)))
    return tuple(out)


@lru_cache(maxsize=None)
def compatibility_decomposition(cp: int) -> Tuple[int, ...]:
    """Full recursive compatibility decomposition of a codepoint (no reordering)."""
    h = _hangul_decompose(cp)
    if h is not None:
        return tuple(h)
    d = unicodedata.decomposition(chr(cp))
    if not d:
        return (cp,)
    parts = d.split()
    if parts[0].startswith("<"):
        parts = parts[1:]
    out: List[int] = []
    for part in parts:
        out.extend(compatibility_decomposition(int(part, 16)))
    return tuple(out)


def _canonical_order(chars: List[int], groups: List[int]) -> None:
    """Stable canonical ordering of combining marks in place (UAX#15
    D108); `groups[k]` moves with `chars[k]`."""
    n = len(chars)
    if n < 2:
        return
    ccc = [unicodedata.combining(chr(c)) for c in chars]
    for i in range(1, n):
        if ccc[i] != 0 and ccc[i - 1] > ccc[i]:
            j = i
            while j > 0 and ccc[j - 1] > ccc[j] and ccc[j] != 0:
                ccc[j - 1], ccc[j] = ccc[j], ccc[j - 1]
                chars[j - 1], chars[j] = chars[j], chars[j - 1]
                groups[j - 1], groups[j] = groups[j], groups[j - 1]
                j -= 1


def _decompose_with_groups(s: str, compat: bool) -> Tuple[List[int], List[int]]:
    """Decomposed and canonically ordered codepoints, and the index of the
    input char each came from."""
    decomp = compatibility_decomposition if compat else canonical_decomposition
    chars: List[int] = []
    groups: List[int] = []
    for i, c in enumerate(s):
        for cp in decomp(ord(c)):
            chars.append(cp)
            groups.append(i)
    _canonical_order(chars, groups)
    return chars, groups


_COMPOSITION_TABLE: Optional[dict] = None


def composition_table() -> dict:
    """Primary canonical composites, (starter, mark) -> composite, from
    every codepoint's two-part canonical decomposition less the
    composition exclusions (those whose decomposition does not recompose
    under NFC)."""
    global _COMPOSITION_TABLE
    if _COMPOSITION_TABLE is None:
        table = {}
        for cp in range(0x110000):
            if _SBASE <= cp < _SBASE + _SCOUNT:
                continue  # Hangul: arithmetic
            c = chr(cp)
            d = unicodedata.decomposition(c)
            if not d or d.startswith("<"):
                continue
            parts = d.split()
            if len(parts) != 2:
                continue
            a, b = int(parts[0], 16), int(parts[1], 16)
            if unicodedata.normalize("NFC", chr(a) + chr(b)) == c:
                table[(a, b)] = cp
        _COMPOSITION_TABLE = table
    return _COMPOSITION_TABLE


def _compose(chars: List[int]) -> Tuple[List[int], List[int]]:
    """Canonical composition of a canonically ordered sequence: (output
    codepoints, index in `chars` of each output char's source; a
    composite keeps its starter's)."""
    table = composition_table()
    n = len(chars)
    out: List[int] = []
    src: List[int] = []
    i = 0
    while i < n:
        cp = chars[i]
        out.append(cp)
        src.append(i)
        starter = len(out) - 1
        if unicodedata.combining(chr(cp)) != 0:
            i += 1
            continue
        last_ccc = 0
        j = i + 1
        while j < n:
            cj = chars[j]
            ccc = unicodedata.combining(chr(cj))
            composed = _hangul_compose(out[starter], cj)
            if composed is None:
                composed = table.get((out[starter], cj))
            if composed is not None and (last_ccc == 0 or last_ccc < ccc):
                out[starter] = composed
                j += 1
                if ccc == 0:
                    last_ccc = 0  # a following starter composed (Hangul LV + T)
                continue
            if ccc == 0:
                break  # the next starter blocks everything
            out.append(cj)
            src.append(j)
            last_ccc = ccc
            j += 1
        i = j
    return out, src


def nfd_transform(s: str, compat: bool = False) -> List[Tuple[str, int]]:
    """(char, change) stream of NFD (NFKD where `compat`) on `s`: per
    input char of a k-char decomposition, one change 0 then k - 1 change
    1, applied in order to the canonically ordered output."""
    decomp = compatibility_decomposition if compat else canonical_decomposition
    chars, _groups = _decompose_with_groups(s, compat)
    changes: List[int] = []
    for c in s:
        changes.append(0)
        changes.extend([1] * (len(decomp(ord(c))) - 1))
    return [(chr(cp), ch) for cp, ch in zip(chars, changes)]


def nfkd_transform(s: str) -> List[Tuple[str, int]]:
    return nfd_transform(s, compat=True)


def _source_map_to_transform(out_cps: List[int], src: List[Optional[int]],
                             n_inputs: int) -> Tuple[List[Tuple[str, int]], int]:
    """(char, change) stream and initial offset from output chars and the
    strictly increasing input index each replaces (None: inserted)."""
    dest: List[Tuple[str, int]] = []
    initial_offset = 0
    cursor = 0
    first_real = next((k for k, p in enumerate(src) if p is not None), None)
    if first_real is not None and src[first_real] > 0:
        initial_offset = cursor = src[first_real]
    attach = -1  # index in dest of the last non-insertion
    for cp, p in zip(out_cps, src):
        if p is None:
            dest.append((chr(cp), 1))
            continue
        gap = p - cursor  # inputs between: removals of the previous entry
        if gap > 0:
            if attach >= 0:
                c_prev, ch_prev = dest[attach]
                dest[attach] = (c_prev, ch_prev - gap)
            else:
                initial_offset += gap
            cursor = p
        dest.append((chr(cp), 0))
        attach = len(dest) - 1
        cursor += 1
    if cursor < n_inputs:
        gap = n_inputs - cursor
        if attach >= 0:
            c_prev, ch_prev = dest[attach]
            dest[attach] = (c_prev, ch_prev - gap)
        else:
            initial_offset += gap
    return dest, initial_offset


def nfc_transform(s: str, compat: bool = False) -> Tuple[List[Tuple[str, int]], int]:
    """(char, change) stream and initial offset of NFC (NFKC where
    `compat`) on `s`."""
    chars, groups = _decompose_with_groups(s, compat)
    out, src_in_decomp = _compose(chars)
    src: List[Optional[int]] = []
    last = -1
    for j in src_in_decomp:
        g = groups[j]
        if g <= last:
            src.append(None)  # a reordered mark fell behind: an insertion
        else:
            src.append(g)
            last = g
    return _source_map_to_transform(out, src, len(s))


def nfkc_transform(s: str) -> Tuple[List[Tuple[str, int]], int]:
    return nfc_transform(s, compat=True)
