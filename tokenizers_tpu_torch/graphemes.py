"""Extended grapheme clusters (UAX #29, rules GB3-GB13 with GB9c and
GB11), the segmentation `Precompiled` looks its charsmap up by.

The JAX package splits with the `regex` module's `\\X`, which the port may
not import.  The rules run here over a committed table,
`data/graphemes.npz` (written by `python -m tokenizers_tpu_torch.data.regen
--graphemes` from `regex`'s own properties): for every code point its
Grapheme_Cluster_Break value (low 4 bits), Extended_Pictographic (bit 4)
and Indic_Conjunct_Break (bits 5-6).  `tests/test_torch_precompiled.py`
holds the segmentation equal to `\\X` but where the reference wheel's
segmentation (Rust's `unicode-segmentation`) differs from it: the port
follows the wheel there (`WHEEL_OTHER`).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

GRAPHEMES_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                              "graphemes.npz")

# Grapheme_Cluster_Break values, in the table's numbering
GCB = ("Other", "CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator", "Prepend",
       "SpacingMark", "L", "V", "T", "LV", "LVT")
(OTHER, CR, LF, CONTROL, EXTEND, ZWJ, RI, PREPEND, SPACING_MARK, L, V, T, LV,
 LVT) = range(len(GCB))
EXT_PICT = 16
# Indic_Conjunct_Break values (bits 5-6), None first
INCB = (None, "Consonant", "Linker", "Extend")
INCB_CONSONANT, INCB_LINKER, INCB_EXTEND = 1, 2, 3

# Marks of Unicode 17 (Extend or SpacingMark in `regex`'s tables) that the
# wheel's segmentation, of an earlier Unicode version, does not know: it
# breaks before them, as before any Other.  Found by probing the wheel's
# `Precompiled` ("a" + mark as a key), which
# `tests/test_torch_precompiled.py` repeats over every joining code point.
WHEEL_OTHER = (*range(0x1ACF, 0x1ADE), *range(0x1AE0, 0x1AEC), 0x10EFA, 0x10EFB,
               *range(0x11B60, 0x11B68), 0x1E6E3, 0x1E6E6, 0x1E6EE, 0x1E6EF, 0x1E6F5)

_BREAKS_AFTER = frozenset((CR, LF, CONTROL))
_table: Optional[bytes] = None


def table() -> bytes:
    """The property byte of every code point (see the module docstring)."""
    global _table
    if _table is None:
        with np.load(GRAPHEMES_PATH) as z:
            t = z["props"].copy()
        t[list(WHEEL_OTHER)] = OTHER
        _table = t.tobytes()
    return _table


def graphemes(text: str) -> List[str]:
    """The extended grapheme clusters of `text`, in order."""
    if not text:
        return []
    if text.isascii():  # only CR LF joins
        if "\r\n" not in text:
            return list(text)
        out: List[str] = []
        for piece in text.split("\r\n"):
            out.extend(piece)
            out.append("\r\n")
        out.pop()
        return out
    t = table()
    out = []
    start = 0
    p = t[ord(text[0])]
    prev = p & 15
    conj = 1 if p >> 5 == INCB_CONSONANT else 0   # GB9c: 1 after a consonant, 2 after a linker too
    emoji = 1 if p & EXT_PICT else 0              # GB11: 1 after ExtPict Extend*, 2 after its ZWJ
    ri = 1 if prev == RI else 0                   # GB12-13: regional indicators in a row
    for i in range(1, len(text)):
        p = t[ord(text[i])]
        cur = p & 15
        incb = p >> 5
        if prev == CR and cur == LF:
            join = True
        elif prev in _BREAKS_AFTER or cur in _BREAKS_AFTER:
            join = False
        elif cur == EXTEND or cur == ZWJ or cur == SPACING_MARK or prev == PREPEND:
            join = True
        elif prev == L:
            join = cur in (L, V, LV, LVT)
        elif prev == LV or prev == V:
            join = cur == V or cur == T
        elif prev == LVT or prev == T:
            join = cur == T
        elif incb == INCB_CONSONANT and conj == 2:
            join = True
        elif prev == ZWJ and p & EXT_PICT and emoji == 2:
            join = True
        else:
            join = prev == RI and cur == RI and ri % 2 == 1
        if not join:
            out.append(text[start:i])
            start = i
        if incb == INCB_CONSONANT:
            conj = 1
        elif incb == INCB_LINKER and conj:
            conj = 2
        elif incb != INCB_EXTEND:
            conj = 0
        if p & EXT_PICT:
            emoji = 1
        elif emoji == 1 and cur == EXTEND:
            pass
        elif emoji == 1 and cur == ZWJ:
            emoji = 2
        else:
            emoji = 0
        ri = ri + 1 if cur == RI else 0
        prev = cur
    out.append(text[start:])
    return out
