"""Unicode property tables of the host path: the code-point ranges of every
General_Category value and group, of `Alphabetic` and `White_Space`, and
of the scripts `UnicodeScripts` tells apart.

The ranges are not derived here at run time (that needs the `regex`
module, whose Unicode version is the one the JAX package and its tests
use; Python's `unicodedata` has another): they are the committed data
file `data/uprops.npz`, written by `python -m tokenizers_tpu_torch.data.regen
--uprops` and held equal to `regex`'s classes over every code point by
`tests/test_torch_pattern.py`.  Each table is an int32 [n, 2] array of
half-open ranges [lo, hi), sorted and disjoint.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

MAX_CP = 0x110000
UPROPS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "uprops.npz")

GENERAL_CATEGORIES = ("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No",
                      "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So",
                      "Zs", "Zl", "Zp", "Cc", "Cf", "Cs", "Co", "Cn")
GC_GROUPS = ("L", "LC", "M", "N", "P", "S", "Z", "C")
BINARY = ("Alphabetic", "White_Space")
# the scripts of `tokenizers_tpu.pre_tokenizers.unicode_scripts`, in its
# order; a code point of none of them is "Any" there
SCRIPTS = (
    "Latin", "Common", "Han", "Cyrillic", "Arabic", "Devanagari", "Hiragana",
    "Katakana", "Hangul", "Thai", "Greek", "Hebrew", "Inherited", "Bengali",
    "Tamil", "Telugu", "Kannada", "Malayalam", "Gujarati", "Gurmukhi", "Oriya",
    "Sinhala", "Myanmar", "Khmer", "Lao", "Tibetan", "Georgian", "Armenian",
    "Ethiopic", "Mongolian", "Thaana", "Syriac", "Cherokee", "Canadian_Aboriginal",
    "Ogham", "Runic", "Tagalog", "Hanunoo", "Buhid", "Tagbanwa", "Limbu",
    "Tai_Le", "Braille", "Bopomofo", "Yi", "Adlam", "Ahom", "Anatolian_Hieroglyphs",
    "Avestan", "Balinese", "Bamum", "Bassa_Vah", "Batak", "Bhaiksuki", "Brahmi",
    "Buginese", "Carian", "Caucasian_Albanian", "Chakma", "Cham", "Coptic",
    "Cuneiform", "Cypriot", "Deseret", "Dogra", "Duployan", "Egyptian_Hieroglyphs",
    "Elbasan", "Elymaic", "Glagolitic", "Gothic", "Grantha", "Gunjala_Gondi",
    "Hanifi_Rohingya", "Hatran", "Imperial_Aramaic", "Inscriptional_Pahlavi",
    "Inscriptional_Parthian", "Javanese", "Kaithi", "Kayah_Li", "Kharoshthi",
    "Khojki", "Khudawadi", "Lepcha", "Linear_A", "Linear_B", "Lisu", "Lycian",
    "Lydian", "Mahajani", "Makasar", "Mandaic", "Manichaean", "Marchen",
    "Masaram_Gondi", "Medefaidrin", "Meetei_Mayek", "Mende_Kikakui", "Meroitic_Cursive",
    "Meroitic_Hieroglyphs", "Miao", "Modi", "Mro", "Multani", "Nabataean",
    "Nandinagari", "New_Tai_Lue", "Newa", "Nko", "Nushu", "Nyiakeng_Puachue_Hmong",
    "Ol_Chiki", "Old_Hungarian", "Old_Italic", "Old_North_Arabian", "Old_Permic",
    "Old_Persian", "Old_Sogdian", "Old_South_Arabian", "Old_Turkic", "Osage",
    "Osmanya", "Pahawh_Hmong", "Palmyrene", "Pau_Cin_Hau", "Phags_Pa", "Phoenician",
    "Psalter_Pahlavi", "Rejang", "Samaritan", "Saurashtra", "Sharada", "Shavian",
    "Siddham", "SignWriting", "Sogdian", "Sora_Sompeng", "Soyombo", "Sundanese",
    "Syloti_Nagri", "Tai_Tham", "Tai_Viet", "Takri", "Tangut", "Tifinagh",
    "Tirhuta", "Ugaritic", "Vai", "Wancho", "Warang_Citi", "Zanabazar_Square",
)


def table_names() -> List[str]:
    """Every key of the committed file: the General_Category values and
    groups, the binary properties, and "sc:<Script>" for each script."""
    return [*GENERAL_CATEGORIES, *GC_GROUPS, *BINARY, *("sc:" + s for s in SCRIPTS)]


def regex_class(name: str) -> str:
    """The `regex` module's class of table `name` (the generator's source)."""
    return "\\p{Script=%s}" % name[3:] if name.startswith("sc:") else "\\p{%s}" % name


_TABLES: Dict[str, np.ndarray] = {}


def ranges(name: str) -> np.ndarray:
    """int32 [n, 2] half-open ranges of table `name` (`table_names`)."""
    if not _TABLES:
        with np.load(UPROPS_PATH) as z:
            for k in z.files:
                _TABLES[k.replace("sc_", "sc:", 1) if k.startswith("sc_") else k] = z[k]
    return _TABLES[name]


def union(*tables) -> List[Tuple[int, int]]:
    """The sorted, merged union of range lists."""
    spans = sorted((int(a), int(b)) for t in tables for a, b in t)
    out: List[Tuple[int, int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def complement(spans) -> List[Tuple[int, int]]:
    """The ranges of [0, MAX_CP) outside the sorted, disjoint `spans`."""
    out, prev = [], 0
    for a, b in spans:
        if a > prev:
            out.append((prev, a))
        prev = b
    if prev < MAX_CP:
        out.append((prev, MAX_CP))
    return out


def lookup_array(names, default: int) -> np.ndarray:
    """uint8 [MAX_CP]: the index in `names` of the table holding each code
    point (the tables are disjoint), `default` where none does."""
    out = np.full(MAX_CP, default, np.uint8)
    for i, name in enumerate(names):
        for a, b in ranges(name):
            out[a:b] = i
    return out
