"""UnicodeScripts pre-tokenizer: a split wherever the Unicode script
changes (SentencePiece's rule); port of
`tokenizers_tpu.pre_tokenizers.unicode_scripts` (reference
`pre_tokenizers/unicode_scripts/`).

A char's script comes from the committed script table (`uprops.py`,
`data/uprops.npz`: the `regex` module's Script property over the scripts
the JAX package lists, `uprops.SCRIPTS`), a char of none of them being
"Any".  As in the reference's `fixed_script`: U+30FC and Hiragana and
Katakana count as Han, and a space as Any.  A char of script Any never
starts a new piece and does not change the script the next char is
compared with.  The first char that is not Any starts a piece, so the
chars of script Any before it are dropped (as in the reference).
"""

from __future__ import annotations

from .. import uprops
from .base import PreTokenizer

ANY = 255
_HAN = uprops.SCRIPTS.index("Han")
_FOLD = {uprops.SCRIPTS.index("Hiragana"): _HAN, uprops.SCRIPTS.index("Katakana"): _HAN}
_RAW = None
_TABLE = None


def _raw_table():
    """uint8 [MAX_CP]: each code point's script, unfolded."""
    global _RAW
    if _RAW is None:
        _RAW = uprops.lookup_array(["sc:" + s for s in uprops.SCRIPTS], ANY)
    return _RAW


def _name(i: int) -> str:
    return "Any" if i == ANY else uprops.SCRIPTS[i]


def get_script(c: str) -> str:
    """The script of the char `c` by name, "Any" for none of
    `uprops.SCRIPTS`."""
    return _name(int(_raw_table()[ord(c)]))


def fixed_script(c: str) -> str:
    """The script the split compares (reference
    `unicode_scripts/pre_tokenizer.rs:25-38`)."""
    return _name(int(script_table()[ord(c)]))


def script_table():
    """uint8 [MAX_CP]: each code point's fixed script (an index of
    `uprops.SCRIPTS`, ANY for Any)."""
    global _TABLE
    if _TABLE is None:
        t = _raw_table().copy()
        for a, b in _FOLD.items():
            t[t == a] = b
        t[0x30FC] = _HAN
        t[0x20] = ANY
        _TABLE = t
    return _TABLE


class UnicodeScripts(PreTokenizer):
    def _split(self, pretokenized) -> None:
        table = script_table()

        def split_fn(_i, ns):
            text = ns.get()
            cuts, last, offset = [], -1, 0  # -1: no char seen yet
            for c in text:
                script = int(table[ord(c)])
                if script != ANY and last != ANY and last != script:
                    cuts.append(offset)
                offset += len(c.encode("utf-8"))
                if script != ANY:
                    last = script
            cuts.append(len(ns))
            nb, ob = text.encode("utf-8"), ns.original.encode("utf-8")
            return [ns._slice(nb, ob, a, b, "normalized") for a, b in zip(cuts, cuts[1:])]

        pretokenized.split(split_fn)
