"""Pattern: splitting a string by the matches of a literal, a char
predicate or a regex; port of `tokenizers_tpu.pattern` (reference
`tokenizer/pattern.rs:6-129`), with char offsets as there.

`find_matches(pattern, s)` gives contiguous `((start, end), is_match)`
slices covering all of `s`.  A pattern is a literal `str` (matched as
is), a callable on one char, a `SysRegex`, a compiled `re` pattern, or an
`Invert` of one of these.

`SysRegex` takes a pattern written for the reference's regex engine
(Oniguruma, Ruby syntax) and compiles it with Python's `re`, a C engine
as the `regex` module the JAX package uses is.  `translate` rewrites
what the two read differently:

* `\\w \\W \\s \\S \\d \\D \\h \\H`, `\\p{..}`, `\\P{..}`, `\\pL`: classes of
  code-point ranges from the committed property tables (`uprops.py`).
  Outside brackets `\\w` is the JAX package's Oniguruma class (Alphabetic,
  marks, decimal digits, connector punctuation and ²³¹¼½¾); inside
  brackets Oniguruma leaves those six out, and so does the port (the JAX
  package keeps them there: the port follows the reference).  `\\s` is
  White_Space, `\\d` Nd, `\\h` a hex digit; `\\b`, `\\B` are boundaries of
  that `\\w`.
* `^` and `$` are line anchors (Ruby syntax; `re.MULTILINE`), `(?m)` is
  Ruby's dot-all (`re.DOTALL`), `\\z` is `\\Z`, `\\Z` the end or a final
  newline, `\\x{HHHH}` a code point, `(?<n>..)` and `\\k<n>` named groups.
* Possessive quantifiers and atomic groups stay as they are (`re` has
  them since Python 3.11).

A construct the translator cannot express raises a `ValueError` naming
it when the pattern is built: class set operations (`&&`), nested or
POSIX brackets, `\\X`, `\\R`, `\\K`, `\\G`, `\\Q`, a subexpression call, an
interval followed by `+` (a repeat in Ruby syntax, possessive in `re`),
a flag group inside the pattern, an unknown property, and whatever `re`
refuses (a variable-length lookbehind).  Multi-char case folds (`(?i)ss`
against `ß`) are not matched, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple, Union

from . import uprops

Offsets = Tuple[int, int]


class Invert:
    """Flips `is_match` of the wrapped pattern (reference `pattern.rs:123`)."""

    def __init__(self, pattern):
        self.pattern = pattern


_SPACE = ((0x09, 0x0E), (0x20, 0x21), (0x85, 0x86), (0xA0, 0xA1), (0x1680, 0x1681),
          (0x2000, 0x200B), (0x2028, 0x202A), (0x202F, 0x2030), (0x205F, 0x2060),
          (0x3000, 0x3001))
_LATIN1_DIGITS = ((0xB2, 0xB4), (0xB9, 0xBA), (0xBC, 0xBF))  # ²³ ¹ ¼½¾
_HEX = ((0x30, 0x3A), (0x41, 0x47), (0x61, 0x67))

# loose property names (case, spaces, '_' and '-' ignored) -> table
_GC_LONG = {
    "letter": "L", "casedletter": "LC", "uppercaseletter": "Lu", "lowercaseletter": "Ll",
    "titlecaseletter": "Lt", "modifierletter": "Lm", "otherletter": "Lo", "mark": "M",
    "nonspacingmark": "Mn", "spacingmark": "Mc", "enclosingmark": "Me", "number": "N",
    "decimalnumber": "Nd", "letternumber": "Nl", "othernumber": "No", "punctuation": "P",
    "connectorpunctuation": "Pc", "dashpunctuation": "Pd", "openpunctuation": "Ps",
    "closepunctuation": "Pe", "initialpunctuation": "Pi", "finalpunctuation": "Pf",
    "otherpunctuation": "Po", "symbol": "S", "mathsymbol": "Sm", "currencysymbol": "Sc",
    "modifiersymbol": "Sk", "othersymbol": "So", "separator": "Z", "spaceseparator": "Zs",
    "lineseparator": "Zl", "paragraphseparator": "Zp", "other": "C", "control": "Cc",
    "format": "Cf", "surrogate": "Cs", "privateuse": "Co", "unassigned": "Cn",
    "alphabetic": "Alphabetic", "alpha": "Alphabetic", "whitespace": "White_Space",
    "wspace": "White_Space", "space": "White_Space",
}


def _loose(name: str) -> str:
    return re.sub(r"[\s_\-]", "", name).lower()


_NAMES: Dict[str, str] = {}


def property_ranges(name: str) -> List[Tuple[int, int]]:
    """The ranges of `\\p{name}`: a General_Category value or group (short
    or long name), Alphabetic, White_Space, a script of `uprops.SCRIPTS`
    (alone or as `Script=`/`sc=`), or Any."""
    if not _NAMES:
        for k in (*uprops.GENERAL_CATEGORIES, *uprops.GC_GROUPS):
            _NAMES[_loose(k)] = k
        _NAMES.update(_GC_LONG)
        for s in uprops.SCRIPTS:
            _NAMES.setdefault(_loose(s), "sc:" + s)
    key = _loose(name)
    for prefix in ("script=", "sc=", "generalcategory=", "gc="):
        if key.startswith(prefix):
            key = key[len(prefix):]
    if key == "any":
        return [(0, uprops.MAX_CP)]
    if key not in _NAMES:
        raise ValueError(f"unknown Unicode property \\p{{{name}}}")
    return uprops.union(uprops.ranges(_NAMES[key]))


_CLASSES: Dict[str, List[Tuple[int, int]]] = {}


def shorthand_ranges(letter: str, in_class: bool) -> List[Tuple[int, int]]:
    """The ranges of `\\w \\s \\d \\h` (lower case) or their complements,
    outside or inside brackets."""
    key = letter + ("[]" if in_class else "")
    if key not in _CLASSES:
        low = letter.lower()
        if low == "w":
            parts = [uprops.ranges(n) for n in ("Alphabetic", "M", "Nd", "Pc")]
            spans = uprops.union(*parts, *([] if in_class else [_LATIN1_DIGITS]))
        elif low == "s":
            spans = list(_SPACE)
        elif low == "d":
            spans = uprops.union(uprops.ranges("Nd"))
        else:
            spans = list(_HEX)
        _CLASSES[key] = spans if letter == low else uprops.complement(spans)
    return _CLASSES[key]


def _cp(c: int) -> str:
    return "\\U%08x" % c


def class_body(spans) -> str:
    """The inside of a bracket class holding `spans`."""
    return "".join(_cp(a) if b == a + 1 else f"{_cp(a)}-{_cp(b - 1)}" for a, b in spans)


def _braced(p: str, i: int, what: str) -> Tuple[str, int]:
    """The text of `{...}` at p[i] and the index after it."""
    j = p.find("}", i)
    if p[i:i + 1] != "{" or j < 0:
        raise ValueError(f"unterminated {what} at {i} in {p!r}")
    return p[i + 1:j], j + 1


_REFUSED_ESCAPES = {"X": "\\X (an extended grapheme cluster)", "R": "\\R (a line break)",
                    "K": "\\K (keep)", "G": "\\G (the search start)",
                    "Q": "\\Q..\\E (a quoted run)", "g": "\\g (a subexpression call)",
                    "y": "\\y (a text segment boundary)", "Y": "\\Y (a text segment boundary)",
                    "O": "\\O (any char)", "N": "\\N (a non-newline char)",
                    "c": "\\c (a control char)", "C": "\\C- (a control char)",
                    "M": "\\M- (a meta char)"}


def _escape(p: str, i: int, in_class: bool) -> Tuple[str, int]:
    """The translation of the escape at p[i] == '\\' and the index after it."""
    if i + 1 >= len(p):
        raise ValueError(f"a trailing backslash in {p!r}")
    c = p[i + 1]
    if c in "wWsSdDhH":
        spans = shorthand_ranges(c, in_class)
        return (class_body(spans) if in_class else f"[{class_body(spans)}]"), i + 2
    if c in "pP":
        if p[i + 2:i + 3] == "{":
            name, j = _braced(p, i + 2, "property")
        else:
            name, j = p[i + 2:i + 3], i + 3
        neg = c == "P"
        if name.startswith("^"):
            name, neg = name[1:], not neg
        spans = property_ranges(name)
        if in_class:
            return class_body(uprops.complement(spans) if neg else spans), j
        return f"[{'^' if neg else ''}{class_body(spans)}]", j
    if c == "x" and p[i + 2:i + 3] == "{":
        hexs, j = _braced(p, i + 2, "\\x{..}")
        return _cp(int(hexs, 16)), j
    if c == "e":
        return "\\x1b", i + 2
    if in_class:
        if c == "b":
            return "\\x08", i + 2
        if c in _REFUSED_ESCAPES:
            raise ValueError(f"{_REFUSED_ESCAPES[c]} is not supported in {p!r}")
        return p[i:i + 2], i + 2
    if c == "z":
        return "\\Z", i + 2
    if c == "Z":
        return "(?=\\n?\\Z)", i + 2
    if c in "bB":
        w = f"[{class_body(shorthand_ranges('w', False))}]"
        if c == "b":
            return f"(?:(?<={w})(?!{w})|(?<!{w})(?={w}))", i + 2
        return f"(?:(?<={w})(?={w})|(?<!{w})(?!{w}))", i + 2
    if c == "k" and p[i + 2:i + 3] in ("<", "'"):
        close = ">" if p[i + 2] == "<" else "'"
        j = p.find(close, i + 3)
        if j < 0:
            raise ValueError(f"unterminated \\k in {p!r}")
        return f"(?P={p[i + 3:j]})", j + 1
    if c in _REFUSED_ESCAPES:
        raise ValueError(f"{_REFUSED_ESCAPES[c]} is not supported in {p!r}")
    return p[i:i + 2], i + 2


def translate(p: str) -> Tuple[str, int]:
    """(pattern for `re`, flags): the Oniguruma (Ruby syntax) pattern `p`
    rewritten as the module docstring says; ValueError on what it cannot
    express."""
    out: List[str] = []
    flags = re.MULTILINE
    i, n = 0, len(p)
    in_class = class_start = False
    while i < n:
        c = p[i]
        if c == "\\":
            piece, i = _escape(p, i, in_class)
            out.append(piece)
            class_start = False
            continue
        if in_class:
            if c == "[":
                raise ValueError(f"a nested class or POSIX bracket at {i} in {p!r}")
            if p.startswith("&&", i):
                raise ValueError(f"a class set operation (&&) at {i} in {p!r}")
            if c == "]" and not class_start:
                in_class = False
            class_start = False
            out.append(c)
            i += 1
            continue
        if c == "[":
            in_class, class_start = True, True
            out.append(c)
            i += 1
            if p[i:i + 1] == "^":
                out.append("^")
                i += 1
            continue
        if c == "}" and p[i + 1:i + 2] == "+" and out and re.search(r"\{\d*,?\d*$", "".join(out)):
            raise ValueError(f"an interval followed by '+' at {i} in {p!r} (a repeat of the "
                             "interval in Ruby syntax, possessive in re)")
        if c == "(" and p[i + 1:i + 2] == "?":
            rest = p[i + 2:]
            if rest.startswith("<") and not rest.startswith(("<=", "<!")):
                out.append("(?P<")
                i += 3
                continue
            if rest.startswith("'"):
                j = p.find("'", i + 3)
                out.append(f"(?P<{p[i + 3:j]}>")
                i = j + 1
                continue
            if rest.startswith("~"):
                raise ValueError(f"an absence operator (?~ at {i} in {p!r}")
            m = re.match(r"([imx]*)(?:-([imx]*))?([:)])", rest)
            if m:
                on, off, end = m.group(1), m.group(2) or "", m.group(3)
                if end == ")":
                    if out:
                        raise ValueError(f"a flag group (?{m.group(0)} inside {p!r}")
                    flags |= (re.IGNORECASE if "i" in on else 0) | (
                        re.DOTALL if "m" in on else 0) | (re.VERBOSE if "x" in on else 0)
                    i += 2 + m.end()
                    continue
                tr = {"i": "i", "m": "s", "x": "x"}
                on_t = "".join(tr[f] for f in on)
                off_t = "".join(tr[f] for f in off)
                out.append(f"(?{on_t}{'-' + off_t if off_t else ''}:")
                i += 2 + m.end()
                continue
        out.append(c)
        i += 1
    if in_class:
        raise ValueError(f"an unterminated class in {p!r}")
    return "".join(out), flags


def translate_rust_regex(pattern: str) -> str:
    """`translate` as one string for `re`: the pattern with its flags as a
    leading inline group (the JAX package's function of this name gives a
    pattern for the `regex` module)."""
    translated, flags = translate(pattern)
    letters = "".join(f for f, bit in (("i", re.IGNORECASE), ("m", re.MULTILINE),
                                       ("s", re.DOTALL), ("x", re.VERBOSE)) if flags & bit)
    return f"(?{letters}){translated}"


class SysRegex:
    """A reference-syntax regex compiled with `re` through `translate`
    (the reference's SysRegex, `utils/onig.rs`)."""

    __slots__ = ("pattern", "compiled")

    def __init__(self, pattern: str):
        self.pattern = pattern
        translated, flags = translate(pattern)
        try:
            self.compiled = re.compile(translated, flags)
        except re.error as e:
            raise ValueError(f"cannot compile the regex {pattern!r}: {e}") from e

    def find_iter(self, s: str):
        for m in self.compiled.finditer(s):
            yield m.span()


Regex = SysRegex  # the reference binding's name for a pattern matched as a regex


PatternLike = Union[str, Callable[[str], bool], SysRegex, Invert, "re.Pattern"]


def _spans_to_matches(spans, s: str) -> List[Tuple[Offsets, bool]]:
    if not s:
        return [((0, 0), False)]
    out: List[Tuple[Offsets, bool]] = []
    prev = 0
    for start, end in spans:
        if prev != start:
            out.append(((prev, start), False))
        out.append(((start, end), True))
        prev = end
    if prev != len(s):
        out.append(((prev, len(s)), False))
    return out


def match_spans(pattern, s: str) -> List[Offsets]:
    """The char spans of the matches of `pattern` (not an `Invert`) in `s`."""
    if isinstance(pattern, str):
        if not pattern:
            return []
        spans, k, start = [], len(pattern), s.find(pattern)
        while start >= 0:
            spans.append((start, start + k))
            start = s.find(pattern, start + k)
        return spans
    if isinstance(pattern, SysRegex):
        return [m.span() for m in pattern.compiled.finditer(s)]
    if hasattr(pattern, "finditer"):
        return [m.span() for m in pattern.finditer(s)]
    if callable(pattern):
        return [(i, i + 1) for i, c in enumerate(s) if pattern(c)]
    raise TypeError(f"Unsupported pattern type: {type(pattern)}")


def find_matches(pattern: PatternLike, s: str) -> List[Tuple[Offsets, bool]]:
    if isinstance(pattern, Invert):
        return [(off, not m) for off, m in find_matches(pattern.pattern, s)]
    if isinstance(pattern, str) and not pattern:
        return [((0, len(s)), False)]  # the empty pattern matches nothing
    return _spans_to_matches(match_spans(pattern, s), s)
