"""The port's patterns (`tokenizers_tpu_torch/pattern.py`) and the committed
Unicode property tables (`uprops.py`, `data/uprops.npz`), on the CPU:

* every table equals the `regex` module's class over every code point
  (one `finditer` of the class's runs over a string of all of them);
* `find_matches` equals the JAX package's on the lines of
  `tests/corpus.py` and the first 2,000 lines of the corpus, for the
  gpt2, llama-3 and Qwen2 split patterns, `\\w+|[^\\w\\s]+`, `\\s+`,
  `" {2,}"`, an inverted `\\w+`, a callable and a literal;
* where Oniguruma (the wheel) and the JAX package's `regex` translation
  read a pattern differently (line anchors, `\\w` inside brackets, `\\h`),
  the port matches as the wheel does;
* what the translator cannot express raises ValueError;
* the Replace decoder's regex means Oniguruma's `\\w` and `\\s`, as JAX's.
"""

import os
import re
import sys

import pytest
import regex
import tokenizers as hf

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tokenizers_tpu import decoders as jd  # noqa: E402
from tokenizers_tpu import pattern as jp  # noqa: E402
from tokenizers_tpu_torch import decoders as td  # noqa: E402
from tokenizers_tpu_torch import pattern as tp  # noqa: E402
from tokenizers_tpu_torch import uprops  # noqa: E402
from tokenizers_tpu_torch.pre_tokenizers import Split  # noqa: E402
from tokenizers_tpu_torch.pre_tokenizers.byte_level import GPT2_SPLIT_PATTERN  # noqa: E402
from tokenizers_tpu_torch.pre_tokenizers.split import LLAMA3_PATTERN  # noqa: E402
from tokenizers_tpu_torch.smoke_data import QWEN2_PATTERN  # noqa: E402
from corpus import SHORT_STRINGS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EVERY = None
_LINES = None


def _every() -> str:
    global _EVERY
    if _EVERY is None:
        _EVERY = "".join(map(chr, range(uprops.MAX_CP)))
    return _EVERY


def _lines():
    global _LINES
    if _LINES is None:
        with open(os.path.join(REPO, "tests", "fixtures", "corpus.txt"), encoding="utf-8") as f:
            _LINES = SHORT_STRINGS + f.read().splitlines()[:2000]
    return _LINES


@pytest.mark.parametrize("name", uprops.table_names())
def test_table_equals_regex(name):
    runs = [m.span() for m in regex.finditer("(?:%s)+" % uprops.regex_class(name), _every())]
    assert [tuple(map(int, r)) for r in uprops.ranges(name)] == runs


def _is_vowel(c):
    return c in "aeiouAEIOU"


PATTERNS = {
    "gpt2": lambda m: m.SysRegex(GPT2_SPLIT_PATTERN),
    "llama3": lambda m: m.SysRegex(LLAMA3_PATTERN),
    "qwen2": lambda m: m.SysRegex(QWEN2_PATTERN),
    "whitespace": lambda m: m.SysRegex(r"\w+|[^\w\s]+"),
    "spaces": lambda m: m.SysRegex(r"\s+"),
    "space_runs": lambda m: m.SysRegex(" {2,}"),
    "inverted_word": lambda m: m.Invert(m.SysRegex(r"\w+")),
    "callable": lambda m: _is_vowel,
    "literal": lambda m: "th",
}


@pytest.mark.parametrize("name", list(PATTERNS))
def test_find_matches_equals_jax(name):
    ours, theirs = PATTERNS[name](tp), PATTERNS[name](jp)
    for s in _lines():
        assert tp.find_matches(ours, s) == jp.find_matches(theirs, s), (name, s)


def _wheel_removed(pattern: str, s: str):
    return hf.pre_tokenizers.Split(hf.Regex(pattern), "removed").pre_tokenize_str(s)


@pytest.mark.parametrize("pattern,text", [
    ("^a", "a\na ba"),  # Ruby syntax: ^ and $ are line anchors
    ("a$", "a\nba\na"),
    (r"[\w]+", "x²y ab,½ c"),  # Oniguruma's \w inside brackets has no ²³¹¼½¾
    (r"[^\w\s]+", ",²,½ x¹"),
    (r"\w+", "a‌b x²y ½z ‍q"),  # outside brackets it has them
    (r"\h+", "0aFgz9"),
    (r"\d+", "12٣4x²"),
    (r"\bx", "ax x²x _x"),
    (r"(?m)a.b", "a\nb axb"),
    (r"\p{Greek}+|\p{Han}+", "αβ abc 日本"),
    (r"(?<n>a)\k<n>", "aa a"),
])
def test_departures_from_jax_follow_the_wheel(pattern, text):
    assert Split(("Regex", pattern), "removed").pre_tokenize_str(text) == \
        _wheel_removed(pattern, text)


@pytest.mark.parametrize("pattern", [
    r"[a-z&&[^c]]",  # class set operations
    r"[[:alpha:]]",  # a POSIX bracket
    r"(?<=a|bc)d",  # a variable-length lookbehind
    r"\X",
    r"\R",
    r"a\Kb",
    r"\p{NotAProperty}",
    r"a{2}+",  # a repeat of the interval in Ruby syntax, possessive in re
    r"x(?i)y",  # a flag group inside the pattern
    r"[abc",
])
def test_refuses_what_it_cannot_express(pattern):
    with pytest.raises(ValueError):
        tp.SysRegex(pattern)


def test_replace_decoder_matches_oniguruma_classes():
    """Python's `\\w` holds ⅓ and leaves combining marks out, its `\\s`
    holds U+001C; Oniguruma's, JAX's and the port's the other way round."""
    tokens = ["x²y", "a\u0301b", "⅓!", "a_b c", "ǅ z", "\x1cq"]
    for pattern in (r"\w", r"\s"):
        ours = td.Replace(pattern, "#", regex=True)
        theirs = jd.Replace(("Regex", pattern), "#")
        wheel = hf.decoders.Replace(hf.Regex(pattern), "#")
        assert ours.decode(tokens) == theirs.decode(tokens) == wheel.decode(tokens), pattern
        assert ours.decode(tokens) != "".join(re.sub(pattern, "#", t) for t in tokens)
