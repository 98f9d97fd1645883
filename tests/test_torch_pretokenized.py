"""The general host pipeline's strings (`normalized.py`, `pretokenized.py`)
and every pre-tokenizer and normalizer, on the CPU:

* `NormalizedString.split` (five behaviours, a regex and its inversion),
  `slice` and `convert_offsets` (both referentials), and
  `PreTokenizedString.get_splits` (original and normalized referentials;
  byte, char and no offsets) equal the JAX package's on `SHORT_STRINGS`
  after NFD, NFKC and Lowercase;
* every case of `tests/test_conformance_pretokenizers.py` and
  `tests/test_conformance_normalizers.py`, built in the port from the JAX
  package's object through its JSON (`pre_tokenizers.from_json`,
  `normalizers.from_json`): `pre_tokenize_str` and `normalize_str` equal
  JAX's and the wheel's, and the normalizer's `normalize` (the aligned
  form) gives JAX's alignments.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tokenizers_tpu as tt  # noqa: E402
from tokenizers_tpu import normalized as jn  # noqa: E402
from tokenizers_tpu import pattern as jp  # noqa: E402
from tokenizers_tpu import pretokenized as jpt  # noqa: E402
from tokenizers_tpu.serialization import normalizer_to_dict, pre_tokenizer_to_dict  # noqa: E402
from tokenizers_tpu_torch import normalized as pn  # noqa: E402
from tokenizers_tpu_torch import normalizers as P_N  # noqa: E402
from tokenizers_tpu_torch import pattern as pp  # noqa: E402
from tokenizers_tpu_torch import pre_tokenizers as P_P  # noqa: E402
from tokenizers_tpu_torch import pretokenized as ppt  # noqa: E402
from corpus import SHORT_STRINGS  # noqa: E402
from test_conformance_normalizers import pairs as normalizer_pairs  # noqa: E402
from test_conformance_pretokenizers import pairs as pre_tokenizer_pairs  # noqa: E402

NORMALIZERS = {"nfd": "nfd", "nfkc": "nfkc", "lowercase": "lowercase"}
BEHAVIORS = ("removed", "isolated", "merged_with_previous", "merged_with_next", "contiguous")


def _state(ns):
    return (ns.original, ns.normalized, list(ns.alignments), ns.original_shift)


def _pair(s, how):
    a, b = jn.NormalizedString(s), pn.NormalizedString(s)
    getattr(a, how)()
    getattr(b, how)()
    assert _state(a) == _state(b), (how, s)
    return a, b


@pytest.mark.parametrize("how", list(NORMALIZERS))
@pytest.mark.parametrize("behavior", BEHAVIORS)
def test_split_equals_jax(how, behavior):
    for s in SHORT_STRINGS:
        a, b = _pair(s, how)
        for jpat, ppat in ((jp.SysRegex(r"\w+"), pp.SysRegex(r"\w+")),
                           (jp.Invert(jp.SysRegex(r"\s+")), pp.Invert(pp.SysRegex(r"\s+"))),
                           (lambda c: c in ",.!'", lambda c: c in ",.!'")):
            assert [_state(x) for x in a.split(jpat, behavior)] == \
                [_state(x) for x in b.split(ppat, behavior)], (how, behavior, s)


@pytest.mark.parametrize("how", list(NORMALIZERS))
def test_slice_and_convert_offsets_equal_jax(how):
    for s in SHORT_STRINGS:
        a, b = _pair(s, how)
        for ref in ("original", "normalized"):
            n = a.len_original() if ref == "original" else len(a)
            assert b.len_original() == a.len_original()
            for start in range(0, n + 1, 3):
                for end in (start, start + 1, start + 4, n, None):
                    if end is not None and end > n:
                        continue
                    assert b.convert_offsets(start, end, ref) == \
                        a.convert_offsets(start, end, ref), (s, ref, start, end)
                    sa, sb = a.slice(start, end, ref), b.slice(start, end, ref)
                    assert (sa is None and sb is None) or _state(sa) == _state(sb), (s, start)
                    assert b.get_range(start, end, ref) == a.get_range(start, end, ref)
                    assert b.get_range_original(start, end, ref) == \
                        a.get_range_original(start, end, ref)


@pytest.mark.parametrize("how", list(NORMALIZERS))
def test_get_splits_equal_jax(how):
    jpun, ppun = tt.pre_tokenizers.Punctuation(), P_P.Punctuation()
    jws, pws = tt.pre_tokenizers.WhitespaceSplit(), P_P.WhitespaceSplit()
    for s in SHORT_STRINGS:
        a, b = _pair(s, how)
        ja, pb = jpt.PreTokenizedString(a), ppt.PreTokenizedString(b)
        for j, p in ((jws, pws), (jpun, ppun)):
            j.pre_tokenize(ja)
            p.pre_tokenize(pb)
        for ref in ("original", "normalized"):
            for kind in ("byte", "char", "none"):
                assert [x[:2] for x in pb.get_splits(ref, kind)] == \
                    [x[:2] for x in ja.get_splits(ref, kind)], (s, ref, kind)


def _port_pre_tokenizer(jax_obj):
    return P_P.from_json(pre_tokenizer_to_dict(jax_obj))


def _port_normalizer(jax_obj):
    return P_N.from_json(normalizer_to_dict(jax_obj))


@pytest.mark.parametrize("name,ref,mine", list(pre_tokenizer_pairs()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_pre_tokenize_str_equals_jax_and_wheel(name, ref, mine):
    ours = _port_pre_tokenizer(mine)
    for s in SHORT_STRINGS:
        assert ours.pre_tokenize_str(s) == mine.pre_tokenize_str(s) == \
            ref.pre_tokenize_str(s), (name, s)


@pytest.mark.parametrize("name,ref,mine", list(normalizer_pairs()),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_normalize_str_equals_jax_and_wheel(name, ref, mine):
    ours = _port_normalizer(mine)
    for s in SHORT_STRINGS:
        assert ours.normalize_str(s) == mine.normalize_str(s) == ref.normalize_str(s), (name, s)
        a, b = jn.NormalizedString(s), pn.NormalizedString(s)
        mine.normalize(a)
        ours.normalize(b)
        assert _state(b) == _state(a), (name, s)
