"""`Precompiled` and the port's grapheme segmentation, on the CPU, against
the JAX package's `Precompiled` (which splits with `regex`'s `\\X`) and the
`tokenizers` wheel's `normalizers.Precompiled` (Rust's
`unicode-segmentation`).

The charsmap is `data/charsmap_nfkc.bin` (`data/regen.py --charsmap`):
the NFKC map of every code point it changes, decomposed letter + mark
pairs, and a few multi-char graphemes, among them keys of 6 bytes and
more, which are never looked up whole.  `t5_shape` is the unigram
fixture's model behind Sequence[Precompiled(that charsmap), Replace(" {2,}",
" ")], T5's pipeline shape; no engine takes it, as none takes it in JAX.

The segmenter is held against `\\X` on every pair of code points of the
table's classes and on the sequences of GB9c, GB11 and GB12-13.  Where
`\\X` (the installed `regex`, Unicode 17) and the wheel differ, the wheel's
segmentation is probed through its `Precompiled` (a key "a" + mark is
replaced whole only when the two are one grapheme), and the port follows
the wheel: `graphemes.WHEEL_OTHER`.
"""

import json
import random

import numpy as np
import pytest
import regex
from tokenizers import Tokenizer as WheelTokenizer
from tokenizers import normalizers as wheel_normalizers

from tokenizers_tpu.normalized import NormalizedString as JaxNormalizedString
from tokenizers_tpu.normalizers.precompiled import Precompiled as JaxPrecompiled
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.data.regen import (CHARSMAP_EXTRA, charsmap_nfkc_rules,
                                             grapheme_props, precompiled_charsmap)
from tokenizers_tpu_torch.graphemes import (EXT_PICT, EXTEND, SPACING_MARK, WHEEL_OTHER, ZWJ,
                                            graphemes, table)
from tokenizers_tpu_torch.normalized import NormalizedString
from tokenizers_tpu_torch.normalizers.precompiled import CHARSMAP_NFKC_PATH, Precompiled
from tokenizers_tpu_torch.smoke_data import T5_SHAPE, host_pipelines

with open(CHARSMAP_NFKC_PATH, "rb") as _f:
    CHARSMAP = _f.read()
MIXED = [
    "été café naïve ＡＢＣ x² ½ ﬁle",
    "\U0001f44d\U0001f3fb ok \U0001f1fa\U0001f1f8 ©️ 1⃣ 가",
    "ﬁ́ ḳ́ ḱ ①́ 　　x  y",
    "\U0001f468‍\U0001f469‍\U0001f467 क्ष क्‍ष",
    "a᫏ ᫏b \r\ń ؀a é́̂",
    "",
]


def _jax_normalize(p: JaxPrecompiled, s: str):
    ns = JaxNormalizedString(s)
    p.normalize(ns)
    return ns.get(), ns.alignments


def _port_normalize(p: Precompiled, s: str):
    ns = NormalizedString(s)
    p.normalize(ns)
    return ns.get(), ns.alignments


@pytest.fixture(scope="module")
def three():
    return Precompiled(CHARSMAP), JaxPrecompiled(CHARSMAP), wheel_normalizers.Precompiled(CHARSMAP)


def test_every_key_of_the_charsmap(three):
    port, jax, wheel = three
    rules = charsmap_nfkc_rules()
    assert len(rules) > 5000
    for key, norm in rules.items():
        got = port.normalize_str(key)
        assert got == _jax_normalize(jax, key)[0] == wheel.normalize_str(key), repr(key)
        if len(key.encode("utf-8")) < 6 and len(graphemes(key)) == 1:
            assert got == norm, repr(key)


def test_the_committed_charsmap_is_the_writers():
    assert precompiled_charsmap(charsmap_nfkc_rules()) == CHARSMAP


@pytest.mark.parametrize("case", range(len(MIXED) + 1))
def test_texts_and_alignments_equal_jax_and_the_wheel(three, case):
    port, jax, wheel = three
    if case < len(MIXED):
        texts = [MIXED[case]]
    else:
        with open("tests/fixtures/corpus.txt", encoding="utf-8") as f:
            texts = [line for line in f.read().splitlines() if line][:300]
    for s in texts:
        got, got_align = _port_normalize(port, s)
        want, want_align = _jax_normalize(jax, s)
        assert got == wheel.normalize_str(s), repr(s)
        if not set(map(ord, s)) & set(WHEEL_OTHER):  # JAX follows \X there
            assert (got, [tuple(a) for a in got_align]) == (want, [tuple(a) for a in want_align])


def test_longest_prefix_and_whole_grapheme_quirks(three):
    port, _jax, wheel = three
    # a grapheme under 6 bytes whose first char is a key becomes that key's string whole
    assert port.normalize_str("ﬁ́") == wheel.normalize_str("ﬁ́") == "fi"
    # "ḳ́" is a key; "ḱ" is none, so each char is looked up
    assert port.normalize_str("ḳ́") == CHARSMAP_EXTRA["ḳ́"]
    assert port.normalize_str("ḱ") == "ḱ"
    # a 6-byte grapheme (Hangul L V) is looked up char by char: its key never hits
    assert port.normalize_str("가") == wheel.normalize_str("가") \
        == "가"
    with pytest.raises(ValueError, match="too short"):
        Precompiled(b"\x00\x00")


def _t5():
    return host_pipelines()[T5_SHAPE]


@pytest.mark.parametrize("texts", ["mixed", "corpus"])
def test_t5_shape_encodes_as_the_wheel(texts):
    blob = _t5()
    tok = Tokenizer.from_str(blob, device="cpu")
    assert tok._get_device_engine() is None
    ref = WheelTokenizer.from_str(blob)
    if texts == "mixed":
        batch = MIXED + ["Hello World!  The   END", "  leading\tand trailing  "]
    else:
        with open("tests/fixtures/corpus.txt", encoding="utf-8") as f:
            batch = [line for line in f.read().splitlines() if line][300:306]
    got, want = tok.encode_batch(batch), ref.encode_batch(batch)
    for g, w, t in zip(got, want, batch):
        assert (g.ids, g.tokens, g.offsets) == (w.ids, w.tokens, [tuple(o) for o in w.offsets]), t
    assert [e.ids for e in tok.encode_batch_fast(batch)] == [e.ids for e in want]


def test_t5_shape_on_the_smoke_documents():
    """The 16 8 KB corpus documents `chip_smoke.py` phase 17 encodes, against
    the wheel's digests (`data/host_pipelines_digests.json`)."""
    from tokenizers_tpu_torch.smoke_data import (host_pipeline_docs, ids_digest,
                                                 load_host_pipelines_digests, offsets_digest)

    tok = Tokenizer.from_str(_t5(), device="cpu")
    docs, want = host_pipeline_docs(T5_SHAPE), load_host_pipelines_digests()[T5_SHAPE]
    assert [ids_digest(e.ids) for e in tok.encode_batch_fast(docs)] == want["fast"]
    assert [offsets_digest(e) for e in tok.encode_batch(docs)] == want["offsets"]


def test_to_str_round_trips():
    blob = _t5()
    tok = Tokenizer.from_str(blob, device="cpu")
    s = tok.to_str()
    assert json.loads(s)["normalizer"] == json.loads(WheelTokenizer.from_str(blob).to_str())[
        "normalizer"]
    assert Tokenizer.from_str(s, device="cpu").to_str() == s
    alone = json.loads(blob)
    alone["normalizer"] = alone["normalizer"]["normalizers"][0]
    one = Tokenizer.from_str(json.dumps(alone), device="cpu")
    assert json.loads(one.to_str())["normalizer"] == alone["normalizer"]
    assert one.normalizer.precompiled_charsmap == CHARSMAP


# ------------------------------------------------------------- segmentation

def _representatives():
    """Three code points of each distinct property byte of the table, the
    wheel's pinned marks left out."""
    t = np.frombuffer(table(), np.uint8)
    reps, skip = {}, set(WHEEL_OTHER)
    for cp in range(0x110000):
        if 0xD800 <= cp < 0xE000 or cp in skip:
            continue
        got = reps.setdefault(int(t[cp]), [])
        if len(got) < 3:
            got.append(cp)
    return [cp for cps in reps.values() for cp in cps]


def test_table_is_regex_s_properties():
    t = np.frombuffer(table(), np.uint8).copy()
    want = grapheme_props()
    want[list(WHEEL_OTHER)] = 0
    assert np.array_equal(t, want)


def test_every_pair_of_classes_equals_x():
    reps = _representatives()
    assert len(reps) > 40
    for a in reps:
        for b in reps:
            s = chr(a) + chr(b)
            assert graphemes(s) == regex.findall(r"\X", s), (hex(a), hex(b))


@pytest.mark.parametrize("s", [
    "क्ष",                  # GB9c: consonant, virama (linker), consonant
    "क््षि",      # two linkers, then a mark
    "क्́́ष",      # InCB extends around the linker
    "क्‍ष",            # ZWJ is InCB Extend
    "कष",                        # no linker: a break
    "अ्ष",                  # no consonant before the linker
    "\U0001f468‍\U0001f469‍\U0001f467",  # GB11
    "\U0001f44d́‍\U0001f44d",
    "a‍\U0001f44d",                   # no ExtPict before the ZWJ
    "\U0001f44d‍‍\U0001f44d",
    "\U0001f1fa\U0001f1f8\U0001f1ec\U0001f1e7\U0001f1eb",  # GB12-13: pairs
    "a\U0001f1fa\U0001f1f8\U0001f1ec",
    "\r\n\r\r\n\n", "각각각ᅡ", "؀؀aः",
])
def test_rule_sequences_equal_x(s):
    assert graphemes(s) == regex.findall(r"\X", s)
    assert graphemes(s + "x" + s) == regex.findall(r"\X", s + "x" + s)


def test_random_sequences_equal_x():
    reps = _representatives()
    rng = random.Random(0)
    for _ in range(20000):
        s = "".join(chr(rng.choice(reps)) for _ in range(rng.randint(1, 8)))
        assert graphemes(s) == regex.findall(r"\X", s), [hex(ord(c)) for c in s]


def test_follows_the_wheel_where_x_differs():
    """Every mark `regex` joins (Extend, SpacingMark, ZWJ): the wheel joins
    "a" + mark exactly where the port does, and the pinned marks are those
    where the wheel and `\\X` differ."""
    t = np.frombuffer(table(), np.uint8)
    props = grapheme_props()
    marks = [cp for cp in range(0x110000) if not 0xD800 <= cp < 0xE000
             and props[cp] & 15 in (EXTEND, SPACING_MARK, ZWJ)]
    keys = ["a" + chr(cp) for cp in marks]
    wheel = wheel_normalizers.Precompiled(precompiled_charsmap(dict.fromkeys(keys, "Z")))
    differ = []
    for cp, key in zip(marks, keys):
        joins = wheel.normalize_str(key) == "Z"
        assert joins == (len(graphemes(key)) == 1), hex(cp)
        if joins != (len(regex.findall(r"\X", key)) == 1):
            differ.append(cp)
    assert differ == sorted(WHEEL_OTHER)
    assert graphemes("a᫏") == ["a", "᫏"] and regex.findall(r"\X", "a᫏") == [
        "a᫏"]
    assert not any(t[cp] & EXT_PICT for cp in WHEEL_OTHER)
