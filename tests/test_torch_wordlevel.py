"""The WordLevel path of the port on the CPU, and the normalizers and
NormalizedString it shares with the char-level BPE path, bit-exact
(tolerance 0: every value is an id, a position, a count or a flag).

* `NormalizedString` after each normalizer of the port (and Metaspace's
  replacement and prepend) against the JAX package's, normalized text and
  byte alignments, on strings with accents, ligatures, CJK, combining
  marks, Hangul and whitespace; `normalize_str` against both.
* The engine's tables (class tables of the three pre-split kinds, the
  vocab's cuckoo table) against the JAX engine's arrays.
* `wordlevel_program`, with and without offsets, against the JAX program
  (its offsets form, whose first three outputs are the plain form's) on
  seeded [4, 256] byte rows, for each pre-split kind: one JAX compile
  each.
* `Tokenizer(..., device="cpu")` against the `tokenizers` wheel on the
  cases of `tests/test_device_wordlevel_engine.py` and the WordLevel
  cases of `tests/test_device_offsets.py`: `encode_batch_fast` ids and
  `encode_batch` ids, char offsets, tokens and word ids, and the host
  pipeline alone.
* On a card (`gpu`): the entry points equal their CPU runs.
"""

import json

import numpy as np
import pytest

import torch
from tokenizers import Tokenizer as WheelTokenizer
from tokenizers import models as wm
from tokenizers import normalizers as wn
from tokenizers import pre_tokenizers as wp

from tokenizers_tpu import normalizers as jn
from tokenizers_tpu.normalized import NormalizedString as JaxNS
from tokenizers_tpu.ops.wordlevel_encode import wordlevel_class_tables as j_tables
from tokenizers_tpu.ops.wordlevel_encode import wordlevel_program as j_program
from tokenizers_tpu.pre_tokenizers.metaspace import Metaspace as JaxMetaspace
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch import normalizers as tn
from tokenizers_tpu_torch.normalized import NormalizedString
from tokenizers_tpu_torch.normalizers.bert import BertNormalizer
from tokenizers_tpu_torch.ops.wordlevel_encode import wordlevel_class_tables, wordlevel_program
from tokenizers_tpu_torch.ops.wordlevel_engine import WordLevelEngine, tables_from_numpy
from tokenizers_tpu_torch.pre_tokenizers.metaspace import Metaspace

VOCAB = {}
for w in ("the quick brown fox jumps over lazy dog hello world don t it's "
          "a b c ! ? . , 序号 123 mixed2case UPPER _under score").split():
    VOCAB[w] = len(VOCAB)
VOCAB["<unk>"] = len(VOCAB)

# the BATCH of tests/test_device_wordlevel_engine.py, then the offsets cases
BATCH = [
    "the quick brown fox", "hello, world!", "don't stop", "序号 123 abc", "", "   ",
    "a  b   c", "UPPER lower MixedCase", "x" * 200 + " the", "it's a dog... or fox?",
    "tab\there and\nnewline", "trailing space ", "_under score_ _under",
    "Hello world!", "  spaced  out  ", "zzz unknownwordzz", "don't stop, won't stop",
    "Hello WORLD! The Café",
]
NORM_CASES = [
    "", "café résumé naïve söße", "ﬁle ﬂow Ｈｅｌｌｏ ①② ㍿", "中文 mixed École 日本語テキスト",
    "é̖x á̖ 각 한국어", "İstanbul ΟΔΟΣ ß", "  \t lead　trail  ",
    "a\x00b\x7f​� c", "▁literal ▁▁ meta",
]
NORMALIZERS = {
    "NFD": (tn.NFD(), jn.NFD()), "NFKD": (tn.NFKD(), jn.NFKD()), "NFC": (tn.NFC(), jn.NFC()),
    "NFKC": (tn.NFKC(), jn.NFKC()), "Lowercase": (tn.Lowercase(), jn.Lowercase()),
    "StripAccents": (tn.StripAccents(), jn.StripAccents()), "Strip": (tn.Strip(), jn.Strip()),
    "Replace": (tn.Replace(" ", "▁"), jn.Replace(" ", "▁")),
    "Prepend": (tn.Prepend("▁"), jn.Prepend("▁")),
    "Sequence": (tn.Sequence([tn.NFD(), tn.StripAccents(), tn.Lowercase()]),
                 jn.Sequence([jn.NFD(), jn.StripAccents(), jn.Lowercase()])),
    "Bert": (BertNormalizer(), jn.BertNormalizer()),
    "BertCased": (BertNormalizer(lowercase=False), jn.BertNormalizer(lowercase=False)),
}


@pytest.mark.parametrize("name", list(NORMALIZERS))
def test_normalized_string_matches_jax(name):
    ours, theirs = NORMALIZERS[name]
    for s in NORM_CASES:
        a, b = NormalizedString(s), JaxNS(s)
        ours.normalize(a)
        theirs.normalize(b)
        assert (a.get(), a.alignments) == (b.get(), b.alignments), (name, s)
        assert ours.normalize_str(s) == a.get(), (name, s)


@pytest.mark.parametrize("scheme", ["always", "first", "never"])
def test_metaspace_alignments_match_jax(scheme):
    from tokenizers_tpu.pretokenized import PreTokenizedString

    for s in NORM_CASES:
        for first in (True, False):
            a = NormalizedString(s)
            Metaspace(prepend_scheme=scheme).apply(a, first)
            b = JaxNS(s)
            b.replace(" ", "▁")
            if (scheme == "always" or (scheme == "first" and first)) \
                    and not b.get().startswith("▁"):
                b.prepend("▁")
            assert (a.get(), a.alignments) == (b.get(), b.alignments), (scheme, s)
        # the words: the JAX pre-tokenizer's splits of the whole text
        pre = PreTokenizedString(s)
        JaxMetaspace(prepend_scheme=scheme).pre_tokenize(pre)
        a = NormalizedString(s)
        Metaspace(prepend_scheme=scheme).apply(a, True)
        assert [a.get()[x:y] for x, y in Metaspace.word_spans(a.get())] == \
            [sp.normalized.get() for sp in pre.splits], s


@pytest.mark.parametrize("kind", ["whitespace", "whitespace_split", "bert"])
def test_class_tables_match_jax(kind):
    for got, want in zip(wordlevel_class_tables(kind), j_tables(kind)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _wheel(pre, normalizer=None, vocab=VOCAB, unk="<unk>"):
    ref = WheelTokenizer(wm.WordLevel(vocab, unk_token=unk))
    ref.pre_tokenizer = getattr(wp, pre)()
    if normalizer is not None:
        ref.normalizer = normalizer
    return ref


@pytest.fixture(scope="module", params=["Whitespace", "WhitespaceSplit", "BertPreTokenizer"])
def engines(request):
    """(kind, JAX engine, port engine) of one pre-tokenizer."""
    blob = _wheel(request.param).to_str()
    jax_eng = JaxTokenizer.from_str(blob)._get_device_engine()
    eng = Tokenizer.from_str(blob, device="cpu")._get_device_engine()
    assert type(eng).__name__ == "WordLevelEngine"
    return request.param, jax_eng, eng


def _jax_tables(e) -> dict:
    """The JAX engine's arrays in the port's keys."""
    rows = [np.stack([np.asarray(x)[t] for x in (e.d_vkey_a, e.d_vkey_b, e.d_vlen, e.d_vid)], -1)
            for t in (0, 1)]
    return dict(cls_s1=np.asarray(e.d_cls_s1), cls_s2=np.asarray(e.d_cls_s2), vrows0=rows[0],
                vrows1=rows[1], vseed=int(e.vseed), unk_id=int(e.unk_id))


def test_engine_tables_match_jax(engines):
    _pre, jax_eng, eng = engines
    want = _jax_tables(jax_eng)
    for k, v in want.items():
        got = eng.tables[k]
        if isinstance(v, int):
            assert got == v, k
        else:
            assert got.numpy().dtype == v.dtype and got.numpy().shape == v.shape, k
            np.testing.assert_array_equal(got.numpy(), v, err_msg=k)


POOL = ["the", "quick", "fox", "hello", "world", "café", "序号", "123", "mixed2case", "_under",
        "!", "...", ",", "it's", "zzz", "☃", "naïve", "UPPER", "score_", "x" * 40, "!!!!"]
SEPS = [" ", "  ", "\t", "\n", "　", "", " "]


def seeded_rows(seed, pool=POOL, seps=SEPS, B=4, L=256):
    """[B, L] uint8 rows of pool words and separators, cut at a char
    boundary to seeded lengths (row 0 nearly full, row 2 empty)."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for r in range(B):
        s = b""
        while True:
            w = (pool[rng.integers(len(pool))] + seps[rng.integers(len(seps))]).encode()
            if len(s) + len(w) > L:
                break
            s += w
        n = 0 if r == 2 else len(s) if r == 0 else int(rng.integers(1, len(s) + 1))
        while 0 < n < len(s) and (s[n] & 0xC0) == 0x80:
            n -= 1
        buf[r, :n] = np.frombuffer(s[:n], np.uint8)
        lens[r] = n
    return buf, lens


def test_program_matches_jax(engines):
    """Both variants of the port's program against the JAX offsets form,
    on rows of the JAX engine's own tables carried across."""
    _pre, jax_eng, _eng = engines
    T = tables_from_numpy(_jax_tables(jax_eng), "cpu")
    for seed in range(3):
        buf, lens = seeded_rows(seed)
        want = [np.asarray(x) for x in j_program(
            buf, lens, jax_eng.d_cls_s1, jax_eng.d_cls_s2, jax_eng.d_vkey_a, jax_eng.d_vkey_b,
            jax_eng.d_vlen, jax_eng.d_vid, jax_eng.vseed, jax_eng.unk_id, with_offsets=True)]
        b, n = torch.from_numpy(buf), torch.from_numpy(lens)
        got = wordlevel_program(b, n, T, with_offsets=True)
        plain = wordlevel_program(b, n, T)
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.numpy().dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"output {k}, seed {seed}")
        for k, (g, w) in enumerate(zip(plain, want[:3])):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"plain output {k}")


def _same(ours, ref, batch):
    a = [e.ids for e in ours.encode_batch_fast(batch)]
    b = [e.ids for e in ref.encode_batch_fast(batch, add_special_tokens=True)]
    assert a == b, [(s, x, y) for s, x, y in zip(batch, a, b) if x != y]
    theirs = ref.encode_batch(batch)
    for got in (ours.encode_batch(batch), [ours.encode_host(s, True, offsets="char")
                                           for s in batch]):
        for s, o, t in zip(batch, got, theirs):
            assert (o.ids, o.offsets, o.tokens, o.word_ids) == (
                t.ids, [tuple(x) for x in t.offsets], t.tokens, t.word_ids), s


@pytest.mark.parametrize("normalizer", [None, "Lowercase", "NFKC"])
def test_matches_wheel(engines, normalizer):
    pre, _jax_eng, _eng = engines
    ref = _wheel(pre, None if normalizer is None else getattr(wn, normalizer)())
    ours = Tokenizer.from_str(ref.to_str(), device="cpu")
    assert type(ours._get_device_engine()).__name__ == "WordLevelEngine"
    _same(ours, ref, BATCH + ["!" * 300])  # every byte a word: the row goes to the host


def test_added_tokens_route_host():
    """An added token in the raw text, and (as in the JAX engine) one that
    appears only in the normalized text, send the input to the host."""
    ref = _wheel("Whitespace", wn.Lowercase())
    ref.add_special_tokens(["<s>", "special"])
    ours = Tokenizer.from_str(ref.to_str(), device="cpu")
    eng = ours._get_device_engine()
    assert eng._needs_host("SPECIAL the fox", list(ours.added))
    _same(ours, ref, ["<s> the fox", "plain text the", "SPECIAL the fox"])


def test_offsets_cases_of_the_jax_suite():
    """`tests/test_device_offsets.py::test_wordlevel_offsets`: NFD,
    StripAccents, Lowercase, Whitespace, with and without the normalizer,
    every input on the device (the host path is not called)."""
    vocab = {"[UNK]": 0, "hello": 1, "world": 2, "the": 3, "a": 4, "cafe": 5, "!": 6, ",": 7,
             "quick": 8, "brown": 9, "fox": 10}
    batch = ["Hello world!", "the quick brown fox", "  spaced  out  ", "", "zzz unknownwordzz",
             "don't stop, won't stop", "Hello WORLD! The Café"]
    for nz in (wn.Sequence([wn.NFD(), wn.StripAccents(), wn.Lowercase()]), None):
        ref = _wheel("Whitespace", nz, vocab, "[UNK]")
        ours = Tokenizer.from_str(ref.to_str(), device="cpu")

        def boom(*a, **k):
            raise AssertionError("host fallback used")

        ours.encode_host = boom
        theirs = ref.encode_batch(batch)
        for s, o, t in zip(batch, ours.encode_batch(batch), theirs):
            assert (o.ids, o.offsets, o.tokens, o.word_ids) == (
                t.ids, [tuple(x) for x in t.offsets], t.tokens, t.word_ids), s


def test_unk_outside_vocab_takes_host():
    ref = _wheel("Whitespace")
    d = json.loads(ref.to_str())
    d["model"]["unk_token"] = "<none>"
    ours = Tokenizer.from_str(json.dumps(d), device="cpu")
    assert ours._get_device_engine() is None
    assert ours.encode_batch_fast(["the fox"])[0].ids == [0, 3]
    with pytest.raises(ValueError, match="unk token"):
        ours.encode_batch_fast(["the zzz"])


@pytest.mark.gpu
def test_gpu_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tokenizers_tpu_torch.smoke_data import build_docs, config_json

    docs = build_docs()[:40] + BATCH
    cpu = Tokenizer.from_str(config_json("wordlevel"), device="cpu")
    gpu = Tokenizer.from_str(config_json("wordlevel"))
    assert isinstance(gpu._get_device_engine(), WordLevelEngine)
    assert [e.ids for e in gpu.encode_batch_fast(docs)] == \
        [e.ids for e in cpu.encode_batch_fast(docs)]
    for g, c in zip(gpu.encode_batch(docs), cpu.encode_batch(docs)):
        assert (g.ids, g.offsets, g.word_ids) == (c.ids, c.offsets, c.word_ids)
