"""The BERT WordPiece path of the port on the CPU, bit-exact (tolerance 0:
every value is an id, a position, a count, a hash or a flag).

* The normalizer and class tables against the JAX package's
  `bert_normalizer_tables(True, True, None, True)` and
  `bert_class_tables()`, and every engine table against the JAX engine's,
  key by key; the programs below also run on tables carried over from the
  JAX engine (`wordpiece_engine.tables_from_numpy`).
* `wordpiece_program`, ASCII and generic, with and without offsets,
  against the JAX program (its offsets form, whose first three outputs are
  the plain form's) on [16, 128] chunks of the adversarial and fuzz cases
  of `tests/test_device_wordpiece_engine.py`.
* The dedup program with the word cache (`wordpiece_dedup_scan`, each
  chunk through `wordpiece_dedup_core`): two passes over [8, 256] chunks,
  the second reading the first's cache entries, against the JAX
  `wordpiece_dedup_scan`, with the cache state after each pass; one chunk
  overflows its unique buffer, and a small token buffer forces epoch
  resets.
* `Tokenizer(..., device="cpu")` against the `tokenizers` wheel on those
  cases, 80 corpus lines, a word over WORD_CAP and a 100 KB document
  split into pieces: `encode_batch_fast` ids and `encode_batch` ids, char
  offsets, tokens and word ids; byte offsets against the JAX package's
  host path; the `[CLS] ... [SEP]` template; the host pipeline alone.
* On a card (`gpu`): the dedup program at [256, 8192] on a corpus chunk,
  and the entry points, equal to their CPU runs.

The JAX programs compile once per shape (about 6 s for each variant of the
dense program and 25 s for the scan here); no other JAX shape is used.
"""

import random

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.ops import bert_tables as jbt
from tokenizers_tpu.ops.wordpiece_dedup import wordpiece_dedup_scan as j_scan
from tokenizers_tpu.ops.wordpiece_encode import wordpiece_program as j_program
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.ops import bert_tables as tbt
from tokenizers_tpu_torch.ops import engine_base
from tokenizers_tpu_torch.ops.bpe_dedup import WordCache
from tokenizers_tpu_torch.ops.engine_base import CHUNK_TARGET
from tokenizers_tpu_torch.ops.longdoc import split_long
from tokenizers_tpu_torch.ops.wordpiece_dedup import wordpiece_dedup_core, wordpiece_dedup_scan
from tokenizers_tpu_torch.ops.wordpiece_encode import wordpiece_program
from tokenizers_tpu_torch.ops.wordpiece_engine import (
    HOST_KEYS, SCALAR_KEYS, TABLE_KEYS, WordPieceEngine, tables_from_numpy,
)
from tokenizers_tpu_torch.smoke_data import build_docs

BERT = "tests/fixtures/bert/tokenizer.json"

# the ADVERSARIAL cases of tests/test_device_wordpiece_engine.py, then
# those of its offsets tests
ADVERSARIAL = [
    "", " ", "Hello, World!", "HeLLo hello HELLO", "unaffable unwanted running",
    "café naïve résumé ÉLAN", "中文分词测试 中A文", "İstanbul ß ﬁle", "xqzqxjv zzzzzz qqq",
    "a" * 120, "punct...!!!x, (a-b)", "\x00\x01control\x7fchars", "tabs\tand\nnewlines  spaces",
    "[CLS] routed to host [SEP]", "digits 12345 mixed99words",
    "中文 mixed École", "ﬁﬂ ligatures",
]


def _fuzz():
    """The fuzz cases of tests/test_device_wordpiece_engine.py."""
    random.seed(13)
    pieces = list("ab XY z19'.!ñé序\t中") + ["##", "the", "run", "  ", "...", "ﬁ"]
    return ["".join(random.choice(pieces) for _ in range(random.randint(0, 25)))
            for _ in range(100)]


FUZZ = _fuzz()
CASES = ADVERSARIAL + FUZZ + ["a[SEP]b [MASK]", "x" * 600 + " tail", "　中 x "]


def _corpus(n, ascii_only=False, max_len=None):
    lines = [ln for ln in open("tests/fixtures/corpus.txt", encoding="utf-8").read().split("\n")
             if ln and (ln.isascii() or not ascii_only)]
    return [ln[:max_len] for ln in lines[:n]]


def _long_doc():
    """About 100 KB: over MAX_L // 2, so it is split into <= 32 KB pieces,
    with a few multi-byte chars so that pieces re-base in chars."""
    text = " ".join(_corpus(400)) + " café 中文 naïve"
    while len(text.encode()) < 100_000:
        text = text + " " + text
    doc = text.encode()[:100_000].decode("utf-8", "ignore")
    assert len(split_long(doc.encode(), CHUNK_TARGET)) > 2
    return doc


@pytest.fixture(scope="module")
def jax_engine():
    tok = JaxTokenizer.from_file(BERT)
    return tok, tok._get_device_engine()


@pytest.fixture(scope="module")
def port():
    tok = Tokenizer.from_file(BERT, device="cpu")
    eng = tok._get_device_engine()
    assert isinstance(eng, WordPieceEngine) and eng.tables["ascii_ok"]
    return tok, eng


@pytest.fixture(scope="module")
def carried(jax_engine):
    """The port's tables carried over from the JAX engine."""
    _tok, je = jax_engine
    d = {k: np.asarray(getattr(je, f"d_{k}")) for k in TABLE_KEYS + HOST_KEYS}
    d.update(vseed=je.vseed, unk_id=je.unk_id, max_len=je.max_len,
             max_word_chars=je.max_word_chars, ascii_ok=je.ascii_ok)
    return tables_from_numpy(d, "cpu")


def test_bert_tables_match_jax():
    want = jbt.bert_normalizer_tables(True, True, None, True) + jbt.bert_class_tables()
    got = tbt.bert_normalizer_tables(True, True, None, True) + tbt.bert_class_tables()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for name in ("NORM_K", "BERT_WS", "BERT_PUNCT", "BERT_OTHER", "PAGE_BITS", "MAX_CP"):
        assert getattr(tbt, name) == getattr(jbt, name)


@pytest.mark.parametrize("key", TABLE_KEYS + HOST_KEYS + SCALAR_KEYS + ("ascii_ok",))
def test_engine_tables_match_jax(port, carried, key):
    got, want = port[1].tables[key], carried[key]
    if isinstance(got, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want)
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


def _pack(strings, L):
    rows = [s.encode() for s in strings]
    assert all(len(r) <= L for r in rows)
    b = np.zeros((len(rows), L), np.uint8)
    for i, r in enumerate(rows):
        b[i, :len(r)] = np.frombuffer(r, np.uint8)
    return b, np.array([len(r) for r in rows], np.int32)


def _dense_chunks(ascii_only, B=16, L=128):
    cases = [s for s in ADVERSARIAL + FUZZ if s.isascii() or not ascii_only]
    cases += [""] * (-len(cases) % B)
    return [_pack(cases[k:k + B], L) for k in range(0, len(cases), B)]


@pytest.mark.parametrize("ascii_only", [True, False])
def test_program_matches_jax(jax_engine, carried, ascii_only):
    """Both variants, with and without offsets: ids, ntok, row_bad and
    st_char, en_char, word_idx, bit for bit."""
    _tok, je = jax_engine
    chunks = _dense_chunks(ascii_only)
    assert (max(int(b.max()) for b, _ in chunks) < 128) == ascii_only
    expand = 1 if ascii_only else 2
    names = ("ids", "ntok", "row_bad", "st_char", "en_char", "word_idx")
    n_tok = n_unk = 0
    for b, n in chunks:
        want = j_program(
            b, n, je.d_norm_s1, je.d_norm_ob, je.d_norm_ol, je.d_cls_s1, je.d_cls_s2,
            je.d_vrows0, je.d_vrows1, je.vseed, je.d_pow1, je.d_pow2, je.unk_id,
            max_len=je.max_len, max_word_chars=je.max_word_chars, expand=expand,
            with_offsets=True, ascii_only=ascii_only,
            ascii_nb=je.d_ascii_nb if ascii_only else None,
            ascii_cls=je.d_ascii_cls if ascii_only else None)
        bt, nt = torch.from_numpy(b), torch.from_numpy(n)
        for with_offsets in (True, False):
            got = wordpiece_program(bt, nt, carried, expand=expand, with_offsets=with_offsets,
                                    ascii_only=ascii_only)
            assert len(got) == (6 if with_offsets else 3)
            for name, g, w in zip(names, got, want):
                assert g.dtype == (torch.bool if name == "row_bad" else torch.int32), name
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        ids = np.asarray(want[0])
        n_tok += int((ids >= 0).sum())
        n_unk += int((ids == je.unk_id).sum())
    assert n_tok > 100 and n_unk > 0


def _dedup_chunks():
    """Four [8, 256] ASCII chunks: corpus lines with edge cases, and one of
    distinct random words whose unique bytes overflow the buffer."""
    rows = _corpus(12, ascii_only=True, max_len=250) + [
        "", "   ", "a", "hello world!", "unbelievable transformations",
        "zzqqy zzqqy unmatchablezzz", "a.b.c!d?e", "the the the the the the",
        "a" * 120, "\x00\x01control\x7fchars\ttab", "x" * 101, "x" * 100]
    rng = np.random.default_rng(3)
    assert len(rows) == 24
    for _ in range(8):
        words = ["".join(chr(c) for c in rng.integers(97, 123, 6)) for _ in range(36)]
        rows.append(" ".join(words)[:250])
    return [_pack(rows[k:k + 8], 256) for k in range(0, 32, 8)]


def test_dedup_scan_matches_jax(jax_engine, carried):
    """Two passes of the cached scan, the second reading the first's cache
    entries: ids, ntok, row_bad and the cache state, bit for bit, against
    the JAX scan; chunk by chunk through `wordpiece_dedup_core` the same."""
    _tok, je = jax_engine
    chunks = _dedup_chunks()
    bufs = np.stack([b for b, _ in chunks])
    lens = np.stack([n for _, n in chunks])
    slots, cap = 1 << 12, 1100  # a small token buffer: epoch resets
    jst = (jnp.zeros((slots, 4), jnp.int32), jnp.full((cap + 1,), -1, jnp.int32),
           jnp.int32(0))
    cache = WordCache(slots, cap, "cpu")
    for pass_ in range(2):
        *want, jst = j_scan(bufs, lens, word_cache=True, cache_rows=jst[0], cache_buf=jst[1],
                            cache_p=jst[2], **je._dedup_args())
        got = wordpiece_dedup_scan(torch.from_numpy(bufs), torch.from_numpy(lens), carried,
                                   cache=cache)
        for name, g, w in zip(("ids", "ntok", "row_bad"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {pass_}")
        np.testing.assert_array_equal(cache.rows.numpy(), np.asarray(jst[0]))
        np.testing.assert_array_equal(cache.buf.numpy(), np.asarray(jst[1]))
        assert cache.p == int(jst[2])
        if pass_ == 0:
            first, p_first = got, cache.p
    bad = got[2].numpy()
    assert bad[3].all() and not bad[:3].any()  # the overflowing chunk goes to the host
    assert int((got[0] == je.unk_id).sum()) > 0

    # the first pass's chunks one by one through the core: the epoch resets
    cache2, p_seen = WordCache(slots, cap, "cpu"), []
    for k in range(4):
        out = wordpiece_dedup_core(torch.from_numpy(bufs[k]), torch.from_numpy(lens[k]),
                                   carried, cache=cache2)
        for g, w in zip(out, first):
            np.testing.assert_array_equal(g.numpy(), w[k].numpy())
        p_seen.append(cache2.p)
    assert cache2.p == p_first and any(b < a for a, b in zip(p_seen, p_seen[1:]))


def _same(got, want, cases):
    for s, g, w in zip(cases, got, want):
        assert (g.ids, g.offsets, g.tokens, g.words) == \
            (w.ids, [tuple(x) for x in w.offsets], w.tokens, w.word_ids), repr(s)[:80]


def test_port_matches_wheel(port):
    tok, _eng = port
    wheel = WheelTokenizer.from_file(BERT)
    cases = CASES + _corpus(80) + [_long_doc()]
    engine_base.STATS.reset()
    want = wheel.encode_batch(cases, add_special_tokens=True)
    assert [e.ids for e in tok.encode_batch_fast(cases)] == [e.ids for e in want]
    st = engine_base.STATS.snapshot()
    # the word over WORD_CAP is flagged; inputs with added tokens go to the host
    assert st["bad_rows"] >= 1 and st["host_pre_inputs"] >= 2
    _same(tok.encode_batch(cases), want, cases)
    _same([tok.encode_host(s, True, offsets="char") for s in cases[:40]], want[:40], cases)
    assert [tok.encode_host(s).ids for s in cases[:40]] == [e.ids for e in want[:40]]


def test_byte_offsets_match_jax_host(port, jax_engine):
    tok, _eng = port
    jtok, _ = jax_engine
    cases = ADVERSARIAL + FUZZ[:30] + ["中文 École naïve"]
    got = tok.encode_batch_byte_offsets(cases)
    for s, g in zip(cases, got):
        w = jtok._encode(s, None, True, "byte")
        assert (g.ids, g.offsets, g.tokens, g.words) == (w.ids, w.offsets, w.tokens, w.words), s
        h = tok.encode_host(s, True, offsets="byte")
        assert (h.ids, h.offsets, h.tokens, h.words) == (w.ids, w.offsets, w.tokens, w.words), s


def test_cls_sep_template(port):
    tok, _eng = port
    for enc in (tok.encode_batch_fast(["hello"])[0], tok.encode("hello")):
        assert enc.ids[0] == tok.token_to_id("[CLS]") and enc.ids[-1] == tok.token_to_id("[SEP]")
        assert enc.words[0] is None and enc.words[-1] is None
        assert enc.offsets[0] == enc.offsets[-1] == (0, 0)
    assert tok.encode_batch_fast(["hello"], add_special_tokens=False)[0].ids == \
        tok.encode_batch_fast(["hello"])[0].ids[1:-1]


def test_encode_batch_arrays(port):
    tok, _eng = port
    cases = _corpus(30) + ["x" * 600, "a[SEP]b"]
    fast = tok.encode_batch_fast(cases, add_special_tokens=False)
    seen = set()
    for ids, ntok, row_bad, owners in tok.encode_batch_arrays(cases):
        for r, (i, _k) in enumerate(owners):
            seen.add(i)
            if not row_bad[r]:
                assert ids[r, :ntok[r]].tolist() == fast[i].ids
    assert seen == set(range(len(cases)))


@pytest.mark.parametrize("edit,what", [
    ({"normalizer": {"type": "NFC"}}, "BertNormalizer"),
    ({"normalizer": None}, "BertNormalizer"),
    ({"pre_tokenizer": {"type": "BertPreTokenizer", "x": 1}}, "options"),
    ({"model": {"type": "WordLevel", "vocab": {}, "unk_token": "[UNK]", "x": 1}}, "WordLevel"),
])
def test_loader_refuses_other_bert_pipelines(edit, what):
    """Once refused (`what` named the reason), now loaded and encoded on the
    general host pipeline as the wheel does, or raising where it raises
    (`torch_reference.loads_as_the_reference`)."""
    import json

    from torch_reference import loads_as_the_reference

    d = json.load(open(BERT, encoding="utf-8"))
    d.update(edit)
    loads_as_the_reference(json.dumps(d))


@pytest.mark.parametrize("edit", [
    {"truncation": {"direction": "Right", "max_length": 8, "strategy": "LongestFirst",
                    "stride": 2}},
    {"post_processor": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True}},
])
def test_loader_admits_truncation_and_other_post_processors(edit):
    """Truncation and a ByteLevel post-processor in the BERT pipeline
    (refused before the Tokenizer's full surface was ported): the wheel's
    encodings."""
    import json

    d = json.load(open(BERT, encoding="utf-8"))
    d.update(edit)
    blob = json.dumps(d)
    texts = ["Hello, World! café 中文 and more words here", "a[SEP]b", ""]
    for g, w in zip(Tokenizer.from_str(blob, device="cpu").encode_batch(texts),
                    WheelTokenizer.from_str(blob).encode_batch(texts)):
        assert (g.ids, g.tokens, g.offsets, [o.ids for o in g.overflowing]) == (
            w.ids, w.tokens, [tuple(o) for o in w.offsets], [o.ids for o in w.overflowing])


@pytest.mark.gpu
def test_gpu_dedup_matches_cpu(port):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tokenizers_tpu_torch.smoke_data import first_ascii_chunk

    _tok, eng = port
    docs = [eng._prepare(d) for d in build_docs()]
    b, n, _ = first_ascii_chunk(eng, docs, device="cpu")
    b = b.to(torch.uint8)
    got = wordpiece_dedup_core(b.cuda(), n.cuda(), Tokenizer.from_file(BERT)._get_device_engine()
                               .tables, cache=WordCache(1 << 20, 1 << 24, "cuda"))
    want = wordpiece_dedup_core(b, n, eng.tables, cache=WordCache(1 << 20, 1 << 24, "cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_gpu_entry_points_match_cpu(port):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu, _eng = port
    tok = Tokenizer.from_file(BERT)
    assert tok.device.type == "cuda"
    cases = CASES + [_long_doc()] + build_docs(400_000)[:40]
    assert [e.ids for e in tok.encode_batch_fast(cases)] == \
        [e.ids for e in cpu.encode_batch_fast(cases)]
    for fn in ("encode_batch", "encode_batch_byte_offsets"):
        for g, w in zip(getattr(tok, fn)(cases), getattr(cpu, fn)(cases)):
            assert (g.ids, g.offsets, g.tokens, g.words) == (w.ids, w.offsets, w.tokens, w.words)
