"""The Unigram (SentencePiece) path of the port on the CPU, bit-exact
(tolerance 0: ids, positions, counts, hashes, flags and the bits of every
f32 and f64 value).

* `serde_f64` on every score of both fixtures, against the JAX package's;
  Nmt and the `" {2,}"` Replace (text and alignments) and the host
  `Unigram` (ids, spans, token strings) against the JAX package's.
* `normalize_metaspace` with and without source chars,
  `byte_fallback_expand`, `dd_add`, `dd_gt`, `dd_split` and the class
  table against the JAX functions; the engine's tables against the JAX
  engine's, array for array.
* `unigram_dedup_scan` (two passes, the second on the first's word cache,
  with an epoch reset) with its cache state and patch tables, and
  `unigram_program_packed` with offsets, against the JAX programs on
  [24, 256] chunks of the cases of `tests/test_unigram_dedup.py::_lines()`
  (the 200-byte word that becomes a patch record, CJK, mixed text,
  repeated words) plus `'Ve'll....`, whose Viterbi comparison is a near
  tie that the compensated-f32 DP flags for the host.  The JAX programs
  are compiled whole with fusion off and LLVM at its lowest level
  (`_jax_compiled`): every op its own loop, as op by op, in about 15 s a
  program where the default compile takes 30-60 s here and op by op
  (`jax.disable_jit`) several minutes of per-op compiles.  Op by op the
  JAX programs gave the same bits.
* `Tokenizer(..., device="cpu")` on `unigram` and `unigram_bf` against
  the `tokenizers` wheel: `encode_batch_fast` ids and `encode_batch` ids,
  char offsets, tokens and word ids, on control chars, runs of spaces and
  tabs, an empty input, an added token, unknown chars, CJK, corpus lines,
  near ties and a 100 KB document split into pieces; byte offsets
  against the JAX package's host path.
* On a card (`gpu`): the dedup and packed programs on a corpus chunk and
  the entry points, equal to their CPU runs.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.normalized import NormalizedString as JaxNormalizedString
from tokenizers_tpu.ops import unigram_dedup as jd
from tokenizers_tpu.ops import unigram_encode as je_mod
from tokenizers_tpu.ops.unigram_packed import unigram_program_packed as j_packed
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu.utils.serde_float import serde_f64 as j_serde
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.normalized import NormalizedString
from tokenizers_tpu_torch.ops import engine_base
from tokenizers_tpu_torch.ops import unigram_dedup as td
from tokenizers_tpu_torch.ops import unigram_encode as te_mod
from tokenizers_tpu_torch.ops.bpe_dedup import WordCache
from tokenizers_tpu_torch.ops.engine_base import CHUNK_TARGET
from tokenizers_tpu_torch.ops.longdoc import split_long
from tokenizers_tpu_torch.ops.unigram_engine import UnigramEngine
from tokenizers_tpu_torch.ops.unigram_packed import unigram_program_packed
from tokenizers_tpu_torch.utils.serde_float import serde_f64

UNIGRAM = "tests/fixtures/unigram/tokenizer.json"
UNIGRAM_BF = "tests/fixtures/unigram_bf/tokenizer.json"
FIXTURES = (UNIGRAM, UNIGRAM_BF)
TIE = "'Ve'll...."

# whole-program compiles with every op its own loop (see the docstring)
_OPTS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True,
         "xla_disable_hlo_passes": "fusion,cpu-instruction-fusion,horizontal-loop-fusion"}


def _jax_compiled(fn, args, static, dynamic):
    """`fn` lowered at `args` (+ keyword `static` and `dynamic`) and
    compiled with _OPTS; called with `args` and `dynamic` only."""
    return fn.lower(*args, **static, **dynamic).compile(compiler_options=_OPTS)


def _lines():
    """tests/test_unigram_dedup.py::_lines(), then the near tie."""
    lines = [ln for ln in open("tests/fixtures/corpus.txt", encoding="utf-8").read().split("\n")
             if ln][:32]
    return lines + ["", "   ", "hello world", "a", "ninety-nine bottles", "日本語のテキストです",
                    "mixed 日本語 and english", "x" * 200, "the the the the the the", TIE]


NORM_CASES = [
    "", " ", "   ", "a   b", " lead", "trail  ", "tabs\t\tand\nnew\r\nlines", "\x01\x02ctl\x7f x",
    "a \x01 b", "  \x0b  x", "　wide　 space", "l s p﻿z�q", "x​‍y",
    "▁meta ▁ x", "naïve café ﬁle", "日本語 のテキスト", "🙂 🙂🙂  e", "\x1f\x1f", " \t \x1e \t ",
    "a \x01 \x02  b", "\u2028\u2029 x\u3000 \u3000y", " \x01", "\x01 ", "x \x7f\t\x0b\n y",
]
CASES = NORM_CASES + _lines() + [
    "a<unk>b", "<unk>", "x <unk>  y", "☃☃ ❄ snow", "͸͹ unassigned", "ǅ ǈ title",
    "Ünïcödé  àccents", "don't stop-believing 12345 $x.y",
]


def _pack(strings, L):
    rows = [s.encode() for s in strings]
    assert all(len(r) <= L for r in rows)
    b = np.zeros((len(rows), L), np.uint8)
    for i, r in enumerate(rows):
        b[i, :len(r)] = np.frombuffer(r, np.uint8)
    return b, np.array([len(r) for r in rows], np.int32)


def _long_doc():
    """About 100 KB, split into <= 32 KB pieces at safe seams, with
    multi-byte chars so the pieces re-base in chars."""
    text = " ".join(_lines()[:32]) + " café 日本語  x\t"
    while len(text.encode()) < 100_000:
        text = text + " " + text
    doc = text.encode()[:100_000].decode("utf-8", "ignore")
    assert len(split_long(doc.encode(), CHUNK_TARGET)) > 2
    return doc


@pytest.fixture(scope="module", params=FIXTURES, ids=["unigram", "unigram_bf"])
def pair(request):
    jtok = JaxTokenizer.from_file(request.param)
    tok = Tokenizer.from_file(request.param, device="cpu")
    assert isinstance(tok._get_device_engine(), UnigramEngine)
    return request.param, jtok, jtok._get_device_engine(), tok, tok._get_device_engine()


@pytest.fixture(scope="module")
def plain():
    """The unigram fixture (no byte fallback): JAX and port engines."""
    jtok = JaxTokenizer.from_file(UNIGRAM)
    tok = Tokenizer.from_file(UNIGRAM, device="cpu")
    return jtok, jtok._get_device_engine(), tok, tok._get_device_engine()


# ---- host side -------------------------------------------------------------

@pytest.mark.parametrize("path", FIXTURES)
def test_serde_f64_matches_jax(path):
    """Every score literal of the fixture parses to the JAX package's bits,
    and the port's loader holds them; over 100 of unigram's differ from
    Python's correctly rounded float."""
    text = open(path, encoding="utf-8").read()
    lits = []
    json.loads(text, parse_float=lambda s: lits.append(s) or 0.0)
    assert len(lits) >= 8000
    got = np.array([serde_f64(s) for s in lits])
    want = np.array([j_serde(s) for s in lits])
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    if path == UNIGRAM:  # unigram_bf's literals were written from serde's values
        assert int((got != np.array([float(s) for s in lits])).sum()) > 100
    pieces = Tokenizer.from_file(path, device="cpu").model.pieces
    jvocab = JaxTokenizer.from_file(path).model.vocab
    assert [p for p, _ in pieces] == [p for p, _ in jvocab]
    assert np.array_equal(np.array([s for _, s in pieces]).view(np.int64),
                          np.array([s for _, s in jvocab]).view(np.int64))


def test_nmt_collapse_matches_jax():
    """Nmt then Replace(" {2,}" -> " "): normalized text and byte
    alignments on NormalizedString, and normalize_str."""
    tok, jtok = Tokenizer.from_file(UNIGRAM, device="cpu"), JaxTokenizer.from_file(UNIGRAM)
    for s in CASES:
        ns, jns = NormalizedString(s), JaxNormalizedString(s)
        tok.normalizer.normalize(ns)
        jtok.normalizer.normalize(jns)
        assert (ns.get(), ns.alignments) == (jns.normalized, [tuple(a) for a in jns.alignments]), s
        assert tok.normalizer.normalize_str(s) == ns.get(), s


@pytest.mark.parametrize("path", FIXTURES)
def test_host_unigram_matches_jax(path):
    """The host model on Metaspace words: ids, byte spans and token
    strings, the near tie, unknown chars and byte fallback included."""
    model = Tokenizer.from_file(path, device="cpu").model
    jmodel = JaxTokenizer.from_file(path).model
    assert (model.unk_id, model.min_score, model.byte_fallback) == \
        (jmodel.unk_id, jmodel.min_score, jmodel.byte_fallback)
    words = ["▁" + w for s in CASES for w in s.replace("\t", " ").split(" ") if w] + [
        "▁" + TIE, "▁☃☃❄", "▁", "▁▁", "x" * 70, "▁͸"]
    for w in words:
        want = [(t.id, t.offsets[0], t.offsets[1], t.value) for t in jmodel.tokenize(w)]
        assert model.tokenize_spans(w) == want, w
        assert model.tokenize_ids(w) == [t[0] for t in want]
        assert [(t.id, t.offsets[0], t.offsets[1], t.value) for t in model.tokenize(w)] == want


# ---- device functions --------------------------------------------------------

def test_class_table_matches_jax():
    for g, w in zip(te_mod.nmt_metaspace_class_table(), je_mod.nmt_metaspace_class_table()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for name in ("CLS_KEEP", "CLS_SPACE", "CLS_DELETE", "MAX_TOKENS_PER_WORD"):
        assert getattr(te_mod, name) == getattr(je_mod, name)
    assert te_mod.NEG == je_mod.NEG and te_mod.NEG.dtype == je_mod.NEG.dtype


@pytest.mark.parametrize("path", FIXTURES)
def test_engine_tables_match_jax(path):
    je = JaxTokenizer.from_file(path)._get_device_engine()
    T = Tokenizer.from_file(path, device="cpu")._get_device_engine().tables
    for k, jk in (("vrows0", "d_vrows8_0"), ("vrows1", "d_vrows8_1"), ("cls_s1", "d_cls_s1"),
                  ("cls_s2", "d_cls_s2"), ("pow1", "d_pow1"), ("pow2", "d_pow2")):
        got, want = T[k], np.asarray(getattr(je, jk))
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    with jax.enable_x64():
        vscore = np.asarray(je.d_vscore)
    assert T["vscore"].dtype == torch.float64
    assert np.array_equal(T["vscore"].numpy().view(np.int64), vscore.view(np.int64))
    assert (T["unk_id"], T["vseed"], T["max_len"]) == (int(je.unk_id), int(je.vseed), je.max_len)
    assert np.float64(T["unk_score"]) == je.unk_score
    assert (np.float32(T["unk_hi"]), np.float32(T["unk_lo"])) == (je.unk_hi, je.unk_lo)
    assert (T["bf_tab"] is None) == (je.d_bf is None)
    if je.d_bf is not None:
        assert np.array_equal(T["bf_tab"].numpy(), np.asarray(je.d_bf))


@pytest.mark.parametrize("with_src", [False, True])
def test_normalize_metaspace_matches_jax(plain, with_src):
    """On [32, 64] rows of the normalizer cases: normalized bytes, word
    starts, in-row mask, lengths, row flags and source chars."""
    _jtok, je, _tok, eng = plain
    cases = (NORM_CASES + ["a" * 64, " " * 64, "\t x" * 21, "日本語" * 7])[:32]
    b, n = _pack(cases + [""] * (32 - len(cases)), 64)
    T = eng.tables
    fn = jax.jit(je_mod.normalize_metaspace, static_argnames=("with_src",))
    want = _jax_compiled(fn, (b, n, je.d_cls_s1, je.d_cls_s2), {"with_src": with_src}, {})(
        b, n, je.d_cls_s1, je.d_cls_s2)
    got = te_mod.normalize_metaspace(torch.from_numpy(b), torch.from_numpy(n), T["cls_s1"],
                                     T["cls_s2"], with_src)
    assert (got[5] is None) == (not with_src)
    for name, g, w in zip(("nb", "wbnd", "ninb", "total", "row_bad", "src_char"), got, want):
        if g is None:
            continue
        assert str(g.dtype).split(".")[-1] == str(np.asarray(w).dtype), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[1].sum()) > 40 and int(got[4].sum()) == 0


def test_byte_fallback_expand_matches_jax():
    """On random emissions, spans, ids and bytes ([6, 97] boundaries)."""
    rng = np.random.default_rng(11)
    R, C, K, unk = 6, 96, 5, 0
    emit = rng.random((R, C + 1)) < 0.4
    jlen = rng.integers(0, K + 1, (R, C + 1)).astype(np.int32)
    node_id = np.where(rng.random((R, C + 1)) < 0.3, unk,
                       rng.integers(1, 500, (R, C + 1))).astype(np.int32)
    nb = rng.integers(0, 256, (R, C)).astype(np.int32)
    inb = np.arange(C)[None, :] < rng.integers(C // 2, C + 1, (R, 1))
    bf = rng.permutation(256).astype(np.int32) + 1000
    fn = jax.jit(je_mod.byte_fallback_expand, static_argnames=("unk_id", "K"))
    jargs = (emit, jlen, node_id, unk, bf, nb, inb, K)
    want = _jax_compiled(fn, jargs[:3], {"unk_id": unk, "K": K},
                         dict(bf_tab=bf, nb=nb, inb=inb))(*jargs[:3], bf_tab=bf, nb=nb, inb=inb)
    got = te_mod.byte_fallback_expand(*(torch.from_numpy(x) for x in (emit, jlen, node_id)), unk,
                                      torch.from_numpy(bf), torch.from_numpy(nb),
                                      torch.from_numpy(inb), K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[0] >= 1000).sum()) > 20


def test_dd_arith_matches_jax():
    """dd_add, dd_gt on random f32 (hi, lo) pairs of many magnitudes, near
    equal ones included, and dd_split on random f64: bit for bit."""
    rng = np.random.default_rng(5)
    n = 20000
    x = -np.exp(rng.uniform(-5, 6, (4, n))) * rng.choice([1, -1], (4, n), p=[0.9, 0.1])
    h = x[:2].astype(np.float32)
    lo = (x[2:] * 1e-8).astype(np.float32)
    h[1, :5000] = h[0, :5000]  # equal heads: the low words decide
    h[1, 5000:8000] = np.nextafter(h[0, 5000:8000], np.float32(0))
    args = (h[0], lo[0], h[1], lo[1])
    gs, ge = td.dd_add(*(torch.from_numpy(a) for a in args))
    ws, we = jd.dd_add(*(jnp.asarray(a) for a in args))
    for g, w in ((gs, ws), (ge, we)):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))
    np.testing.assert_array_equal(td.dd_gt(*(torch.from_numpy(a) for a in args)).numpy(),
                                  np.asarray(jd.dd_gt(*(jnp.asarray(a) for a in args))))
    x64 = rng.normal(0, 30, 5000)
    for g, w in zip(td.dd_split(x64), jd.dd_split(x64)):
        assert np.array_equal(g.view(np.int32), w.view(np.int32))
    assert (td.UD_UC, td.UD_SLACK, td.PATCH_CAP, td.TIE_EPS_REL) == \
        (jd.UD_UC, jd.UD_SLACK, jd.PATCH_CAP, jd.TIE_EPS_REL)
    for bl in (1 << 10, 24 * 516, 256 * 16388, 1 << 22):
        assert td.unigram_geometry(bl) == jd.unigram_geometry(bl)


def _dedup_chunks():
    """The lines in two [24, 256] chunks (the second holds the 200-byte
    word and the near tie)."""
    rows = _lines() + [""] * (48 - len(_lines()))
    b0, n0 = _pack(rows[:24], 256)
    b1, n1 = _pack(rows[24:], 256)
    return np.stack([b0, b1]), np.stack([n0, n1])


def test_dedup_scan_matches_jax(plain):
    """Two passes of the cached scan, the second reading the first's
    cache and resetting its epoch: ids, ntok, row_bad, patch tables and
    counts, and the cache state, bit for bit against the JAX scan; the
    patch records hold the 200-byte word and the near tie."""
    _jtok, je, _tok, eng = plain
    bufs, lens = _dedup_chunks()
    slots, cap = 1 << 12, 3400  # a token buffer this small resets in pass 2
    jst = (jnp.zeros((slots, 4), jnp.int32), jnp.full((cap + 1,), -1, jnp.int32), jnp.int32(0))
    args = je._dedup_args()
    static = {"max_len": args.pop("max_len"), "word_cache": True}
    dyn = dict(cache_rows=jst[0], cache_buf=jst[1], cache_p=jst[2], **args)
    j_scan = _jax_compiled(jd.unigram_dedup_scan, (bufs, lens), static, dyn)
    cache = WordCache(slots, cap, "cpu")
    names = ("ids", "ntok", "row_bad", "patch_tab", "n_patch")
    p_seen = []
    for pass_ in range(2):
        *want, jst = j_scan(bufs, lens, **dict(dyn, cache_rows=jst[0], cache_buf=jst[1],
                                               cache_p=jst[2]))
        got = td.unigram_dedup_scan(torch.from_numpy(bufs), torch.from_numpy(lens), eng.tables,
                                    cache=cache)
        for name, g, w in zip(names, got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {pass_}")
        np.testing.assert_array_equal(cache.rows.numpy(), np.asarray(jst[0]))
        np.testing.assert_array_equal(cache.buf.numpy(), np.asarray(jst[1]))
        assert cache.p == int(jst[2])
        if pass_ == 0:
            first = got
    assert not got[2].any() and got[4].tolist() == [0, 2]
    # both passes chunk by chunk through the core: the second pass's first
    # chunk resets the epoch
    cache2 = WordCache(slots, cap, "cpu")
    for pass_out in (first, got):
        for k in range(2):
            out = td.unigram_dedup_core(torch.from_numpy(bufs[k]), torch.from_numpy(lens[k]),
                                        eng.tables, cache=cache2)
            for g, w in zip(out[:4], pass_out[:4]):
                np.testing.assert_array_equal(g.numpy(), w[k].numpy())
            assert out[4] == int(pass_out[4][k])
            p_seen.append(cache2.p)
    assert p_seen[2] < p_seen[1] and cache2.p == cache.p
    recs = got[3][1, :2].tolist()
    stream = eng._norm_stream(_lines()[24 + recs[0][0]].encode())
    assert stream[recs[0][1]:recs[0][1] + recs[0][2]] == "▁".encode() + b"x" * 200
    assert eng._norm_stream(TIE.encode())[recs[1][1]:][:recs[1][2]].decode() == "▁" + TIE


def test_unique_encoder_near_ties_match_jax(plain):
    """The encoder alone on the second chunk's unique buffer: ids and the
    near-tie flag of every position equal JAX's (word for word), and the
    flag is set on the tie's word only."""
    _jtok, je, _tok, eng = plain
    bufs, lens = _dedup_chunks()
    from tokenizers_tpu_torch.ops.bpe_dedup import dedup_layout, unique_buffer
    from tokenizers_tpu_torch.ops.bpe_merge2 import _rev_cummin, _shift_next

    T = eng.tables
    nb, wbnd, ninb, total, _bad, _src = te_mod.normalize_metaspace(
        torch.from_numpy(bufs[1]), torch.from_numpy(lens[1]), T["cls_s1"], T["cls_s2"], False)
    npos = torch.arange(nb.shape[1], dtype=torch.int32).expand(nb.shape)
    nxt = torch.minimum(_shift_next(_rev_cummin(torch.where(wbnd, npos, td.BIGP)), td.BIGP),
                        total[:, None])
    geom = td.unigram_geometry(nb.numel())
    _fits, ops = dedup_layout(nb, wbnd, ninb, total, nxt, T["vseed"], geom,
                              max_wlen=td.UD_SLACK)
    ubuf = unique_buffer(ops, nb, geom)
    rows = int(ubuf[2].any(1).nonzero().max()) + 1
    ubuf = [x[:rows] for x in ubuf]
    got = td.unigram_unique_encoder(T)(*ubuf)
    enc = jax.jit(jd.unigram_unique_encoder(*(je._dedup_args()[k] for k in (
        "vrows0", "vrows1", "vseed", "pow1", "pow2", "unk_id", "unk_hi", "unk_lo",
        "max_len"))))
    jargs = [jnp.asarray(x.numpy()) for x in ubuf]
    want = _jax_compiled(enc, jargs, {}, {})(*jargs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    near, wid = got[2], ubuf[3]
    flagged = set(wid[near].tolist())
    assert len(flagged) == 1
    word = bytes(ubuf[0][wid == flagged.pop()].tolist())
    assert word.decode() == "▁" + TIE


def test_packed_matches_jax(plain):
    """The packed f64 program with offsets on the lines at [48, 256]: ids,
    ntok, row_bad, start and end chars and word ranks; and without offsets
    its first three outputs."""
    _jtok, je, _tok, eng = plain
    b, n = _pack(_lines() + [""] * (48 - len(_lines())), 256)
    with jax.enable_x64():
        dyn = dict(cls_s1=je.d_cls_s1, cls_s2=je.d_cls_s2, vkey_a=je.d_vkey_a,
                   vkey_b=je.d_vkey_b, vlen=je.d_vlen, vid=je.d_vid, vscore=je.d_vscore,
                   vseed=je.vseed, pow1=je.d_pow1, pow2=je.d_pow2, unk_id=je.unk_id,
                   unk_score=je.unk_score)
        want = _jax_compiled(j_packed, (b, n), {"max_len": je.max_len, "with_offsets": True},
                             dyn)(b, n, **dyn)
        want = [np.asarray(w) for w in want]
    bt, nt = torch.from_numpy(b), torch.from_numpy(n)
    got = unigram_program_packed(bt, nt, eng.tables, with_offsets=True)
    names = ("ids", "ntok", "row_bad", "st_char", "en_char", "word_idx")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for g, w in zip(unigram_program_packed(bt, nt, eng.tables), want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert not got[2].any() and int(got[1].sum()) > 512  # more than one compacted row


# ---- the engine against the wheel -------------------------------------------

def _same(got, want, cases):
    for s, g, w in zip(cases, got, want):
        assert (g.ids, g.offsets, g.tokens, g.words) == \
            (w.ids, [tuple(x) for x in w.offsets], w.tokens, w.word_ids), repr(s)[:80]


def test_engine_matches_wheel(pair):
    """encode_batch_fast ids and encode_batch ids, char offsets, tokens and
    word ids, on every case and a 100 KB document; the host pipeline
    alone on the cases; byte offsets against the JAX host path."""
    path, jtok, _je, tok, _eng = pair
    wheel = WheelTokenizer.from_file(path)
    cases = CASES + [_long_doc()]
    want = wheel.encode_batch(cases, add_special_tokens=True)
    engine_base.STATS.reset()
    assert [e.ids for e in tok.encode_batch_fast(cases)] == [e.ids for e in want]
    st = engine_base.STATS.snapshot()
    assert st["host_pre_inputs"] == 3 and st["patched_words"] >= 2 and st["bad_rows"] == 0
    _same(tok.encode_batch(cases), want, cases)
    _same([tok.encode_host(s, True, offsets="char") for s in CASES], want, CASES)
    assert [tok.encode_host(s).ids for s in CASES] == [e.ids for e in want[:len(CASES)]]
    for s, g in zip(CASES, tok.encode_batch_byte_offsets(CASES)):
        w = jtok._encode(s, None, True, "byte")
        assert (g.ids, g.offsets, g.tokens, g.words) == (w.ids, w.offsets, w.tokens, w.words), s


def test_encode_batch_arrays(plain):
    _jtok, _je, tok, _eng = plain
    cases = _lines() + ["a<unk>b"]
    fast = tok.encode_batch_fast(cases, add_special_tokens=False)
    seen = set()
    flagged = set()
    for ids, ntok, row_bad, owners in tok.encode_batch_arrays(cases):
        for r, (i, _k) in enumerate(owners):
            seen.add(i)
            if row_bad[r]:
                flagged.add(cases[i])
            else:
                assert ids[r, :ntok[r]].tolist() == fast[i].ids
    assert seen == set(range(len(cases)))
    # the rows with patch records (the long word, the near tie) and the
    # added token's are flagged
    assert flagged == {"x" * 200, TIE, "a<unk>b"}


@pytest.mark.parametrize("edit,what", [
    ({"pre_tokenizer": {"type": "Whitespace"}}, "Metaspace"),
    ({"pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                        "split": True}}, "Metaspace"),
    ({"normalizer": {"type": "Replace", "pattern": {"Regex": "\\s+"}, "content": " "}},
     "Replace"),
    ({"pre_tokenizer": {"type": "Metaspace", "replacement": "_", "prepend_scheme": "always",
                        "split": True}}, "replacement"),
])
def test_loader_refuses_other_unigram_pipelines(edit, what):
    """Once refused (`what` named the reason), now loaded and encoded on the
    general host pipeline as the wheel does
    (`torch_reference.loads_as_the_reference`)."""
    from torch_reference import loads_as_the_reference

    d = json.load(open(UNIGRAM, encoding="utf-8"))
    d.update(edit)
    loads_as_the_reference(json.dumps(d))


def test_loader_admits_a_byte_level_post_processor():
    """A ByteLevel post-processor behind Metaspace (refused before the
    Tokenizer's full surface was ported) trims offsets as the wheel's."""
    d = json.load(open(UNIGRAM, encoding="utf-8"))
    d["post_processor"] = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                           "use_regex": True}
    blob = json.dumps(d)
    texts = ["Hello  world! café", " x y", ""]
    for g, w in zip(Tokenizer.from_str(blob, device="cpu").encode_batch(texts),
                    WheelTokenizer.from_str(blob).encode_batch(texts)):
        assert (g.ids, g.tokens, g.offsets) == (w.ids, w.tokens, [tuple(o) for o in w.offsets])


def test_engine_refusals_take_the_host():
    """Pipelines the loader admits but the engine does not: another
    normalizer, byte fallback without every byte piece.  The host path
    still gives the wheel's ids."""
    d = json.load(open(UNIGRAM_BF, encoding="utf-8"))
    d["model"]["vocab"] = [v for v in d["model"]["vocab"] if v[0] != "<0x41>"]
    d2 = json.load(open(UNIGRAM, encoding="utf-8"))
    d2["normalizer"] = {"type": "Lowercase"}
    for dd in (d, d2):
        s = json.dumps(dd)
        tok = Tokenizer.from_str(s, device="cpu")
        assert tok._get_device_engine() is None
        cases = ["Hello  World", "☃ A"]
        assert [e.ids for e in tok.encode_batch_fast(cases)] == \
            [e.ids for e in WheelTokenizer.from_str(s).encode_batch(cases)]


# ---- on a card ----------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("path", FIXTURES)
def test_gpu_programs_match_cpu(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tokenizers_tpu_torch.smoke_data import build_docs

    cpu = Tokenizer.from_file(path, device="cpu")._get_device_engine()
    gpu = Tokenizer.from_file(path)._get_device_engine()
    b, n = _pack(build_docs()[:64], 8192)
    got = td.unigram_dedup_core(torch.from_numpy(b).cuda(), torch.from_numpy(n).cuda(),
                                gpu.tables, cache=WordCache(1 << 20, 1 << 24, "cuda"))
    want = td.unigram_dedup_core(torch.from_numpy(b), torch.from_numpy(n), cpu.tables,
                                 cache=WordCache(1 << 20, 1 << 24, "cpu"))
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g.cpu(), w)
    assert got[4] == want[4]
    b, n = _pack(build_docs()[:16], 8192)
    for g, w in zip(gpu._program_offsets(b, n), cpu._program_offsets(b, n)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("path", FIXTURES)
def test_gpu_entry_points_match_cpu(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tokenizers_tpu_torch.smoke_data import build_docs

    cpu = Tokenizer.from_file(path, device="cpu")
    tok = Tokenizer.from_file(path)
    assert tok.device.type == "cuda"
    cases = CASES + [_long_doc()] + build_docs(400_000)[:40]
    assert [e.ids for e in tok.encode_batch_fast(cases)] == \
        [e.ids for e in cpu.encode_batch_fast(cases)]
    for fn in ("encode_batch", "encode_batch_byte_offsets"):
        for g, w in zip(getattr(tok, fn)(cases), getattr(cpu, fn)(cases)):
            assert (g.ids, g.offsets, g.tokens, g.words) == (w.ids, w.offsets, w.tokens, w.words)
