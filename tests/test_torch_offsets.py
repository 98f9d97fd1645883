"""The offsets path of the port on the CPU, bit-exact (tolerance 0: every
value is an id, a position, a count or a flag).

* `run_merge_phases(obp=...)` against the JAX package's on one small
  state: ids, word ids, the overflow flags and the carried positions.
* The offsets program (`ByteLevelBpeEngine._program_offsets`) against
  the JAX engine's on one packed [4, 256] chunk per boundary: gpt2 ASCII
  (the layout kernel's plain version), gpt2 with multi-byte characters,
  llama3 with the whole-word bypass.  The JAX program runs op by op
  (`jax.disable_jit`): its whole-program compile takes minutes here, its
  ops compile once for the three chunks.
* `Tokenizer(..., device="cpu").encode_batch` against the `tokenizers`
  wheel (ids, char offsets, tokens, word ids) on gpt2, llama3 and
  llama3_128k, with rows flagged to the host and a long document split
  into pieces; byte offsets, device and host, against the JAX package's
  host path; `process_offsets` against the JAX package's.
* `encode_batch_arrays` against `encode_batch_fast`, the entry points
  (pairs and pre-tokenized input against the wheel), and on a card
  (`gpu`) the same encodings as on the CPU.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from tokenizers import Tokenizer as WheelTokenizer

from test_torch_merge_phases import _word_layout
from test_torch_merge_round import _t
from tokenizers_tpu.ops import bpe_merge2 as jm
from tokenizers_tpu.pre_tokenizers.byte_level import process_offsets as j_process_offsets
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Encoding, Tokenizer
from tokenizers_tpu_torch.ops import bpe_merge2 as tm
from tokenizers_tpu_torch.ops import engine_base
from tokenizers_tpu_torch.ops.bpe_merge2 import WORD_CAP
from tokenizers_tpu_torch.ops.engine_base import CHUNK_TARGET
from tokenizers_tpu_torch.ops.longdoc import split_long
from tokenizers_tpu_torch.ops.packing import MAX_L
from tokenizers_tpu_torch.pre_tokenizers.byte_level import process_offsets
from tokenizers_tpu_torch.smoke_data import build_docs

GPT2 = "tests/fixtures/gpt2/tokenizer.json"
LLAMA3 = "tests/fixtures/llama3/tokenizer.json"
LLAMA3_128K = "tests/fixtures/llama3_128k/tokenizer.json"

# the ADVERSARIAL cases of tests/test_device_bpe_engine.py, then those of
# tests/test_device_llama3_engine.py
ADVERSARIAL = [
    "", " ", "  ", "   x", "x   ", "don't", "don'tt",
    "isn't it's 'twas I'll you'd we're I've 'm", "'s 't 're 've 'm 'll 'd 'S 'T",
    "''s !!'t a'la 9'9 x'll'd!!'ve", "a\tb\t\tc\nd \t e", "héllo wörld ñaña",
    "序号123 テスト中です", "123abc!!!def456", "a  b   c    d", "...---...",
    "👍👍🏽 ok  　end", "Hello, y'all! How are you 😁 ?",
    "Hello world!", "don't DON'T Don'T don'ſ it'ſ", "'s 'S 'T 'Re 'VE 'll 'LL 'd",
    "1234567 89 ０１２３４５６７８９", "a1b22c333d4444", "!!\n\nok", "x\r\ny \n\n z",
    " \n \n  tail   ", "!?!abc x!y !z", "a'la plume", "  spaced  out  ", "\t\tab\tcd",
    "<|begin_of_text|>routed to host",
]


def _long_doc():
    """A corpus document over 64 KB (MAX_L // 2) with safe seams."""
    doc = " ".join(build_docs(100_000, 1 << 12))[: MAX_L // 2 + 4000]
    assert len(split_long(doc.encode(), CHUNK_TARGET)) == 3
    return doc


CASES = ADVERSARIAL + [
    "séquence ñ 序号", "  leading spaces", "trailing spaces   ",
    "a<|endoftext|>b <|end_of_text|>", "<|begin_of_text|>x y",  # added tokens
    "w " + "x" * (WORD_CAP + 88) + " y",  # a word over WORD_CAP: to the host
    "é" * 300 + " ok",
]


def _rows(rng, strings, extra):
    """The four rows of a chunk, none over 256 bytes: the strings, every
    other one in each of two rows, then two random mixes of `extra`
    pieces."""
    rows = ["".join(strings[k::2]) for k in (0, 1)]
    rows += ["".join(rng.choice(extra, int(rng.integers(40, 250)))) for _ in range(2)]
    return [r.encode()[:256].decode(errors="ignore") for r in rows]


def _pack(rows, L=256):
    b = np.zeros((len(rows), L), np.uint8)
    n = np.zeros(len(rows), np.int32)
    for i, s in enumerate(rows):
        x = s.encode()
        b[i, : len(x)] = np.frombuffer(x, np.uint8)
        n[i] = len(x)
    return b, n


def _same_as_wheel(got, want, cases):
    for s, g, w in zip(cases, got, want):
        assert g.ids == w.ids, s
        assert g.offsets == [tuple(x) for x in w.offsets], s
        assert g.tokens == w.tokens, s
        assert g.word_ids == w.word_ids, s


@pytest.mark.parametrize("path", [GPT2, LLAMA3, LLAMA3_128K])
def test_encode_batch_matches_wheel(path):
    cases = CASES + [_long_doc()]
    tok = Tokenizer.from_file(path, device="cpu")
    engine_base.STATS.reset()
    got = tok.encode_batch(cases)
    st = engine_base.STATS.snapshot()
    # the long document ran on the device in pieces; the long word's row
    # was flagged; the added tokens' inputs went to the host first
    assert st["bad_rows"] >= 1 and st["host_pre_inputs"] >= 1
    assert st["device_rows"] == len(cases) - st["host_pre_inputs"] + 2
    _same_as_wheel(got, WheelTokenizer.from_file(path).encode_batch(cases), cases)


def test_encode_batch_with_prefix_space_matches_wheel():
    """A ByteLevel pre-tokenizer that adds a prefix space: its span is
    undone, on the device and on the host."""
    with open(GPT2) as f:
        d = json.load(f)
    d["pre_tokenizer"]["add_prefix_space"] = True
    js = json.dumps(d)
    tok = Tokenizer.from_str(js, device="cpu")
    cases = ADVERSARIAL[:20] + ["a<|endoftext|>b", "<|endoftext|>c", "w " + "x" * 600]
    assert cases[0] == ""  # no token, and no prefix space, on either path
    wheel = WheelTokenizer.from_str(js)
    _same_as_wheel(tok.encode_batch(cases), wheel.encode_batch(cases), cases)
    for s, g, w in zip(cases, tok.encode_batch_fast(cases), wheel.encode_batch_fast(cases)):
        assert g.ids == w.ids, s


def _same(got, want, cases):
    for s, g, w in zip(cases, got, want):
        assert (g.ids, g.offsets, g.tokens, g.words) == (w.ids, w.offsets, w.tokens,
                                                         w.words), s


@pytest.mark.parametrize("path", [GPT2, LLAMA3])
def test_byte_offsets_match_jax_host(path):
    """The host path with byte offsets against the JAX package's, and the
    device's against both; the long document's pieces against the host
    path alone (the JAX host path takes seconds over it)."""
    jt = JaxTokenizer.from_file(path)
    want = [jt._encode(s, None, True, "byte") for s in CASES]
    tok = Tokenizer.from_file(path, device="cpu")
    _same([tok.encode_host(s, True, offsets="byte") for s in CASES], want, CASES)
    cases = CASES + [_long_doc()]
    _same(tok.encode_batch_byte_offsets(cases),
          want + [tok.encode_host(cases[-1], True, offsets="byte")], cases)


@pytest.mark.parametrize("add_prefix_space", [True, False])
def test_process_offsets_matches_jax(add_prefix_space):
    tok = Tokenizer.from_file(GPT2, device="cpu")
    tok.post_processor = None  # untrimmed offsets
    encs = tok.encode_batch(CASES)
    rng = np.random.default_rng(3)
    tokens = ["Ġ", "ĠĠ", "Ġa", "aĠ", " a ", "　x ", "\n", "x", "ĠxĠĠ"]
    for _ in range(4):  # tokens with real whitespace, at offsets from 0
        k = int(rng.integers(1, 8))
        toks = list(rng.choice(tokens, k))
        cuts = np.cumsum(rng.integers(0, 4, k + 1))
        encs.append(Encoding(ids=list(range(k)), tokens=toks,
                             offsets=list(zip(cuts[:-1].tolist(), cuts[1:].tolist()))))
    for e in encs:
        mine, theirs = e.copy(), e.copy()
        process_offsets(mine, add_prefix_space)
        j_process_offsets(theirs, add_prefix_space)
        assert mine.offsets == theirs.offsets, (e.tokens, e.offsets)


@pytest.mark.parametrize("path", [GPT2, LLAMA3])
def test_encode_batch_arrays_matches_fast(path):
    added = "a<|endoftext|>b" if path == GPT2 else "a<|begin_of_text|>b"
    docs = build_docs(60_000, 1 << 12) + [_long_doc(), "", "héllo 序号", added]
    tok = Tokenizer.from_file(path, device="cpu")
    pieces, flagged = {}, set()
    for ids, ntok, row_bad, owners in tok.encode_batch_arrays(docs):
        for r, (i, k) in enumerate(owners):
            pieces[(i, k)] = ids[r, : ntok[r]].tolist()
            if row_bad[r]:
                flagged.add(i)
    assert sorted(k for i, k in pieces if i == len(docs) - 4) == [0, 1, 2]  # the long one
    want = tok.encode_batch_fast(docs, add_special_tokens=False)
    # the added token's input: its bytes were encoded, its special token not
    assert len(docs) - 1 in flagged and len(flagged) < len(docs) // 4
    for i, e in enumerate(want):
        if i not in flagged:
            assert sum((pieces[(j, k)] for j, k in sorted(pieces) if j == i), []) == e.ids, i
    with pytest.raises(ValueError, match="no tokenization-safe seam"):
        tok.encode_batch_arrays(["x" * (MAX_L // 2 + 1)])


def test_engine_without_offsets_takes_the_host(monkeypatch):
    """An engine with no offsets program leaves `encode_batch` to the host
    pipeline, whose encodings are the engine's."""
    tok = Tokenizer.from_file(GPT2, device="cpu")
    eng = tok._get_device_engine()
    want = tok.encode_batch(CASES)
    monkeypatch.setattr(eng, "supports_offsets", False)
    monkeypatch.setattr(eng, "_program_offsets", None)  # a call would raise
    _same(tok.encode_batch(CASES), want, CASES)


def test_entry_points():
    tok = Tokenizer.from_file(GPT2, device="cpu")
    s = "Hello, y'all! 序号"
    batch = tok.encode_batch([s])[0]
    for e in (tok.encode(s), tok.encode_char_offsets(s), tok.encode_batch_char_offsets([s])[0]):
        assert (e.ids, e.offsets, e.tokens, e.words) == (batch.ids, batch.offsets,
                                                         batch.tokens, batch.words)
    b = tok.encode_byte_offsets(s)
    assert b.offsets == tok.encode_batch_byte_offsets([s])[0].offsets != batch.offsets
    # pairs and pre-tokenized input take the host pipeline, as the wheel's
    wheel = WheelTokenizer.from_file(GPT2)
    for got, want in ((tok.encode(s, "pair"), wheel.encode(s, "pair")),
                      (tok.encode_batch([(s, "pair")])[0], wheel.encode_batch([(s, "pair")])[0]),
                      (tok.encode_batch([["pre", "tokenized"]], is_pretokenized=True)[0],
                       wheel.encode_batch([["pre", "tokenized"]], is_pretokenized=True)[0])):
        assert (got.ids, got.offsets, got.tokens, got.words, got.type_ids) == (
            want.ids, [tuple(o) for o in want.offsets], want.tokens, want.words, want.type_ids)
    assert tok.encode_byte_offsets(["pre"], is_pretokenized=True).ids == \
        wheel.encode(["pre"], is_pretokenized=True).ids


# the JAX programs last: their ops compile for most of this file's time


def _chunk(case):
    """[4, 256]: the JAX program's ops compile once per shape, and a fourth
    of them at 4 rows against 8 (the ladder then has one rung, not two)."""
    rng = np.random.default_rng(11)
    if case == "gpt2_ascii":
        # random punctuation rows overflow the 5/8 width: flagged
        rows = _rows(rng, [s for s in ADVERSARIAL if s.isascii()],
                     list("!@#$%^&*()[]{}<>~`|\\/?;:") + ["the ", "don't ", "123", "  "])
    elif case == "gpt2_utf8":
        rows = _rows(rng, [s for s in CASES if not s.isascii()],
                     ["é", "序号", "ñ", "👍", " ", "ab", "　"])
    else:
        rows = _rows(rng, ADVERSARIAL[18:], ["Hello", " world", "'s", "123456", "\r\n", " "])
    return _pack(rows)


@pytest.mark.parametrize("case,path", [
    ("gpt2_ascii", GPT2), ("gpt2_utf8", GPT2), ("llama3", LLAMA3)])
def test_offsets_program_matches_jax(case, path):
    b, n = _chunk(case)
    assert (int(b.max()) < 128) == (case == "gpt2_ascii")
    with jax.disable_jit():
        want = JaxTokenizer.from_file(path)._get_device_engine()._program_offsets(b, n)
    eng = Tokenizer.from_file(path, device="cpu")._get_device_engine()
    assert eng.supports_offsets and eng.tables["whole_word"] == (case == "llama3")
    got = eng._program_offsets(b, n)
    names = ("ids", "ntok", "row_bad", "starts", "ends", "word ids")
    for name, g, w in zip(names, got, want):
        assert g.dtype == (torch.bool if name == "row_bad" else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if case == "gpt2_ascii":
        assert got[2].any() and not got[2].all()


def test_run_merge_phases_obp_matches_jax():
    """On gpt2's merge table, at the programs' shapes (their ops are
    compiled already)."""
    T = Tokenizer.from_file(GPT2, device="cpu")._get_device_engine().tables
    tabs = [T[k].numpy() for k in ("merge_rows0", "merge_rows1", "merge_mclr")]
    rng = np.random.default_rng(8)
    ids, wid = _word_layout(rng, 4, 256, 256)
    ids = np.where(ids >= 0, T["byte2id"].numpy()[np.maximum(ids, 0)], -1)
    obp = np.sort(rng.integers(0, 1 << 20, (4, 256)), axis=1).astype(np.int32)
    with jax.disable_jit():
        want = jm.run_merge_phases(
            jnp.asarray(ids), jnp.asarray(wid), jnp.asarray(tabs[0]), jnp.asarray(tabs[1]),
            jnp.int32(T["seed"]), jnp.asarray(tabs[2]), obp=jnp.asarray(obp))
    args = (_t(ids), _t(wid), _t(tabs[0]), _t(tabs[1]), T["seed"], _t(tabs[2]))
    got = tm.run_merge_phases(*args, obp=_t(obp))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() >= 256).any()  # merges happened
    assert len(tm.run_merge_phases(*args)) == 3  # the fast path's signature


@pytest.mark.gpu
@pytest.mark.parametrize("path", [GPT2, LLAMA3_128K])
def test_gpu_offsets_match_cpu(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = CASES + [_long_doc()] + build_docs(400_000)[:40]
    cpu = Tokenizer.from_file(path, device="cpu")
    tok = Tokenizer.from_file(path)
    assert tok.device.type == "cuda"
    for fn in ("encode_batch", "encode_batch_byte_offsets"):
        _same(getattr(tok, fn)(cases), getattr(cpu, fn)(cases), cases)
    for case in ("gpt2_ascii", "gpt2_utf8") if path == GPT2 else ("llama3",):
        b, n = _chunk(case)
        for g, w in zip(tok._get_device_engine()._program_offsets(b, n),
                        cpu._get_device_engine()._program_offsets(b, n)):
            assert torch.equal(g.cpu(), w)
