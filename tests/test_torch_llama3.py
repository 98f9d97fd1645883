"""The llama-3 slice of the port on the CPU, bit-exact (tolerance 0: every
value is an integer id, count, flag or hash).

* `llama3_boundaries`, ASCII and UTF-8, against the JAX package's on the
  adversarial strings and fuzz pieces of tests/test_device_llama3_engine.py
  and on random mixes of every character class.
* The whole-word (`ignore_merges`) ids of the full-width branch against the
  JAX program's `make_ids0`, whose body is copied below because it is a
  closure inside `_encode_core`.
* `encode_program_scan(boundary="llama3", whole_word=True)` against the JAX
  program at [2, 16, 256] with the small llama3 fixture's tables: ids,
  ntok, row_bad and the word-cache state after every call, over cache hits,
  a chunk that overflows the dedup buffer into the full-width branch, and
  the epoch reset.  This is the file's one whole-program JAX compile, so
  the forced big-bucket branch (host rows) is checked on the port alone.
* `Tokenizer.encode_batch_fast(device="cpu")` against the `tokenizers`
  wheel on llama3 and llama3_128k, with and without special tokens; the
  large inputs run on llama3_128k only, to keep the file's time down.
* The loader's refusals of what it does not honour.
"""

import json
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.ops.bpe_encode import encode_program_scan as jax_scan
from tokenizers_tpu.ops.bpe_encode import take256 as j_take256
from tokenizers_tpu.ops.llama3_presplit import llama3_boundaries as j_llama3_boundaries
from tokenizers_tpu.ops.merge_table import hash_jnp
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.ops import engine_base
from tokenizers_tpu_torch.ops import bpe_encode as te
from tokenizers_tpu_torch.ops.bpe_dedup import WordCache
from tokenizers_tpu_torch.ops.bpe_engine import tables_from_numpy
from tokenizers_tpu_torch.ops.layout_kernels import next_boundary
from tokenizers_tpu_torch.ops.llama3_presplit import llama3_boundaries
from tokenizers_tpu_torch.ops.unicode_tables import char_class_flat
from tokenizers_tpu_torch.smoke_data import build_docs

LLAMA3 = "tests/fixtures/llama3/tokenizer.json"
LLAMA3_128K = "tests/fixtures/llama3_128k/tokenizer.json"

ADVERSARIAL = [
    "", " ", "Hello world!", "don't DON'T Don'T don'ſ it'ſ",
    "'s 'S 'T 'Re 'VE 'll 'LL 'd", "1234567 89 ０１２３４５６７８９",
    "a1b22c333d4444", "!!\n\nok", "x\r\ny \n\n z", " \n \n  tail   ",
    "!?!abc x!y !z", "a'la plume", "序号123 テスト中です", "  spaced  out  ",
    "\t\tab\tcd", "<|begin_of_text|>routed to host",
]


def _fuzz():
    """The fuzz cases of tests/test_device_llama3_engine.py."""
    random.seed(11)
    pieces = list("ab XY z19'.!ñ序\t\n\r") + [
        "'s", "'Ve", "  ", "...", "don't", "123456", "ſ", "\r\n", "!!\n"]
    return ["".join(random.choice(pieces) for _ in range(random.randint(0, 30)))
            for _ in range(100)]


def _mix(ascii_only):
    """Random strings over every character class: letters, digits (ASCII,
    Arabic-Indic, fullwidth), space, tab, CR, LF, NBSP and ideographic
    space, punctuation, apostrophes and contraction letters of both cases,
    U+017F, CJK and an emoji."""
    pool = list("aZsStTdDmMlLrReEvV059 \t\r\n'.!-") + ["'s", "'LL", "\r\n", "  "]
    if not ascii_only:
        pool += ["é", "ſ", "序", "٣", "０", "\xa0", "　", "😀", "'ſ", "ñ"]
    rng = random.Random(5 if ascii_only else 6)
    return ["".join(rng.choice(pool) for _ in range(rng.randint(0, 60)))
            for _ in range(96)]


def _pack(strings, L=256, rows=128):
    bs = [s.encode("utf-8") for s in strings]
    assert len(bs) <= rows and max(map(len, bs)) <= L
    b = np.zeros((rows, L), np.int32)
    for i, x in enumerate(bs):
        b[i, : len(x)] = np.frombuffer(x, np.uint8)
    n = np.array([len(x) for x in bs] + [0] * (rows - len(bs)), np.int32)
    return b, np.arange(L)[None, :] < n[:, None]


j_boundaries = jax.jit(j_llama3_boundaries, static_argnames=("ascii_only",))


@pytest.mark.parametrize("case,ascii_only", [
    ("adversarial", False), ("fuzz", False), ("mix", False),
    ("adversarial", True), ("fuzz", True), ("mix", True)])
def test_llama3_boundaries_match_jax(case, ascii_only):
    strings = {"adversarial": ADVERSARIAL, "fuzz": _fuzz(),
               "mix": _mix(ascii_only)}[case]
    if ascii_only:
        strings = [s for s in strings if s.isascii()]
    b, inb = _pack(strings)
    cls = char_class_flat()
    want_bnd, want_start = j_boundaries(jnp.asarray(b), jnp.asarray(inb),
                                        jnp.asarray(cls), ascii_only=ascii_only)
    got_bnd, got_start = llama3_boundaries(torch.from_numpy(b), torch.from_numpy(inb),
                                           torch.from_numpy(cls), ascii_only=ascii_only)
    np.testing.assert_array_equal(got_bnd.numpy(), np.asarray(want_bnd))
    np.testing.assert_array_equal(got_start.numpy(), np.asarray(want_start))


@pytest.fixture(scope="module")
def jax_args():
    """The JAX engine's tables for the small llama3 fixture."""
    args = JaxTokenizer.from_file(LLAMA3)._get_device_engine()._program_args()
    assert args["boundary"] == "llama3" and args["whole_word"]
    return args


def _tables(args):
    return tables_from_numpy({k: v if isinstance(v, (str, bool)) else np.asarray(v)
                              for k, v in args.items()}, "cpu")


@jax.jit
def _jax_make_ids0(b, inb, bnd, nxt_bnd, lengths, byte2id, ww_rows0, ww_rows1, ww_seed):
    """The body of `make_ids0` in `tokenizers_tpu.ops.bpe_encode._encode_core`
    (whole_word=True), copied line for line: it is a closure there."""
    B, L = b.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    ids0 = jnp.where(inb, j_take256(b, byte2id), -1)

    def word_hash(mult):
        def op(x, y):
            (a1, c1, f1), (a2, c2, f2) = x, y
            a = jnp.where(f2, a2, a1 * a2)
            c = jnp.where(f2, c2, c1 * a2 + c2)
            return a, c, f1 | f2

        a0 = jnp.full((B, L), np.uint32(mult))
        c0 = (b + 1).astype(jnp.uint32)
        _, h, _ = jax.lax.associative_scan(op, (a0, c0, bnd), axis=1)
        return h

    h1 = word_hash(0x01000193)
    h2 = word_hash(0x0000C597)
    end_pos = jnp.minimum(nxt_bnd, lengths[:, None]) - 1
    end_cl = jnp.clip(end_pos, 0, L - 1)
    wh1 = jnp.take_along_axis(h1, end_cl, axis=1).astype(jnp.int32)
    wh2 = jnp.take_along_axis(h2, end_cl, axis=1).astype(jnp.int32)
    wlen_b = end_pos - pos + 1
    wwmask = ww_rows0.shape[0] - 1
    g0 = hash_jnp(wh1, wh2, ww_seed, wwmask, 0)
    g1 = hash_jnp(wh1, wh2, ww_seed, wwmask, 1)
    w0 = ww_rows0[g0]
    w1 = ww_rows1[g1]
    hit0 = (w0[..., 0] == wh1) & (w0[..., 1] == wh2)
    hit1 = (w1[..., 0] == wh1) & (w1[..., 1] == wh2)
    stored_len = jnp.where(hit0, w0[..., 2], w1[..., 2])
    stored_id = jnp.where(hit0, w0[..., 3], w1[..., 3])
    ww_hit = bnd & (hit0 | hit1) & (stored_len == wlen_b) & (wlen_b > 1)
    f = jnp.where(bnd, ww_hit.astype(jnp.int32), -1)

    def op_fill(x, y):
        (v1,), (v2,) = x, y
        return (jnp.where(v2 >= 0, v2, v1),)

    (filled,) = jax.lax.associative_scan(op_fill, (f,), axis=1)
    word_is_hit = (filled == 1) & inb
    ids0 = jnp.where(bnd & ww_hit, stored_id, ids0)
    return jnp.where(word_is_hit & ~bnd, -1, ids0)


def test_whole_word_full_branch_matches_jax(jax_args):
    """Words of the vocab (hits), words that are not, one-byte words and a
    long run."""
    T = _tables(jax_args)
    lines = open("tests/fixtures/corpus.txt", encoding="utf-8").read().splitlines()
    strings = [s for s in lines if 0 < len(s.encode("utf-8")) <= 256][:20] + _fuzz()[:40]
    strings.append("x" + "a" * 240)
    b, inb = _pack(strings, L=256, rows=64)
    bt, inbt = torch.from_numpy(b), torch.from_numpy(inb)
    n = inbt.sum(1).to(torch.int32)
    bnd, _ = llama3_boundaries(bt, inbt, T["cls_table"])
    nxt = next_boundary(bnd)
    ids0 = torch.where(inbt, te.take256(bt, T["byte2id"]), -1)
    got = te._whole_word_full(ids0, bt, bnd, inbt, nxt, n, T)
    want = _jax_make_ids0(*(jnp.asarray(x.numpy()) for x in (bt, inbt, bnd, nxt, n)),
                          jax_args["byte2id"], jax_args["ww_rows0"],
                          jax_args["ww_rows1"], jax_args["ww_seed"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ((got == -1) & inbt).any() and not torch.equal(got, ids0)  # the bypass ran


N, B, L = 2, 16, 256
SC, CAP = 1 << 10, 2350  # small enough that the epoch resets within the run


def _chunk(kind, seed):
    """[B, L] ASCII rows.  `prose`: corpus words, 60 drawn per chunk from a
    pool of 150, so the chunk fits the dedup buffer and chunks share
    words; `random`: distinct random words, so the buffer overflows and
    the chunk takes the full-width branch."""
    rng = np.random.default_rng(seed)
    buf = np.zeros((B, L), np.uint8)
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lens[3] = 0
    if kind == "prose":
        words = open("tests/fixtures/corpus.txt", "rb").read()[:20_000].split()
        pool = sorted({w for w in words if max(w) < 128})[:150]
        pick = [pool[i] for i in np.random.default_rng(seed).choice(150, 60, replace=False)]
        rows = [b" ".join(pick[i] for i in rng.integers(0, 60, L)) for _ in range(B)]
    else:
        rows = [bytes(rng.integers(33, 127, L, dtype=np.uint8)) for _ in range(B)]
    for r, row in enumerate(rows):
        buf[r, : lens[r]] = np.frombuffer(row[: lens[r]], np.uint8)
    return buf, lens


def _jax_scan_exe(bufs, lens, j_state, jax_args):
    """The JAX program compiled at XLA's lowest backend optimisation level:
    the same program, compiled in about two thirds of the time on the CPU.
    Called without its static arguments."""
    return jax_scan.lower(bufs, lens, cache_rows=j_state[0], cache_buf=j_state[1],
                          cache_p=j_state[2], ascii_only=True, **jax_args).compile(
        {"xla_backend_optimization_level": 0})


def test_encode_program_scan_matches_jax(jax_args, monkeypatch):
    T = _tables(jax_args)
    cache = WordCache(SC, CAP, "cpu")
    j_state = (jnp.zeros((SC, 4), jnp.int32), jnp.full((CAP + 1,), -1, jnp.int32),
               jnp.int32(0))
    dyn_args = {k: v for k, v in jax_args.items() if k not in ("boundary", "whole_word")}
    exe = None
    calls = [(("prose", 1), ("prose", 2)), (("random", 3), ("prose", 4)),
             (("prose", 5), ("prose", 1)), (("prose", 6), ("prose", 2))]
    seen = {"reset": False, "full_width": False}
    for call in calls:
        bufs, lens = map(np.stack, zip(*(_chunk(*c) for c in call)))
        p_before = cache.p
        ids, ntok, bad = te.encode_program_scan(
            torch.from_numpy(bufs), torch.from_numpy(lens), T, cache=cache,
            ascii_only=True, boundary="llama3", whole_word=True)
        exe = exe or _jax_scan_exe(jnp.asarray(bufs), jnp.asarray(lens), j_state, jax_args)
        j_ids, j_ntok, j_bad, j_state = exe(
            jnp.asarray(bufs), jnp.asarray(lens), cache_rows=j_state[0],
            cache_buf=j_state[1], cache_p=j_state[2], **dyn_args)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(ntok.numpy(), np.asarray(j_ntok))
        np.testing.assert_array_equal(bad.numpy(), np.asarray(j_bad))
        np.testing.assert_array_equal(cache.rows.numpy(), np.asarray(j_state[0]))
        np.testing.assert_array_equal(cache.buf.numpy(), np.asarray(j_state[1]))
        assert cache.p == int(j_state[2])
        seen["reset"] |= cache.p < p_before
        seen["full_width"] |= call[0][0] == "random" and not bool(bad[0].all())
    assert all(seen.values()), seen

    # the big-bucket branch, forced at this size: an overflowing chunk goes
    # to the host whole and leaves the cache as it was
    monkeypatch.setenv("TOKENIZERS_TPU_BIG_BUCKET_MIN", str(B * L))
    buf, lens = _chunk("random", 3)
    p_before, rows_before = cache.p, cache.rows.clone()
    ids, ntok, bad = te.encode_core(torch.from_numpy(buf), torch.from_numpy(lens), T,
                                    cache=cache, ascii_only=True, boundary="llama3",
                                    whole_word=True)
    assert bad.all() and (ntok == 0).all() and (ids == -1).all()
    assert cache.p == p_before and torch.equal(cache.rows, rows_before)


def _probes(big):
    """Added tokens, contractions with U+017F, digit runs, CR/LF runs; with
    `big`, also a 14,000-word input and a 140 KB word."""
    return [
        "Hello world!", "don't DON'T Don'T don'ſ it'ſ 'S 'll", "a<|begin_of_text|>b",
        "<|end_of_text|>", "", "  x", "1234567 89 ０１２３ ٣٣٣٣ a1b22c333",
        "x\r\ny \n\n z\r\n\r\n  \r\n", "!!\n\nok ...\r\n", " \n \n  tail   ",
        "序号123 漢字かな ΑΒΓ", "naïve café　end\xa0x", "emoji 🙂🙂 ok's 42½",
        "\t\tab\tcd",
    ] + (["word " * 14_000, "x" * 140_000] if big else [])


@pytest.fixture(scope="module", params=[LLAMA3, LLAMA3_128K], ids=["llama3", "llama3_128k"])
def pair(request):
    tok = Tokenizer.from_file(request.param, device="cpu")
    assert tok._get_device_engine() is not None
    return tok, WheelTokenizer.from_file(request.param)


@pytest.mark.parametrize("batch,special", [
    ("probes", True), ("probes", False), ("corpus", True), ("random_words", True)])
def test_encode_batch_fast_matches_wheel(pair, batch, special):
    tok, wheel = pair
    # the large inputs run once, on the 128k vocab; the small fixture gets a
    # quarter of each batch
    full = len(tok.model.vocab) > 100_000  # llama3_128k
    if batch == "probes":
        inputs = _probes(big=full and special)
    elif batch == "corpus":
        docs = build_docs()
        n_ascii, n_utf8 = (48, 8) if full else (12, 2)
        inputs = docs[:n_ascii] + [d for d in docs if not d.isascii()][:n_utf8]
    else:  # many distinct words: at 24 inputs the chunk overflows the dedup
        # buffer and takes the full-width branch
        rng = np.random.default_rng(9)
        inputs = [" ".join(bytes(rng.integers(97, 123, int(rng.integers(3, 12)),
                                              dtype=np.uint8)).decode()
                           for _ in range(300)) for _ in range(24 if full else 6)]
    engine_base.STATS.reset()
    got = tok.encode_batch_fast(inputs, add_special_tokens=special)
    want = wheel.encode_batch_fast(inputs, add_special_tokens=special)
    assert [e.ids for e in got] == [e.ids for e in want]
    for g, w in zip(got, want):
        assert g.type_ids == w.type_ids
        assert g.special_tokens_mask == w.special_tokens_mask
        assert g.attention_mask == w.attention_mask
    snap = engine_base.STATS.snapshot()
    if batch == "probes":
        # two added-token inputs, and the 140 KB word, which has no safe seam
        assert snap["host_pre_inputs"] == (3 if full and special else 2)
    else:
        assert snap["device_rows"] >= len(inputs)
    assert tok.token_to_id("<|begin_of_text|>") == wheel.token_to_id("<|begin_of_text|>")


def _edited(path, value, src=LLAMA3):
    d = json.load(open(src, encoding="utf-8"))
    node = d
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return json.dumps(d)


BYTE_LEVEL = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
              "use_regex": True}


@pytest.mark.parametrize("path,value", [
    (("pre_tokenizer", "pretokenizers", 0, "pattern", "Regex"), r"\s+|\S+"),
    (("pre_tokenizer", "pretokenizers", 0, "pattern"), {"String": " "}),
    (("pre_tokenizer", "pretokenizers", 0, "behavior"), "Removed"),
    (("pre_tokenizer", "pretokenizers", 0, "invert"), True),
    (("pre_tokenizer", "pretokenizers", 1, "use_regex"), True),
    (("pre_tokenizer", "pretokenizers", 1, "add_prefix_space"), True),
    (("pre_tokenizer", "pretokenizers", 1), {"type": "Digits", "individual_digits": True}),
    (("pre_tokenizer",), BYTE_LEVEL),  # ignore_merges without the Sequence
    (("model", "ignore_merges"), False),  # the Sequence without ignore_merges
    (("normalizer",), {"type": "NFC"}),
])
def test_loader_refuses_what_it_does_not_honour(path, value):
    """Once refused, now loaded as the JAX package loads it (the general
    host pipeline where no engine takes it): encoded as the wheel does,
    under dropout as JAX does with the same seed
    (`torch_reference.loads_as_the_reference`)."""
    from torch_reference import loads_as_the_reference

    loads_as_the_reference(_edited(path, value))


def _same_as_wheel(blob, texts):
    """The port loads `blob` and encodes `texts` as the wheel does (ids,
    tokens, type ids, offsets, masks)."""
    ours = Tokenizer.from_str(blob, device="cpu")
    ref = WheelTokenizer.from_str(blob)
    for g, w in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
        assert (g.ids, g.tokens, g.type_ids, g.offsets, g.attention_mask) == (
            w.ids, w.tokens, w.type_ids, [tuple(o) for o in w.offsets], w.attention_mask), g.ids


@pytest.mark.parametrize("path,value", [
    (("post_processor", "single"), [{"Sequence": {"id": "A", "type_id": 0}}] * 2),
    (("post_processor",), {"type": "BertProcessing", "sep": ["x", 1], "cls": ["y", 0]}),
])
def test_loader_admits_what_it_now_honours(path, value):
    """Post-processors refused before the Tokenizer's full surface was
    ported: a template with the sequence twice, BertProcessing."""
    _same_as_wheel(_edited(path, value), ["Hello world! <|endoftext|>a", "x  y\tz", "naïve café 12", ""])
