"""The port's added vocabulary (`tokenizers_tpu_torch/added_vocabulary.py`)
against the `tokenizers` wheel and the JAX package's `AddedVocabulary`,
on the CPU.

* The committed word-char table (`data/wl_class_whitespace.npz`'s `\\w`
  class) equals `[\\p{Alphabetic}\\p{M}\\p{Nd}\\p{Pc}\\p{Join_Control}]` of
  the `regex` module, and `SPACE_CHARS` the reference's whitespace class,
  over every code point.
* The six option sets of `test_conformance_pipeline.py::
  test_added_tokens_matching` (single_word, lstrip, rstrip, both,
  normalized, not normalized) on its texts, for the bert-style pipeline
  of `test_torch_post_process.py`, its gpt2-style one (no normalizer) and
  a WordLevel pipeline with a lowercasing normalizer (spans through the
  alignments); JAX's host path and the wheel, every field exact.
* The `encode_special_tokens` toggle, ids allocated above the vocab,
  `get_vocab`, `get_vocab_size`, `get_added_tokens_decoder`, `decode`
  skipping only special tokens (an `AddedToken` given to
  `add_special_tokens` is made special, as the wheel does and the JAX
  package does not), and the device routing: an input whose added token
  appears only after normalization goes to the host.
* The device engine follows the components: the port rebuilds it when a
  pre-tokenizer is set after an encode, where the JAX package keeps the
  engine it built (keyed on the model's id only; ROADMAP Queue C).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tokenizers as hf  # noqa: E402

import tokenizers_tpu as tt  # noqa: E402
from test_torch_post_process import KINDS, build, gpt2_style, same  # noqa: E402
from tokenizers_tpu_torch import Tokenizer  # noqa: E402
from tokenizers_tpu_torch.added_vocabulary import SPACE_CHARS, AddedToken, is_word_char  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONS = [dict(single_word=True), dict(lstrip=True), dict(rstrip=True),
           dict(lstrip=True, rstrip=True), dict(normalized=True), dict(normalized=False)]
TEXTS = ["a special_tok b", "special_tok", "aspecial_tokb", "  special_tok  ", "a  special_tok",
         "SPECIAL_TOK special_tok"]
WL_VOCAB = {"<unk>": 0, "a": 1, "b": 2, "special": 3, "_": 4, "tok": 5, "the": 6}


def _wordlevel(kind):
    if kind == "port":
        from tokenizers_tpu_torch.models.wordlevel import WordLevel
        from tokenizers_tpu_torch.normalizers import Lowercase
        from tokenizers_tpu_torch.pre_tokenizers.whitespace import Whitespace

        tok = Tokenizer(WordLevel(WL_VOCAB, "<unk>"), device="cpu")
        tok.normalizer = Lowercase()
        tok.pre_tokenizer = Whitespace()
        return tok
    lib = {"wheel": hf, "jax": tt}[kind]
    tok = lib.Tokenizer(lib.models.WordLevel(WL_VOCAB, unk_token="<unk>"))
    tok.normalizer = lib.normalizers.Lowercase()
    tok.pre_tokenizer = lib.pre_tokenizers.Whitespace()
    return tok


def _added(kind, **options):
    return {"wheel": hf.AddedToken, "jax": tt.AddedToken, "port": AddedToken}[kind](
        "special_tok", **options)


def test_tables_equal_the_regex_module():
    import regex

    cps = np.concatenate([np.arange(0, 0xD800), np.arange(0xE000, 0x110000)])
    text = "".join(map(chr, cps.tolist()))
    words = {ord(c) for c in regex.findall(
        r"[\p{Alphabetic}\p{M}\p{Nd}\p{Pc}\p{Join_Control}]", text)}
    spaces = {ord(c) for c in regex.findall(
        "[\\t\\n\\x0B\\f\\r \\x85\\xA0\\u1680\\u2000-\\u200A\\u2028\\u2029\\u202F\\u205F\\u3000]",
        text)}
    from tokenizers_tpu_torch.ops.wordlevel_encode import WL_A, wordlevel_class_tables

    s1, s2 = wordlevel_class_tables("whitespace")
    table = s2[(s1[cps >> 8].astype(np.int64) << 8) | (cps & 255)] == WL_A
    assert set(cps[table].tolist()) == words
    assert {ord(c) for c in SPACE_CHARS} == spaces
    assert all(is_word_char(chr(c)) for c in (0x61, 0x5F, 0x200D, 0x0301, 0x0660))
    assert not any(is_word_char(chr(c)) for c in (0x20, 0x2D, 0x24, 0x1F600))


@pytest.mark.parametrize("pipeline", ["bert", "gpt2", "wordlevel"])
@pytest.mark.parametrize("option", range(len(OPTIONS)))
def test_added_tokens_matching(pipeline, option):
    toks = [_wordlevel(k) if pipeline == "wordlevel" else build(pipeline, k) for k in KINDS]
    for k, t in zip(KINDS, toks):
        assert t.add_tokens([_added(k, **OPTIONS[option])]) == 1
    w, j, p = toks
    texts = TEXTS + ["the special_tok, tok"]
    for s in texts:
        for ast in (True, False):
            want = w.encode(s, add_special_tokens=ast)
            same(p.encode(s, add_special_tokens=ast), want, (OPTIONS[option], s))
            same(p.encode(s, add_special_tokens=ast), j.encode(s, add_special_tokens=ast),
                 (OPTIONS[option], s, "jax"))
            fast = p.encode_batch_fast([s], add_special_tokens=ast)[0]
            same(fast, w.encode_batch_fast([s], add_special_tokens=ast)[0], s, offsets=False,
                 nested=False)
    assert p.get_vocab() == w.get_vocab()
    assert p.get_vocab_size() == w.get_vocab_size() == j.get_vocab_size()
    assert p.get_vocab_size(False) == w.get_vocab_size(False)
    assert ({i: str(t) for i, t in p.get_added_tokens_decoder().items()}
            == {i: t.content for i, t in w.get_added_tokens_decoder().items()})


def test_encode_special_tokens_toggle():
    toks = [gpt2_style(k) for k in KINDS]
    for s in ("hello <|endoftext|> world", "<|endoftext|><|endoftext|>x"):
        for flag in (True, False):
            toks[0].encode_special_tokens = flag
            toks[1].set_encode_special_tokens(flag)
            toks[2].set_encode_special_tokens(flag)
            assert toks[2].get_encode_special_tokens() is flag
            want = toks[0].encode(s)
            for got in (toks[2].encode(s), toks[1].encode(s)):
                same(got, want, (s, flag), nested=False)
            assert toks[2].encode_batch_fast([s])[0].ids == want.ids


def test_ids_vocab_and_decode():
    """Special and non-special tokens, one already in the vocab: ids above
    the vocab in order, a token re-added ignored; `decode` skips only the
    special ones."""
    toks = [gpt2_style(k) for k in KINDS]
    lib = {"wheel": hf.AddedToken, "jax": tt.AddedToken, "port": AddedToken}
    counts = []
    for k, t in zip(KINDS, toks):
        counts.append((t.add_tokens(["newtok", lib[k]("he", single_word=True), "newtok"]),
                       t.add_special_tokens([lib[k]("<pad>", lstrip=True), "<|endoftext|>"])))
    assert counts[2] == counts[0], counts
    w, j, p = toks
    assert p.get_vocab() == w.get_vocab() == j.get_vocab()
    assert p.token_to_id("newtok") == w.token_to_id("newtok")
    assert p.id_to_token(p.token_to_id("<pad>")) == "<pad>"
    text = "the newtok <pad> he said <|endoftext|>"
    ids = w.encode(text).ids
    assert p.encode(text).ids == ids
    for skip in (True, False):
        assert p.decode(ids, skip) == w.decode(ids, skip), skip
    assert p.get_vocab_size() == w.get_vocab_size()
    # the JAX package keeps an AddedToken given to add_special_tokens as it
    # is (not special: decode keeps it), the wheel and the port make it
    # special (ROADMAP Queue C)
    assert p.get_added_tokens_decoder()[p.token_to_id("<pad>")].special
    assert w.get_added_tokens_decoder()[w.token_to_id("<pad>")].special
    assert not j.added_vocabulary.is_special_token("<pad>")


def test_normalized_token_routes_to_the_host():
    """The bert fixture on the port's device engine (CPU): a token matched
    on the normalized text that the raw text does not hold ("SPECIAL_TOK"
    lowercased) sends its input to the host, as the wheel's result needs;
    JAX's engine sends it to the device (a JAX fault, Queue C)."""
    path = os.path.join(REPO, "tests", "fixtures", "bert", "tokenizer.json")
    ours, ref = Tokenizer.from_file(path, device="cpu"), hf.Tokenizer.from_file(path)
    ours.add_tokens(["special_tok"])
    ref.add_tokens(["special_tok"])
    eng = ours._get_device_engine()
    assert type(eng).__name__ == "WordPieceEngine"
    texts = ["a SPECIAL_TOK b", "no token here", "Special_Tok!"]
    assert [eng._needs_host(s, ours.added) for s in texts] == [True, False, True]
    assert [e.ids for e in ours.encode_batch_fast(texts)] == \
        [e.ids for e in ref.encode_batch_fast(texts)]
    for g, e in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
        same(g, e, g.ids, nested=False)
    # the JAX package's WordPiece engine checks the raw text only, so its
    # device path would encode "SPECIAL_TOK" as plain text (Queue C)
    jax = tt.Tokenizer.from_file(path)
    jax.add_tokens(["special_tok"])
    jeng = jax._get_device_engine()
    added = list(jax.added_vocabulary.added_tokens_map)
    assert [jeng._needs_host(s, added) for s in texts] == [False, False, False]
    assert jax.encode(texts[0]).ids == ref.encode(texts[0]).ids


def test_engine_follows_the_pre_tokenizer():
    """Set a pre-tokenizer after a first encode: the port rebuilds its
    engine (the ids follow the new prefix space, as the wheel's do); the
    JAX package's engine cache is keyed on the model's id and keeps the
    engine built for the old pre-tokenizer (a JAX fault, Queue C)."""
    from tokenizers_tpu.pre_tokenizers.byte_level import ByteLevel as JaxByteLevel

    from tokenizers_tpu_torch.pre_tokenizers.byte_level import ByteLevel

    j = gpt2_style("jax")
    before = j._get_device_engine()
    j.pre_tokenizer = JaxByteLevel(add_prefix_space=True)
    after = j._get_device_engine()
    assert after is before and after.add_prefix_space is False  # stale in JAX

    p, w = gpt2_style("port"), gpt2_style("wheel")
    assert p.encode_batch_fast(["the hello"])[0].ids == w.encode("the hello").ids
    first = p._get_device_engine()
    p.pre_tokenizer = ByteLevel(add_prefix_space=True)
    w.pre_tokenizer = hf.pre_tokenizers.ByteLevel(add_prefix_space=True)
    eng = p._get_device_engine()
    assert eng is not first and eng.add_prefix_space is True
    assert p.encode_batch_fast(["the hello"])[0].ids == w.encode("the hello").ids
