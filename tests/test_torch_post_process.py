"""The Tokenizer's post-processing surface of the port against the
`tokenizers` wheel and the JAX package's host pipeline, on the CPU:
truncation (`utils/truncation.py`: three strategies, both directions,
strides 0 and 2, overflowing windows), padding (`utils/padding.py`: batch
longest, fixed length, a multiple of 8, left), pairs and pre-tokenized
input, and every post-processor (`processors/`: the pair template,
BertProcessing, RobertaProcessing, Sequence, ByteLevel), on
`tests/corpus.py`'s SHORT_STRINGS and PAIRS for a gpt2-style and a
bert-style pipeline (the vocab, merges and components of
`tests/test_conformance_pipeline.py`), built three ways by `build`.
Every comparison is exact (ids, tokens, type ids, offsets, word ids,
masks, sequence ids, overflowing).  JAX runs its host path only
(`Tokenizer.encode`, `pad_encodings`): no JAX device program is
compiled.  One batch also runs through the port's device engine on the
CPU (the kernels' plain versions) with truncation and padding set, on
the gpt2 fixture, against the wheel."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import tokenizers as hf

import tokenizers_tpu as tt
from tokenizers_tpu.pre_tokenizers.byte_level import BYTES_CHAR
from tokenizers_tpu_torch import Tokenizer as PortTokenizer
from tokenizers_tpu_torch import decoders as pdec
from tokenizers_tpu_torch import processors as pproc
from tokenizers_tpu_torch.models.bpe import BPE as PortBPE
from tokenizers_tpu_torch.models.wordpiece import WordPiece as PortWordPiece
from tokenizers_tpu_torch.normalizers.bert import BertNormalizer as PortBertNormalizer
from tokenizers_tpu_torch.pre_tokenizers.bert import BertPreTokenizer as PortBertPre
from tokenizers_tpu_torch.pre_tokenizers.byte_level import ByteLevel as PortByteLevel

KINDS = ("wheel", "jax", "port")


def gpt2_vocab():
    alphabet = sorted({BYTES_CHAR[b] for b in range(256)})
    vocab = {c: i for i, c in enumerate(alphabet)}
    merges = []
    for a, b in [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("l", "l"), ("e", "ll"), ("o", "r"),
                 ("w", "or"), ("a", "n"), ("i", "n"), ("Ġ", "an"), ("e", "r"), ("Ġ", "a"),
                 ("r", "e"), ("o", "n"), ("Ġthe", "Ġt")]:
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
        merges.append((a, b))
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


BERT_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick", "brown", "fox",
              "jump", "##s", "##ed", "over", "lazy", "dog", "hello", "world", "un",
              "##believable", "##able", "!", "?", ",", ".", "'", "a", "b", "##a", "##b", "1",
              "2", "##1", "日", "本", "<s>", "</s>"]


def gpt2_style(kind: str, post=None):
    """Byte-level BPE over the 256 byte chars and a few merges; `post` the
    post-processor (default: ByteLevel(trim_offsets=True)) built by
    `post(lib)` with lib the kind's processors module."""
    vocab, merges = gpt2_vocab()
    lib = {"wheel": hf, "jax": tt}.get(kind)
    if kind == "port":
        tok = PortTokenizer(PortBPE(vocab, merges), device="cpu")
        tok.pre_tokenizer = PortByteLevel(add_prefix_space=False)
        tok.decoder = pdec.ByteLevel()
        tok.post_processor = post(pproc) if post else pproc.ByteLevel(trim_offsets=True)
    else:
        tok = lib.Tokenizer(lib.models.BPE(vocab, merges))
        tok.pre_tokenizer = lib.pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = lib.decoders.ByteLevel()
        tok.post_processor = (post(lib.processors) if post
                              else lib.processors.ByteLevel(trim_offsets=True))
    tok.add_special_tokens(["<|endoftext|>"])
    return tok


def bert_template(lib):
    return lib.TemplateProcessing(single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
                                  special_tokens=[("[CLS]", 2), ("[SEP]", 3)])


def bert_style(kind: str, post=bert_template):
    """WordPiece with BertNormalizer and BertPreTokenizer, the post-processor
    `post(lib)` (default: the BERT template)."""
    vocab = {w: i for i, w in enumerate(BERT_WORDS)}
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    if kind == "port":
        tok = PortTokenizer(PortWordPiece(vocab, unk_token="[UNK]"), device="cpu")
        tok.normalizer = PortBertNormalizer()
        tok.pre_tokenizer = PortBertPre()
        tok.decoder = pdec.WordPiece()
        tok.post_processor = post(pproc) if post else None
    else:
        lib = {"wheel": hf, "jax": tt}[kind]
        tok = lib.Tokenizer(lib.models.WordPiece(vocab, unk_token="[UNK]"))
        tok.normalizer = lib.normalizers.BertNormalizer()
        tok.pre_tokenizer = lib.pre_tokenizers.BertPreTokenizer()
        tok.decoder = lib.decoders.WordPiece()
        tok.post_processor = post(lib.processors) if post else None
    tok.add_special_tokens(specials)
    return tok


def build(style: str, kind: str, post=None):
    if style == "gpt2":
        return gpt2_style(kind, post)
    return bert_style(kind, post or bert_template)


def same(em, er, ctx, offsets=True, nested=True):
    """Encodings equal field by field, overflowing windows included (and
    theirs with `nested`: the wheel gives a pair's windows windows of their
    own, the JAX package and the port do not)."""
    assert em.ids == er.ids, (ctx, em.tokens, er.tokens)
    assert list(em.type_ids) == list(er.type_ids), ctx
    assert list(em.attention_mask) == list(er.attention_mask), ctx
    assert list(em.special_tokens_mask) == list(er.special_tokens_mask), ctx
    if offsets:
        assert list(em.tokens) == list(er.tokens), ctx
        assert [tuple(o) for o in em.offsets] == [tuple(o) for o in er.offsets], ctx
        assert list(em.word_ids) == list(er.word_ids), ctx
        if nested is not None:
            assert list(em.sequence_ids) == list(er.sequence_ids), ctx
    if nested is None:
        return
    assert len(em.overflowing) == len(er.overflowing), ctx
    for k, (om, orf) in enumerate(zip(em.overflowing, er.overflowing)):
        same(om, orf, (ctx, "overflowing", k), offsets, True if nested else None)


# ------------------------------------------------------------------ tests

from corpus import PAIRS, SHORT_STRINGS  # noqa: E402
from tokenizers_tpu.utils.padding import pad_encodings as jax_pad_encodings  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2 = os.path.join(REPO, "tests", "fixtures", "gpt2", "tokenizer.json")
STYLES = ("gpt2", "bert")
STRATEGIES = ("longest_first", "only_first", "only_second")


def _encode(tok, *args, **kw):
    """`tok.encode(...)`, or the fact that it raised."""
    try:
        return tok.encode(*args, **kw)
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException:  # the wheel raises Exception or panics, JAX and the port raise
        return "raised"


def _same_three(encs, ctx, offsets=True):
    w, j, p = encs
    if "raised" in (w, j, p):
        assert w == j == p == "raised", (ctx, w, j, p)
        return
    same(p, w, (ctx, "wheel"), offsets, nested=False)
    same(p, j, (ctx, "jax"), offsets)


# empty and space-only strings, spaces, tabs, contractions, accents, CJK, emoji
SINGLES = SHORT_STRINGS[:9] + [SHORT_STRINGS[i] for i in (12, 16, 26)]


def _inputs():
    return [(s,) for s in SINGLES] + [tuple(p) for p in PAIRS]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("style", STYLES)
def test_truncation(style, strategy):
    """max_length 8 (the special tokens' room taken off), right and left,
    strides 0 and 2, on single sequences and pairs; a strategy that cannot
    apply raises on all three."""
    toks = [build(style, k) for k in KINDS]
    for direction in ("right", "left"):
        for stride in (0, 2):
            for t in toks:
                t.enable_truncation(8, stride=stride, strategy=strategy, direction=direction)
            for args in _inputs():
                _same_three([_encode(t, *args) for t in toks], (args, direction, stride))


@pytest.mark.parametrize("style", STYLES)
def test_truncation_without_special_tokens(style):
    toks = [build(style, k) for k in KINDS]
    for t in toks:
        t.enable_truncation(5, stride=1)
    for args in _inputs():
        _same_three([_encode(t, *args, add_special_tokens=False) for t in toks], args)


PADDINGS = {
    "batch_longest": dict(),
    "fixed": dict(length=40),
    "multiple_of_8": dict(pad_to_multiple_of=8),
    "left": dict(direction="left", pad_id=1, pad_type_id=1, pad_token="[UNK]"),
    "fixed_multiple_left": dict(length=13, pad_to_multiple_of=8, direction="left"),
}


@pytest.mark.parametrize("padding", list(PADDINGS))
@pytest.mark.parametrize("style", STYLES)
def test_padding(style, padding):
    """A batch of single sequences and pairs (the host path), one of
    strings only (the port's device engine on the CPU), with and without
    truncation (overflowing windows are padded too)."""
    w, j, p = (build(style, k) for k in KINDS)
    for t in (w, j, p):
        t.enable_padding(**PADDINGS[padding])
    mixed = SINGLES + list(PAIRS)
    strings = SHORT_STRINGS[:16]
    for trunc in (False, True):
        if trunc:
            for t in (w, j, p):
                t.enable_truncation(9, stride=2)
        for batch in (mixed, strings):
            want = w.encode_batch(batch)
            jax = [j.encode(*(x if isinstance(x, tuple) else (x,))) for x in batch]
            jax_pad_encodings(jax, j.padding)
            got = p.encode_batch(batch)
            fast = p.encode_batch_fast(batch)
            want_fast = w.encode_batch_fast(batch)
            for k, x in enumerate(batch):
                same(got[k], want[k], (x, trunc), nested=False)
                same(got[k], jax[k], (x, trunc, "jax"))
                same(fast[k], want_fast[k], (x, trunc, "fast"), offsets=False, nested=False)


def _posts():
    return {
        "template_pair": lambda lib: lib.TemplateProcessing(
            single="$A:0 [SEP]", pair="[CLS]:0 $A:0 [SEP]:0 $B:1 [SEP]:1",
            special_tokens=[("[CLS]", 2), ("[SEP]", 3)]),
        "template_multi": lambda lib: lib.TemplateProcessing(
            single="[CLS] [CLS]:1 $0 [SEP]:2", pair="$B:1 [SEP] $A [CLS]:0",
            special_tokens=[lib.SpecialToken("[CLS]", [2, 5], ["[CLS]", "the"])
                            if hasattr(lib, "SpecialToken") else  # the wheel takes a dict
                            {"id": "[CLS]", "ids": [2, 5], "tokens": ["[CLS]", "the"]},
                            ("[SEP]", 3)]),
        "bert": lambda lib: lib.BertProcessing(("[SEP]", 3), ("[CLS]", 2)),
        "roberta": lambda lib: lib.RobertaProcessing(("</s>", 35), ("<s>", 34)),
        "roberta_no_trim": lambda lib: lib.RobertaProcessing(
            ("</s>", 35), ("<s>", 34), trim_offsets=False, add_prefix_space=False),
        "byte_level": lambda lib: lib.ByteLevel(trim_offsets=True),
        "sequence": lambda lib: lib.Sequence([
            lib.ByteLevel(trim_offsets=True),
            lib.TemplateProcessing(single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
                                   special_tokens=[("[CLS]", 2), ("[SEP]", 3)])]),
        "none": None,
    }


@pytest.mark.parametrize("post", list(_posts()))
@pytest.mark.parametrize("style", STYLES)
def test_post_processors(style, post):
    """Every post-processor on single sequences (with and without special
    tokens) and pairs, then with truncation (overflowing windows through
    the processor); `num_special_tokens_to_add` too."""
    fn = _posts()[post]
    if style == "bert" and fn is None:
        toks = [bert_style(k, post=None) for k in KINDS]
    else:
        toks = [build(style, k, fn) if fn else build(style, k, lambda lib: None) for k in KINDS]
    for is_pair in (False, True):
        n = {t.num_special_tokens_to_add(is_pair) for t in toks}
        assert len(n) == 1, (post, is_pair, n)
    for trunc in (False, True):
        if trunc:
            for t in toks:
                t.enable_truncation(10, stride=1)
        for args in _inputs():
            for ast in (True, False):
                _same_three([_encode(t, *args, add_special_tokens=ast) for t in toks],
                            (post, args, ast, trunc))


PRETOKENIZED = [["hello", "world", "unbelievable"], ["Hello,", " world!", "the"],
                ["日本", "fox", "jumps"], ["a"], ["  spaced  ", "x"]]


@pytest.mark.parametrize("style", STYLES)
def test_pretokenized_input(style):
    """Pre-tokenized words, alone and as pairs, through `encode` and
    `encode_batch` (the host path: each word encoded on its own, word ids
    its position); a list without `is_pretokenized` is refused."""
    w, j, p = (build(style, k) for k in KINDS)
    for words in PRETOKENIZED:
        _same_three([_encode(t, words, is_pretokenized=True) for t in (w, j, p)], words)
    pairs = list(zip(PRETOKENIZED, PRETOKENIZED[1:]))
    for a, b in pairs:
        _same_three([_encode(t, a, b, is_pretokenized=True) for t in (w, j, p)], (a, b))
    want = w.encode_batch(PRETOKENIZED + pairs, is_pretokenized=True)
    got = p.encode_batch(PRETOKENIZED + pairs, is_pretokenized=True)
    for x, g, e in zip(PRETOKENIZED + pairs, got, want):
        same(g, e, x, nested=False)
    with pytest.raises(TypeError):
        p.encode(PRETOKENIZED[0])


def test_device_batch_with_truncation_and_padding():
    """The gpt2 fixture through the port's device engine on the CPU (the
    kernels' plain versions) with truncation (stride) and padding to a
    multiple of 8: ids, masks and overflowing windows of `encode_batch_fast`,
    and everything of `encode_batch`, against the wheel."""
    import tokenizers as hf_

    from tokenizers_tpu_torch import Tokenizer
    from tokenizers_tpu_torch.ops.engine_base import STATS

    corpus = open(os.path.join(REPO, "tests", "fixtures", "corpus.txt"), encoding="utf-8").read()
    docs = [corpus[i * 997: i * 997 + 600 + 37 * i] for i in range(12)] + SHORT_STRINGS[:12]
    ours = Tokenizer.from_file(GPT2, device="cpu")
    ref = hf_.Tokenizer.from_file(GPT2)
    for t in (ours, ref):
        t.enable_truncation(64, stride=8)
        t.enable_padding(pad_to_multiple_of=8)
    before = STATS.device_rows
    got, want = ours.encode_batch_fast(docs), ref.encode_batch_fast(docs)
    assert STATS.device_rows > before  # the device engine ran
    for d, g, e in zip(docs, got, want):
        same(g, e, d[:40], offsets=False, nested=False)
    for d, g, e in zip(docs, ours.encode_batch(docs), ref.encode_batch(docs)):
        same(g, e, d[:40], nested=False)
