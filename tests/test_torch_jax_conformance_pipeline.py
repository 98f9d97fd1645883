"""Full-pipeline conformance vs the reference: gpt2-style and bert-style."""

import json

import pytest
import tokenizers as hf

import tokenizers_tpu_torch as tt
from corpus import PAIRS, SHORT_STRINGS

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)


def _gpt2_style(cls_hf: bool):
    """A small byte-level BPE over ascii bytes with a few merges."""
    from tokenizers_tpu_torch.pre_tokenizers.byte_level import BYTES_CHAR

    alphabet = sorted({BYTES_CHAR[b] for b in range(256)})
    vocab = {c: i for i, c in enumerate(alphabet)}
    merge_pairs = [
        ("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("l", "l"), ("e", "ll"),
        ("o", "r"), ("w", "or"), ("a", "n"), ("i", "n"), ("Ġ", "an"),
        ("e", "r"), ("Ġ", "a"), ("r", "e"), ("o", "n"), ("Ġthe", "Ġt"),
    ]
    merges = []
    for a, b in merge_pairs:
        if a in vocab and b in vocab:
            new = a + b
            if new not in vocab:
                vocab[new] = len(vocab)
            merges.append((a, b))
    vocab["<|endoftext|>"] = len(vocab)
    if cls_hf:
        tok = hf.Tokenizer(hf.models.BPE(vocab, merges))
        tok.pre_tokenizer = hf.pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = hf.decoders.ByteLevel()
        tok.post_processor = hf.processors.ByteLevel(trim_offsets=True)
        tok.add_special_tokens(["<|endoftext|>"])
    else:
        tok = tt.Tokenizer(tt.models.BPE(vocab, merges))
        tok.pre_tokenizer = tt.pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = tt.decoders.ByteLevel()
        tok.post_processor = tt.processors.ByteLevel(trim_offsets=True)
        tok.add_special_tokens(["<|endoftext|>"])
    return tok


def _bert_style(cls_hf: bool):
    words = [
        "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick", "brown",
        "fox", "jump", "##s", "##ed", "over", "lazy", "dog", "hello", "world",
        "un", "##believable", "##able", "!", "?", ",", ".", "'", "a", "b",
        "##a", "##b", "1", "2", "##1", "日", "本",
    ]
    vocab = {w: i for i, w in enumerate(words)}
    if cls_hf:
        tok = hf.Tokenizer(hf.models.WordPiece(vocab, unk_token="[UNK]"))
        tok.normalizer = hf.normalizers.BertNormalizer()
        tok.pre_tokenizer = hf.pre_tokenizers.BertPreTokenizer()
        tok.decoder = hf.decoders.WordPiece()
        tok.post_processor = hf.processors.TemplateProcessing(
            single="[CLS] $A [SEP]",
            pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", 2), ("[SEP]", 3)],
        )
        tok.add_special_tokens(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    else:
        tok = tt.Tokenizer(tt.models.WordPiece(vocab, unk_token="[UNK]"))
        tok.normalizer = tt.normalizers.BertNormalizer()
        tok.pre_tokenizer = tt.pre_tokenizers.BertPreTokenizer()
        tok.decoder = tt.decoders.WordPiece()
        tok.post_processor = tt.processors.TemplateProcessing(
            single="[CLS] $A [SEP]",
            pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", 2), ("[SEP]", 3)],
        )
        tok.add_special_tokens(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    return tok


def assert_encodings_equal(em, er, ctx):
    assert em.ids == er.ids, (ctx, em.tokens, er.tokens)
    assert em.tokens == er.tokens, ctx
    assert em.type_ids == er.type_ids, ctx
    assert em.offsets == er.offsets, ctx
    assert em.word_ids == er.word_ids, ctx
    assert em.special_tokens_mask == er.special_tokens_mask, ctx
    assert em.attention_mask == er.attention_mask, ctx
    assert em.sequence_ids == er.sequence_ids, ctx
    assert len(em.overflowing) == len(er.overflowing), ctx
    for om, orf in zip(em.overflowing, er.overflowing):
        assert om.ids == orf.ids, ctx
        assert om.offsets == orf.offsets, ctx


@pytest.mark.parametrize("style", ["gpt2", "bert"])
def test_pipeline_encode(style):
    build = _gpt2_style if style == "gpt2" else _bert_style
    ref, mine = build(True), build(False)
    for s in SHORT_STRINGS:
        for ast in (True, False):
            em = mine.encode(s, add_special_tokens=ast)
            er = ref.encode(s, add_special_tokens=ast)
            assert_encodings_equal(em, er, (style, s, ast))
    for a, b in PAIRS:
        em, er = mine.encode(a, b), ref.encode(a, b)
        assert_encodings_equal(em, er, (style, a, b))


@pytest.mark.parametrize("style", ["gpt2", "bert"])
def test_pipeline_special_tokens_in_text(style):
    build = _gpt2_style if style == "gpt2" else _bert_style
    ref, mine = build(True), build(False)
    texts = [
        "hello <|endoftext|> world",
        "[CLS] injected [SEP]",
        "<|endoftext|><|endoftext|>",
        "pre[MASK]post",
    ]
    for s in texts:
        em, er = mine.encode(s), ref.encode(s)
        assert_encodings_equal(em, er, (style, s))


@pytest.mark.parametrize("style", ["gpt2", "bert"])
def test_pipeline_truncation_padding(style):
    build = _gpt2_style if style == "gpt2" else _bert_style
    for direction in ["right", "left"]:
        for stride in [0, 2]:
            ref, mine = build(True), build(False)
            ref.enable_truncation(8, stride=stride, direction=direction)
            mine.enable_truncation(8, stride=stride, direction=direction)
            ref.enable_padding(pad_id=0, pad_token="[PAD]", length=10)
            mine.enable_padding(pad_id=0, pad_token="[PAD]", length=10)
            for s in SHORT_STRINGS[:25]:
                em, er = mine.encode(s), ref.encode(s)
                assert_encodings_equal(em, er, (style, s, direction, stride))
            for a, b in PAIRS:
                em, er = mine.encode(a, b), ref.encode(a, b)
                assert_encodings_equal(em, er, (style, a, b, direction, stride))


@pytest.mark.parametrize("style", ["gpt2", "bert"])
def test_pipeline_batch_and_decode(style):
    build = _gpt2_style if style == "gpt2" else _bert_style
    ref, mine = build(True), build(False)
    ref.enable_padding()
    mine.enable_padding()
    texts = SHORT_STRINGS[:20]
    ems = mine.encode_batch(texts)
    ers = ref.encode_batch(texts)
    for em, er, s in zip(ems, ers, texts):
        assert_encodings_equal(em, er, (style, s))
    for em in ers:
        for skip in (True, False):
            assert mine.decode(em.ids, skip) == ref.decode(em.ids, skip)


def test_added_tokens_matching():
    ref, mine = _bert_style(True), _bert_style(False)
    for tok_args in [
        dict(single_word=True),
        dict(lstrip=True),
        dict(rstrip=True),
        dict(lstrip=True, rstrip=True),
        dict(normalized=True),
        dict(normalized=False),
    ]:
        r, m = _bert_style(True), _bert_style(False)
        r.add_tokens([hf.AddedToken("special_tok", **tok_args)])
        m.add_tokens([tt.AddedToken("special_tok", **tok_args)])
        texts = [
            "a special_tok b",
            "special_tok",
            "aspecial_tokb",
            "  special_tok  ",
            "a  special_tok",
            "SPECIAL_TOK special_tok",
        ]
        for s in texts:
            em, er = m.encode(s), r.encode(s)
            assert_encodings_equal(em, er, (tok_args, s))


def test_encode_special_tokens_toggle():
    ref, mine = _gpt2_style(True), _gpt2_style(False)
    ref.encode_special_tokens = True
    mine.set_encode_special_tokens(True)
    s = "hello <|endoftext|> world"
    em, er = mine.encode(s), ref.encode(s)
    assert_encodings_equal(em, er, s)


@pytest.mark.parametrize("style", ["gpt2", "bert"])
def test_serialization_round_trip(style):
    build = _gpt2_style if style == "gpt2" else _bert_style
    ref, mine = build(True), build(False)
    mine.enable_truncation(16, stride=2)
    mine.enable_padding(pad_token="[PAD]", pad_id=0)
    ref.enable_truncation(16, stride=2)
    ref.enable_padding(pad_token="[PAD]", pad_id=0)

    # ours -> reference loads it
    ref_loaded = hf.Tokenizer.from_str(mine.to_str())
    # reference -> ours loads it
    mine_loaded = tt.Tokenizer.from_str(ref.to_str())
    for s in SHORT_STRINGS[:20]:
        a = ref_loaded.encode(s)
        b = ref.encode(s)
        assert a.ids == b.ids, s
        c = mine_loaded.encode(s)
        assert c.ids == b.ids, s
        assert c.offsets == b.offsets, s


def test_pretokenized_input():
    ref, mine = _bert_style(True), _bert_style(False)
    words = ["hello", "world", "unbelievable"]
    em = mine.encode(words, is_pretokenized=True)
    er = ref.encode(words, is_pretokenized=True)
    # a list without is_pretokenized=True must be rejected, like the
    # reference binding (`tokenizer.rs:1070`: TextInputSequence must be str)
    import pytest

    with pytest.raises(TypeError):
        mine.encode(words)
    with pytest.raises(Exception):
        ref.encode(words)
    assert_encodings_equal(em, er, words)


def test_decode_stream():
    ref, mine = _gpt2_style(True), _gpt2_style(False)
    text = "the quick brown fox jumps over the lazy dog"
    ids = ref.encode(text).ids
    stream = mine.decode_stream(skip_special_tokens=False)
    out = []
    for id in ids:
        chunk = stream.step(id)
        if chunk is not None:
            out.append(chunk)
    assert "".join(out) == ref.decode(ids, False)
