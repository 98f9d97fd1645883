"""Recipe classes (implementations/) and async API smoke + conformance."""

import asyncio

import pytest

from tokenizers_tpu_torch.implementations import (
    BertWordPieceTokenizer,
    ByteLevelBPETokenizer,
    CharBPETokenizer,
    SentencePieceBPETokenizer,
    SentencePieceUnigramTokenizer,
)

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "hello world this is a test of the tokenizer recipes",
    "pack my box with five dozen liquor jugs",
] * 10


def test_byte_level_bpe_train_and_encode(tmp_path):
    tok = ByteLevelBPETokenizer()
    tok.train_from_iterator(CORPUS, vocab_size=400, show_progress=False)
    enc = tok.encode("the quick brown fox")
    assert enc.ids
    assert tok.decode(enc.ids) == "the quick brown fox"
    # serialization round trip
    path = str(tmp_path / "tok.json")
    tok.save(path)
    from tokenizers_tpu_torch.tokenizer import Tokenizer

    tok2 = Tokenizer.from_file(path)
    assert tok2.encode("the quick brown fox").ids == enc.ids


def test_bert_wordpiece_train_and_encode():
    tok = BertWordPieceTokenizer()
    tok.train_from_iterator(CORPUS, vocab_size=300, show_progress=False)
    assert tok.encode("The Quick Brown Fox!").ids
    # like the reference recipe, [CLS]/[SEP] wiring requires a vocab at
    # construction time
    tok2 = BertWordPieceTokenizer(vocab=tok.get_vocab(with_added_tokens=False))
    enc = tok2.encode("The Quick Brown Fox!")
    assert enc.tokens[0] == "[CLS]" and enc.tokens[-1] == "[SEP]"


def test_char_bpe_train_and_encode():
    tok = CharBPETokenizer()
    tok.train_from_iterator(CORPUS, vocab_size=300, show_progress=False)
    enc = tok.encode("the quick brown fox")
    assert enc.ids


def test_sentencepiece_bpe_train_and_encode():
    tok = SentencePieceBPETokenizer()
    tok.train_from_iterator(CORPUS, vocab_size=300, show_progress=False)
    enc = tok.encode("the quick brown fox")
    assert enc.ids
    assert tok.decode(enc.ids) == "the quick brown fox"


def test_sentencepiece_unigram_train_and_encode():
    tok = SentencePieceUnigramTokenizer()
    tok.train_from_iterator(
        CORPUS, vocab_size=100, special_tokens=["<unk>"], unk_token="<unk>",
        show_progress=False,
    )
    enc = tok.encode("the quick brown fox")
    assert enc.ids
    assert tok.decode(enc.ids) == "the quick brown fox"


def test_async_variants():
    from tokenizers_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer.from_file("tests/fixtures/gpt2/tokenizer.json")

    async def run():
        enc = await tok.async_encode("hello world")
        batch = await tok.async_encode_batch(["hello world", "foo"])
        fast = await tok.async_encode_batch_fast(["hello world"])
        text = await tok.async_decode(enc.ids, skip_special_tokens=True)
        texts = await tok.async_decode_batch([e.ids for e in batch])
        return enc, batch, fast, text, texts

    enc, batch, fast, text, texts = asyncio.run(run())
    assert enc.ids == tok.encode("hello world").ids
    assert fast[0].ids == tok.encode_batch_fast(["hello world"])[0].ids
    assert text == tok.decode(enc.ids)
    assert len(texts) == 2
