"""Python binding surface long tail: is_pretokenized, pickling, numpy
inputs, custom components (reference `bindings/python/src/tokenizer.rs:
282-345,598-621,1070`, `normalizers.rs:634-679`, SURVEY A.3)."""

import pickle

import numpy as np
import pytest

from tokenizers_tpu_torch.decoders import Decoder
from tokenizers_tpu_torch.models.bpe import BPE
from tokenizers_tpu_torch.models.wordlevel import WordLevel
from tokenizers_tpu_torch.normalizers import Normalizer
from tokenizers_tpu_torch.pre_tokenizers import PreTokenizer, Whitespace
from tokenizers_tpu_torch.tokenizer import Tokenizer

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)


def word_tok():
    vocab = {"hello": 0, "world": 1, "[UNK]": 2, "a": 3, "b": 4}
    t = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    t.pre_tokenizer = Whitespace()
    return t


def ref_word_tok():
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers.models import WordLevel as RefWordLevel
    from tokenizers.pre_tokenizers import Whitespace as RefWhitespace

    vocab = {"hello": 0, "world": 1, "[UNK]": 2, "a": 3, "b": 4}
    t = tokenizers.Tokenizer(RefWordLevel(vocab, unk_token="[UNK]"))
    t.pre_tokenizer = RefWhitespace()
    return t


# ------------------------------------------------------------ is_pretokenized


def test_is_pretokenized_flag_honored():
    t = word_tok()
    r = ref_word_tok()
    words = ["hello", "world"]
    assert (
        t.encode(words, is_pretokenized=True).ids
        == r.encode(words, is_pretokenized=True).ids
    )
    with pytest.raises(TypeError):
        t.encode(words)  # list without the flag: reference errors too
    with pytest.raises(Exception):
        r.encode(words)
    with pytest.raises(TypeError):
        t.encode("hello world", is_pretokenized=True)
    with pytest.raises(Exception):
        r.encode("hello world", is_pretokenized=True)


def test_encode_batch_pretokenized_and_pairs():
    t = word_tok()
    r = ref_word_tok()
    batch = [["hello", "world"], ["a", "b"]]
    mine = t.encode_batch(batch, is_pretokenized=True)
    ref = r.encode_batch(batch, is_pretokenized=True)
    assert [e.ids for e in mine] == [e.ids for e in ref]
    # dual pretokenized sequences
    pair_batch = [(["hello"], ["world"])]
    mine = t.encode_batch(pair_batch, is_pretokenized=True)
    ref = r.encode_batch(pair_batch, is_pretokenized=True)
    assert [e.ids for e in mine] == [e.ids for e in ref]
    assert [e.type_ids for e in mine] == [e.type_ids for e in ref]
    # text pairs without the flag
    tp = [("hello", "world")]
    assert [e.ids for e in t.encode_batch(tp)] == [
        e.ids for e in r.encode_batch(tp)
    ]


# ------------------------------------------------------------------- numpy


def test_numpy_unicode_array_inputs():
    t = word_tok()
    r = ref_word_tok()
    arr = np.array(["hello world", "a b"], dtype=np.str_)
    assert [e.ids for e in t.encode_batch(arr)] == [
        e.ids for e in r.encode_batch(arr)
    ]
    obj = np.array(["hello", "world"], dtype=object)
    assert (
        t.encode(obj, is_pretokenized=True).ids
        == r.encode(obj, is_pretokenized=True).ids
    )


# ------------------------------------------------------------------ pickling


def test_tokenizer_pickle_roundtrip(tmp_path):
    import os

    fx = os.path.join(os.path.dirname(__file__), "fixtures/gpt2/tokenizer.json")
    t = Tokenizer.from_file(fx)
    t2 = pickle.loads(pickle.dumps(t))
    text = "the quick brown fox doesn't jump"
    assert t2.encode(text).ids == t.encode(text).ids
    assert t2.to_str() == t.to_str()


# ---------------------------------------------------------- custom components


def test_custom_normalizer():
    class Upper:
        def normalize(self, normalized):
            normalized.map(str.upper)

    t = word_tok()
    t.model = WordLevel({"HELLO": 0, "WORLD": 1, "[UNK]": 2}, unk_token="[UNK]")
    t.normalizer = Normalizer.custom(Upper())
    e = t.encode("hello world")
    assert e.ids == [0, 1]
    with pytest.raises(ValueError):
        t.to_str()  # custom components are non-serializable


def test_custom_pretokenizer():
    class CommaSplit:
        def pre_tokenize(self, pretok):
            pretok.split(lambda i, ns: ns.split(",", "removed"))

    t = word_tok()
    t.pre_tokenizer = PreTokenizer.custom(CommaSplit())
    e = t.encode("hello,world")
    assert e.ids == [0, 1]


def test_custom_decoder():
    class Joiner:
        def decode(self, tokens):
            return "|".join(tokens)

    t = word_tok()
    t.decoder = Decoder.custom(Joiner())
    assert t.decode([0, 1]) == "hello|world"


def test_custom_rejects_wrong_shape():
    with pytest.raises(TypeError):
        Normalizer.custom(object())
    with pytest.raises(TypeError):
        PreTokenizer.custom(object())
    with pytest.raises(TypeError):
        Decoder.custom(object())
