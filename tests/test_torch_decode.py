"""Decoders and `Tokenizer.decode` of the torch port against the wheel and
the JAX package.

* Every decoder class equals the wheel's (`tokenizers.decoders`, built
  in-process) on token lists: byte-level chars, `<0xXX>` runs valid and
  not, `##` and `</w>` pieces, `▁`, CTC repeats and pads, Sequences.
* `decode` and `decode_batch` equal the wheel's and JAX's on every
  fixture and frozen tokenizer the port loads, with and without
  `skip_special_tokens`, on ids the wheel encoded and on ids out of range.
* `decode_stream` equals the wheel's `DecodeStream`, a partial character
  held back until it is whole.
* The loader takes every decoder the JAX package reads, in every pipeline.
"""

import json

import pytest

from tokenizers import Tokenizer as WheelTokenizer
from tokenizers import decoders as wd

from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch import decoders as td
from tokenizers_tpu_torch.smoke_data import build_docs, config_json

CONFIGS = ("gpt2", "llama3", "bert", "unigram", "unigram_bf", "char_bpe", "sp_bpe", "spm_bf",
           "wordlevel")
TEXTS = ["Hello world! y'all'll've", "café ﬁle 序号 ☃ 日本語", "a<|endoftext|>b [SEP] <unk> x",
         "  two  spaces\tand\nlines  ", "", "don't . , ? !"]

TOKENS = [
    [], ["a"], ["Ġhello", "Ġw", "orld", "âĢ", "Ŀ"], ["<0xE2>", "<0x82>", "<0xAC>", "x"],
    ["<0xE2>", "<0x82>", "y", "<0xFF>", "<0x41>"], ["<0x+a>", "<0xZZ>", "<0x4>", "<0x41>>"],
    ["▁Hello", "▁wor", "ld", "▁", "▁▁x", "▁"], ["hel", "##lo", "##", "world", ".", "do", "n't"],
    ["low</w>", "er</w>", "new", "est</w>"], ["<pad>", "h", "h", "<pad>", "e", "|", "|", "l", "l"],
    ["  x  ", " ", "   ", "x"], ["it", " 's", " 've", " do not", " ' ", "a"],
]


def _decoder_pairs():
    """(port decoder, wheel decoder) of every class."""
    return [
        (td.ByteLevel(), wd.ByteLevel()),
        (td.Metaspace(), wd.Metaspace()),
        (td.Metaspace(prepend_scheme="never"), wd.Metaspace(prepend_scheme="never")),
        (td.Metaspace("_", "first"), wd.Metaspace(replacement="_", prepend_scheme="first")),
        (td.WordPiece(), wd.WordPiece()),
        (td.WordPiece("##", False), wd.WordPiece(cleanup=False)),
        (td.BPEDecoder(), wd.BPEDecoder()),
        (td.BPEDecoder("er"), wd.BPEDecoder(suffix="er")),
        (td.ByteFallback(), wd.ByteFallback()),
        (td.CTC(), wd.CTC()),
        (td.CTC("<pad>", "|", False), wd.CTC(cleanup=False)),
        (td.Fuse(), wd.Fuse()),
        (td.Strip(" ", 1, 2), wd.Strip(" ", 1, 2)),
        (td.Strip("x", 0, 1), wd.Strip("x", 0, 1)),
        (td.Replace("▁", " "), wd.Replace("▁", " ")),
        (td.Sequence([td.Replace("▁", " "), td.ByteFallback(), td.Fuse(), td.Strip(" ", 1, 0)]),
         wd.Sequence([wd.Replace("▁", " "), wd.ByteFallback(), wd.Fuse(), wd.Strip(" ", 1, 0)])),
    ]


@pytest.mark.parametrize("k", range(len(_decoder_pairs())))
def test_decoders_equal_the_wheel(k):
    ours, theirs = _decoder_pairs()[k]
    for tokens in TOKENS:
        if isinstance(ours, td.Strip) and any(len(t) < 3 and set(t) == {ours.content}
                                              for t in tokens):
            continue  # the wheel panics where the start and stop cuts cross
        assert ours.decode(tokens) == theirs.decode(tokens), (type(ours).__name__, tokens)


def test_custom_decoder():
    class Upper:
        def decode(self, tokens):
            return "".join(tokens).upper()

    assert td.Decoder.custom(Upper()).decode(["a", "b"]) == "AB"
    assert td.Decoder.custom(Upper()).decode_chain(["a", "b"]) == ["AB"]
    with pytest.raises(TypeError):
        td.Decoder.custom(object())


@pytest.fixture(scope="module")
def tokenizers():
    out = {}
    for name in CONFIGS:
        js = config_json(name)
        out[name] = (Tokenizer.from_str(js, device="cpu"), WheelTokenizer.from_str(js),
                     JaxTokenizer.from_str(js))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_equals_wheel_and_jax(name, tokenizers):
    ours, wheel, jax_tok = tokenizers[name]
    docs = TEXTS + build_docs()[:16]
    ids = [e.ids for e in wheel.encode_batch(docs)]
    ids.append(ids[2] + [10 ** 7, -1 % 2 ** 32 - 1])  # ids out of range are dropped
    for skip in (True, False):
        want = wheel.decode_batch(ids, skip_special_tokens=skip)
        assert ours.decode_batch(ids, skip) == want
        assert [ours.decode(x, skip) for x in ids[:6]] == want[:6]
        assert [jax_tok.decode(x, skip) for x in ids[:6]] == want[:6]
    assert ours.id_to_token(ids[0][0]) == wheel.id_to_token(ids[0][0])


@pytest.mark.parametrize("name", ["gpt2", "unigram_bf", "spm_bf", "bert"])
def test_decode_stream_equals_the_wheel(name, tokenizers):
    ours, wheel, _ = tokenizers[name]
    docs = TEXTS + build_docs()[:4]
    for skip in (True, False):
        for doc_ids in (e.ids for e in wheel.encode_batch(docs)):
            a, b = ours.decode_stream(skip), wd.DecodeStream(skip_special_tokens=skip)
            assert [a.step(i) for i in doc_ids] == [b.step(wheel, i) for i in doc_ids]


def test_decode_stream_holds_a_partial_char(tokenizers):
    ours, wheel, _ = tokenizers["spm_bf"]  # the Llama-2 decoder: ByteFallback
    ids = [ours.token_to_id(t) for t in ("<0xE2>", "<0x98>", "<0x83>")]
    stream = ours.decode_stream()
    assert [stream.step(i) for i in ids] == [None, None, "☃"]
    theirs = wd.DecodeStream()
    assert [theirs.step(wheel, i) for i in ids] == [None, None, "☃"]


DECODERS = [
    {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True},
    {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "never", "split": True},
    {"type": "WordPiece", "prefix": "##", "cleanup": True},
    {"type": "BPEDecoder", "suffix": "</w>"},
    {"type": "ByteFallback"},
    {"type": "Fuse"},
    {"type": "Strip", "content": "▁", "start": 1, "stop": 0},
    {"type": "CTC", "pad_token": "<unk>", "word_delimiter_token": "▁", "cleanup": True},
    {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
    {"type": "Replace", "pattern": {"Regex": "▁+"}, "content": " "},
    {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "}, {"type": "ByteFallback"},
        {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
]


@pytest.mark.parametrize("k", range(len(DECODERS)))
@pytest.mark.parametrize("name", ["sp_bpe", "bert", "gpt2", "unigram"])
def test_loader_takes_every_decoder(name, k, tokenizers):
    d = json.loads(config_json(name))
    d["decoder"] = DECODERS[k]
    js = json.dumps(d, ensure_ascii=False)
    ours, wheel = Tokenizer.from_str(js, device="cpu"), WheelTokenizer.from_str(js)
    ids = [e.ids for e in wheel.encode_batch(TEXTS)]
    assert ours.decode_batch(ids) == wheel.decode_batch(ids)
