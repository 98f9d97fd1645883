"""The port's committed data and the tables it builds, re-derived from
their references: the two-stage class table from the JAX package's
`char_class_tables()`, the per-document gpt2 and llama3_128k digests that
chip_smoke.py checks from the `tokenizers` wheel on the same documents
(the 8 KB ones and those of the long-document phase; ids, and for the
offsets phase ids, char offsets and word ids; bert's too, those of
the char-level phase's frozen tokenizers and of the Unigram fixtures),
the committed WordLevel class
tables from the JAX package's `wordlevel_class_tables()`,
and the engine's tables (gpt2, and llama3 with its whole-word table) from
the JAX engine's `_program_args()`, array for array."""

import numpy as np
import pytest

from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.ops import unicode_tables as ju
from tokenizers_tpu.ops.wordlevel_encode import wordlevel_class_tables as j_wl_tables
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.ops import unicode_tables as tu
from tokenizers_tpu_torch.ops.bpe_engine import TABLE_KEYS, WW_KEYS
from tokenizers_tpu_torch.ops.wordlevel_encode import class_table_path
from tokenizers_tpu_torch.smoke_data import (
    CONFIGS, DENSE_BYTES, DENSE_OVERFLOW_BYTES, build_docs, config_json, ids_digest,
    load_digests, long_parts, offsets_digest,
)

GPT2 = "tests/fixtures/gpt2/tokenizer.json"
LLAMA3 = "tests/fixtures/llama3/tokenizer.json"


def test_class_table_matches_jax():
    for got, want in zip(tu.char_class_tables(), ju.char_class_tables()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tu.char_class_flat(), ju.char_class_flat())
    for name in ("CLS_O", "CLS_L", "CLS_N", "CLS_SP", "CLS_WS", "CLS_END", "PAGE_BITS", "MAX_CP"):
        assert getattr(tu, name) == getattr(ju, name)


@pytest.mark.parametrize("kind", ["whitespace", "whitespace_split"])
def test_wordlevel_class_table_matches_jax(kind):
    with np.load(class_table_path(kind)) as z:
        for got, want in zip((z["s1"], z["s2"]), j_wl_tables(kind)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["char_bpe", "sp_bpe", "spm_bf", "wordlevel", "sp_bpe_long"])
def test_char_level_digests_match_wheel(name):
    config = name.replace("_long", "")
    docs = long_parts()["long"] if name.endswith("_long") else build_docs()
    encs = WheelTokenizer.from_str(config_json(config)).encode_batch_fast(
        docs, add_special_tokens=True)
    assert [ids_digest(e.ids) for e in encs] == load_digests(name)


@pytest.mark.parametrize("config", ["char_bpe", "sp_bpe", "wordlevel"])
def test_char_level_offsets_digests_match_wheel(config):
    encs = WheelTokenizer.from_str(config_json(config)).encode_batch(
        build_docs(), add_special_tokens=True)
    assert [offsets_digest(e) for e in encs] == load_digests(f"{config}_offsets")


@pytest.mark.parametrize("name", ["unigram", "unigram_bf", "unigram_long"])
def test_unigram_digests_match_wheel(name):
    docs = long_parts()["long"] if name.endswith("_long") else build_docs()
    encs = WheelTokenizer.from_str(config_json(name.replace("_long", ""))).encode_batch_fast(
        docs, add_special_tokens=True)
    assert [ids_digest(e.ids) for e in encs] == load_digests(name)


@pytest.mark.parametrize("config", ["unigram", "unigram_bf"])
def test_unigram_offsets_digests_match_wheel(config):
    encs = WheelTokenizer.from_str(config_json(config)).encode_batch(
        build_docs(), add_special_tokens=True)
    assert [offsets_digest(e) for e in encs] == load_digests(f"{config}_offsets")


def _digests_match_wheel(config):
    docs = build_docs()
    assert len(docs) == 512 and sum(not d.isascii() for d in docs) == 20
    wheel = WheelTokenizer.from_file(CONFIGS[config])
    encs = wheel.encode_batch_fast(docs, add_special_tokens=True)
    assert [ids_digest(e.ids) for e in encs] == load_digests(config)


def test_gpt2_digests_match_wheel():
    _digests_match_wheel("gpt2")


def test_llama3_digests_match_wheel():
    _digests_match_wheel("llama3")


@pytest.mark.parametrize("name", ["bert", "bert_long"])
def test_bert_digests_match_wheel(name):
    docs = long_parts()["long"] if name == "bert_long" else build_docs()
    encs = WheelTokenizer.from_file(CONFIGS["bert"]).encode_batch_fast(docs,
                                                                       add_special_tokens=True)
    assert [ids_digest(e.ids) for e in encs] == load_digests(name)


def test_gpt2_long_digests_match_wheel():
    parts = long_parts()
    long, dense, dense_16k = parts["long"], parts["dense"], parts["dense_16k"]
    assert len(long) == 131 and all(99_000 < len(d.encode()) <= 100_000 for d in long[-3:])
    assert len(dense) == 8 and all(10_000 < len(d) <= DENSE_BYTES for d in dense)
    assert len(dense_16k) == 8 and all(
        DENSE_BYTES < len(d) <= DENSE_OVERFLOW_BYTES for d in dense_16k)
    wheel = WheelTokenizer.from_file(CONFIGS["gpt2"])
    encs = wheel.encode_batch_fast(long + dense + dense_16k, add_special_tokens=True)
    assert [ids_digest(e.ids) for e in encs] == load_digests("gpt2_long")


@pytest.mark.parametrize("name,config", [
    ("gpt2_offsets", "gpt2"), ("llama3_offsets", "llama3"), ("gpt2_long_offsets", "gpt2"),
    ("bert_offsets", "bert"), ("bert_long_offsets", "bert")])
def test_offsets_digests_match_wheel(name, config):
    docs = long_parts()["long"] if name.endswith("_long_offsets") else build_docs()
    encs = WheelTokenizer.from_file(CONFIGS[config]).encode_batch(docs, add_special_tokens=True)
    assert [offsets_digest(e) for e in encs] == load_digests(name)


def _check_key(args, tables, key):
    want, got = args[key], tables[key]
    if key in ("seed", "ww_seed"):
        assert got == int(want)
    elif key in ("boundary", "whole_word"):
        assert got == want
    else:
        want, got = np.asarray(want), got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", TABLE_KEYS + ("seed",))
def test_engine_tables_match_jax(key):
    args = JaxTokenizer.from_file(GPT2)._get_device_engine()._program_args()
    _check_key(args, Tokenizer.from_file(GPT2, device="cpu")._get_device_engine().tables, key)


@pytest.fixture(scope="module")
def llama3_tables():
    return (JaxTokenizer.from_file(LLAMA3)._get_device_engine()._program_args(),
            Tokenizer.from_file(LLAMA3, device="cpu")._get_device_engine().tables)


@pytest.mark.parametrize("key", TABLE_KEYS + WW_KEYS + ("seed", "ww_seed", "boundary",
                                                        "whole_word"))
def test_llama3_engine_tables_match_jax(llama3_tables, key):
    _check_key(*llama3_tables, key)
