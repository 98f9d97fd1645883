"""The port's committed data and the tables it builds, re-derived from
their references: the two-stage class table from the JAX package's
`char_class_tables()`, the per-document gpt2 digests that chip_smoke.py
checks from the `tokenizers` wheel on the same documents, and the
engine's tables from the JAX engine's `_program_args()`, array for
array."""

import numpy as np
import pytest

from tokenizers import Tokenizer as WheelTokenizer

from tokenizers_tpu.ops import unicode_tables as ju
from tokenizers_tpu.tokenizer import Tokenizer as JaxTokenizer
from tokenizers_tpu_torch import Tokenizer
from tokenizers_tpu_torch.ops import unicode_tables as tu
from tokenizers_tpu_torch.ops.bpe_engine import TABLE_KEYS
from tokenizers_tpu_torch.smoke_data import build_docs, ids_digest, load_digests

GPT2 = "tests/fixtures/gpt2/tokenizer.json"


def test_class_table_matches_jax():
    for got, want in zip(tu.char_class_tables(), ju.char_class_tables()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tu.char_class_flat(), ju.char_class_flat())
    for name in ("CLS_O", "CLS_L", "CLS_N", "CLS_SP", "CLS_WS", "CLS_END", "PAGE_BITS", "MAX_CP"):
        assert getattr(tu, name) == getattr(ju, name)


def test_gpt2_digests_match_wheel():
    docs = build_docs()
    assert len(docs) == 512 and sum(not d.isascii() for d in docs) == 20
    wheel = WheelTokenizer.from_file(GPT2)
    encs = wheel.encode_batch_fast(docs, add_special_tokens=True)
    assert [ids_digest(e.ids) for e in encs] == load_digests()


@pytest.mark.parametrize("key", TABLE_KEYS + ("seed",))
def test_engine_tables_match_jax(key):
    want = np.asarray(JaxTokenizer.from_file(GPT2)._get_device_engine()._program_args()[key])
    got = Tokenizer.from_file(GPT2, device="cpu")._get_device_engine().tables[key]
    if key == "seed":
        assert got == int(want)
    else:
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
