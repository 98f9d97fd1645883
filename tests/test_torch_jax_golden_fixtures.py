"""Golden conformance: our host pipeline must reproduce the reference's ids
and offsets on trained realistic fixtures (gpt2/llama3/bert/unigram styles)."""

import json
import os

import pytest

import tokenizers_tpu_torch as tt

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def load_golden():
    with open(os.path.join(HERE, "golden.json")) as f:
        return json.load(f)


GOLDEN = load_golden()


@pytest.mark.parametrize("name", ["gpt2", "llama3", "bert", "unigram"])
def test_golden_ids_and_offsets(name):
    tok = tt.Tokenizer.from_file(os.path.join(HERE, name, "tokenizer.json"))
    sample = GOLDEN["sample"]
    want = GOLDEN["fixtures"][name]
    for i, s in enumerate(sample):
        e = tok.encode(s)
        assert e.ids == want["ids"][i], (name, i, s[:60], e.tokens[:10])
        assert [list(o) for o in e.offsets] == want["offsets"][i], (name, i, s[:60])
