"""Typed error hierarchy (errors.py) raised at the reference's fallible
sites, each still catchable as the builtin it historically was
(reference `thiserror` enums, e.g. `utils/truncation.rs:42-50`)."""

import pytest

from tokenizers_tpu_torch import (
    ModelError,
    SerdeError,
    TokenizersError,
    TrainingError,
    TruncationError,
)

import pytest  # noqa: E402
import tokenizers_tpu_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _on_the_cpu():
    previous = tokenizers_tpu_torch.set_default_device("cpu")
    yield
    tokenizers_tpu_torch.set_default_device(previous)


def test_truncation_errors():
    from tokenizers_tpu_torch.utils.truncation import TruncationParams, truncate_encodings
    from tokenizers_tpu_torch.encoding import Encoding

    with pytest.raises(TruncationError):
        TruncationParams(strategy="bogus")
    with pytest.raises(TruncationError):
        TruncationParams(direction="sideways")
    # OnlySecond without a second sequence (truncation.rs:42-50)
    enc = Encoding(ids=[1, 2, 3], type_ids=[0] * 3, tokens=["a"] * 3,
                   words=[None] * 3, offsets=[(0, 0)] * 3)
    with pytest.raises(TruncationError):
        truncate_encodings(
            enc, None, TruncationParams(max_length=2, strategy="only_second")
        )


def test_serde_errors():
    from tokenizers_tpu_torch.serialization import tokenizer_from_dict

    with pytest.raises(SerdeError):
        tokenizer_from_dict(
            {"version": "1.0", "model": {"type": "NoSuchModel"}}
        )


def test_model_errors():
    from tokenizers_tpu_torch.models import BPE

    with pytest.raises(ModelError):
        BPE(vocab={"a": 0}, merges=[("a", "b")])  # b not in vocab


def test_hierarchy():
    for cls in (TruncationError, SerdeError, ModelError, TrainingError):
        assert issubclass(cls, TokenizersError)
        assert issubclass(cls, ValueError)
