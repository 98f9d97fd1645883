"""Typed exceptions of the port; copy of `tokenizers_tpu.errors`.

Each class subclasses both the shared root `TokenizersError` and the
builtin the same site raises in the reference's Python binding
(`bindings/python/src/error.rs`), so `except ValueError` keeps working
while `except TokenizersError` catches every typed error.
"""

from __future__ import annotations


class TokenizersError(Exception):
    """Root of the port's typed errors."""


class TruncationError(TokenizersError, ValueError):
    """Invalid truncation parameters or inputs
    (reference `utils/truncation.rs:42-50`)."""


class SerdeError(TokenizersError, ValueError):
    """tokenizer.json (de)serialization failure: an unknown component type,
    a component that cannot be written, a malformed payload
    (reference `tokenizer/serialization.rs`)."""


class ModelError(TokenizersError, ValueError):
    """Invalid model data: a merge token out of the vocab, a malformed
    merges line, a missing unk token (reference `models/bpe/mod.rs`)."""


class TrainingError(TokenizersError, ValueError):
    """Trainer failure (reference unigram `trainer.rs` errors)."""


class InputError(TokenizersError, TypeError):
    """Invalid encode input type (reference `EncodeInput` conversions in
    `bindings/python/src/tokenizer.rs:282-345`)."""
