"""Models of the host path.

`tokens(model, word)` is the general pipeline's call of any model: the
JAX package's `Token`s (id, value, offsets in the word's UTF-8 bytes),
built on the model's `tokenize_spans` (the fast host path's call, whose
spans are chars for WordPiece and for a BPE without `byte_spans`)."""

from __future__ import annotations

from typing import List


def tokens(model, word: str) -> List["Token"]:
    from ..normalized import char_to_byte_offsets
    from ..pretokenized import Token
    from .wordpiece import WordPiece

    spans = model.tokenize_spans(word)
    if not spans:
        return []
    vr = model.vocab_r
    chars = isinstance(model, WordPiece) or not getattr(model, "byte_spans", True)
    cb = char_to_byte_offsets(word) if chars and not word.isascii() else None
    out = []
    for t in spans:
        s, e = (t[1], t[2]) if cb is None else (cb[t[1]], cb[t[2]])
        out.append(Token(t[0], t[3] if len(t) > 3 else vr[t[0]], (s, e)))
    return out
