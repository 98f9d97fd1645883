"""Padding parameters and the padding of a batch; copy of
`tokenizers_tpu.utils.padding` (reference `utils/padding.rs`): to the
batch's longest encoding (`BATCH_LONGEST`) or to a fixed length, rounded
up to `pad_to_multiple_of`, on the right or the left, overflowing
windows included."""

from __future__ import annotations

from typing import List, Optional

BATCH_LONGEST = "batch_longest"


class PaddingParams:
    __slots__ = ("strategy", "direction", "pad_to_multiple_of", "pad_id", "pad_type_id",
                 "pad_token")

    def __init__(self, strategy=BATCH_LONGEST, direction: str = "right",
                 pad_to_multiple_of: Optional[int] = None, pad_id: int = 0, pad_type_id: int = 0,
                 pad_token: str = "[PAD]"):
        self.strategy = strategy  # BATCH_LONGEST or the fixed length
        self.direction = direction
        self.pad_to_multiple_of = pad_to_multiple_of
        self.pad_id = pad_id
        self.pad_type_id = pad_type_id
        self.pad_token = pad_token

    def __repr__(self):
        return (f"PaddingParams(strategy={self.strategy!r}, direction={self.direction!r}, "
                f"pad_to_multiple_of={self.pad_to_multiple_of}, pad_id={self.pad_id}, "
                f"pad_type_id={self.pad_type_id}, pad_token={self.pad_token!r})")


def pad_encodings(encodings: List, params: PaddingParams) -> None:
    if not encodings:
        return
    if params.strategy == BATCH_LONGEST:
        pad_length = max(len(e.ids) for e in encodings)
    else:
        pad_length = int(params.strategy)
    m = params.pad_to_multiple_of
    if m and pad_length % m > 0:
        pad_length += m - pad_length % m
    for e in encodings:
        e.pad(pad_length, params.pad_id, params.pad_type_id, params.pad_token, params.direction)
