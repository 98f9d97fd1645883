"""Truncation parameters and the balancing of a pair; copy of
`tokenizers_tpu.utils.truncation` (reference `utils/truncation.rs`).

Three strategies: `longest_first` cuts the longer sequence of a pair
first (each gets at least half of `max_length` when both are too long),
`only_first` and `only_second` cut one sequence and raise when it is too
short to reach `max_length`.  The tokens cut go to each encoding's
`overflowing` windows (`Encoding.truncate`: `stride` tokens of overlap,
from the right or the left)."""

from __future__ import annotations

from typing import Tuple

from ..errors import TruncationError

LONGEST_FIRST = "longest_first"
ONLY_FIRST = "only_first"
ONLY_SECOND = "only_second"


class TruncationParams:
    __slots__ = ("direction", "max_length", "strategy", "stride")

    def __init__(self, max_length: int = 512, strategy: str = LONGEST_FIRST, stride: int = 0,
                 direction: str = "right"):
        if strategy not in (LONGEST_FIRST, ONLY_FIRST, ONLY_SECOND):
            raise TruncationError(f"Invalid truncation strategy: {strategy}")
        if direction not in ("left", "right"):
            raise TruncationError(f"Invalid truncation direction: {direction}")
        self.max_length = max_length
        self.strategy = strategy
        self.stride = stride
        self.direction = direction

    def __repr__(self):
        return (f"TruncationParams(max_length={self.max_length}, strategy={self.strategy!r}, "
                f"stride={self.stride}, direction={self.direction!r})")


def truncate_encodings(encoding, pair_encoding, params: TruncationParams) -> Tuple:
    """(reference `truncation.rs:75-160`)"""
    if params.max_length == 0:
        encoding.truncate(0, params.stride, params.direction)
        if pair_encoding is not None:
            pair_encoding.truncate(0, params.stride, params.direction)
        return encoding, pair_encoding

    total_length = len(encoding.ids) + (len(pair_encoding.ids) if pair_encoding is not None else 0)
    if total_length <= params.max_length:
        return encoding, pair_encoding
    to_remove = total_length - params.max_length

    if params.strategy == LONGEST_FIRST:
        if pair_encoding is not None:
            n1, n2 = len(encoding.ids), len(pair_encoding.ids)
            swap = n1 > n2
            if swap:
                n1, n2 = n2, n1
            if n1 > params.max_length:
                n2 = n1
            else:
                n2 = max(n1, params.max_length - n1)
            if n1 + n2 > params.max_length:
                n1 = params.max_length // 2
                n2 = n1 + params.max_length % 2
            if swap:
                n1, n2 = n2, n1
            encoding.truncate(n1, params.stride, params.direction)
            pair_encoding.truncate(n2, params.stride, params.direction)
        else:
            encoding.truncate(total_length - to_remove, params.stride, params.direction)
    else:
        if params.strategy == ONLY_FIRST:
            target = encoding
        elif pair_encoding is not None:
            target = pair_encoding
        else:
            raise TruncationError("Truncation error: Second sequence not provided")
        target_len = len(target.ids)
        if target_len > to_remove:
            target.truncate(target_len - to_remove, params.stride, params.direction)
        else:
            raise TruncationError("Truncation error: Sequence to truncate too short to respect "
                                  "the provided max_length")
    return encoding, pair_encoding
