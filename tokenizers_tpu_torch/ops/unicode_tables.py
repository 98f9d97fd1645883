"""Unicode character classes for the GPT-2 pre-split.

Class constants and the two-stage codepoint -> class table of
`tokenizers_tpu.ops.unicode_tables`.  The table is not derived here at run
time (that needs the `regex` module): it is the committed data file
`data/char_class.npz`, written by `python -m tokenizers_tpu_torch.data.regen`
and held equal to the JAX package's table by `tests/test_torch_tables.py`.

Classes:
    0 = O   other (non-space, non-letter, non-number)
    1 = L   \\p{L}
    2 = N   \\p{N}
    3 = SP  literal space U+0020
    4 = WS  other whitespace per Oniguruma \\s
    5 = END sentinel for "no char" (start/end of text)
"""

from __future__ import annotations

import os

import numpy as np

CLS_O = 0
CLS_L = 1
CLS_N = 2
CLS_SP = 3
CLS_WS = 4
CLS_END = 5

PAGE_BITS = 8
PAGE_SIZE = 1 << PAGE_BITS
MAX_CP = 0x110000

TABLE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data",
    "char_class.npz",
)

_cached = None
_cached_flat = None


def char_class_tables():
    """(stage1 int32[MAX_CP >> PAGE_BITS], stage2 int8[n_pages << PAGE_BITS])."""
    global _cached
    if _cached is None:
        with np.load(TABLE_PATH) as z:
            _cached = (z["stage1"].astype(np.int32), z["stage2"].astype(np.int8))
    return _cached


def char_class_flat() -> np.ndarray:
    """Flat int8[MAX_CP] codepoint -> class table, expanded from the
    two-stage table."""
    global _cached_flat
    if _cached_flat is None:
        stage1, stage2 = char_class_tables()
        cp = np.arange(MAX_CP, dtype=np.int64)
        page = stage1[cp >> PAGE_BITS].astype(np.int64)
        _cached_flat = stage2[(page << PAGE_BITS) | (cp & (PAGE_SIZE - 1))]
    return _cached_flat
