"""Precompiled: the SentencePiece precompiled-charsmap normalizer; port of
`tokenizers_tpu.normalizers.precompiled` (reference
`tokenizers/src/normalizers/precompiled.rs`, the `spm_precompiled`
crate).

The charsmap is a darts-clone double-array trie over the rules' keys in
UTF-8, then a blob of the normalized strings, each ended by a NUL.  As in
the reference: each grapheme under 6 bytes is looked up whole first, then
each of its chars; a lookup takes the *longest* key that is a prefix of
what it looks up, so a grapheme whose first char is a key becomes that
key's string whole; and `_replace` keeps the reference's alignment
quirks (`precompiled.rs:6-31`).  Graphemes come from the port's own
segmentation (`graphemes.py`; the JAX package uses `regex`'s `\\X`).

`data/charsmap_nfkc.bin` is a charsmap of the NFKC rules (written by
`python -m tokenizers_tpu_torch.data.regen --charsmap`), the
`precompiled_charsmap` of the `t5_shape` pipeline the tests and
`chip_smoke.py` run.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from ..graphemes import graphemes
from ..utils.cache import Cache
from . import Normalizer

CHARSMAP_NFKC_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "data", "charsmap_nfkc.bin")


class DoubleArray:
    """darts-clone double-array trie reader."""

    __slots__ = ("units",)

    def __init__(self, units: np.ndarray):
        self.units = units.tolist()

    def common_prefix_search(self, key: bytes) -> List[int]:
        """The values of every key that is a prefix of `key`, shortest first."""
        units = self.units
        results: List[int] = []
        unit = units[0]
        node_pos = (unit >> 10) << ((unit & 0x200) >> 6)
        for c in key:
            node_pos ^= c
            if node_pos >= len(units):
                return results
            unit = units[node_pos]
            if (unit & 0x800000FF) != c:
                return results
            node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
            if (unit >> 8) & 1:
                results.append(units[node_pos] & 0x7FFFFFFF)
        return results


class Precompiled(Normalizer):
    def __init__(self, precompiled_charsmap: bytes):
        self.precompiled_charsmap = bytes(precompiled_charsmap)
        if len(self.precompiled_charsmap) < 4:
            raise ValueError("Precompiled charsmap too short")
        (trie_size,) = struct.unpack("<I", self.precompiled_charsmap[:4])
        left = self.precompiled_charsmap[4:]
        if trie_size % 4 or trie_size > len(left):
            raise ValueError("Precompiled charsmap: the trie's size does not fit the data")
        self.trie = DoubleArray(np.frombuffer(left[:trie_size], dtype="<u4"))
        self.normalized_blob = left[trie_size:]
        self._hits: Cache = Cache()  # chunk -> its string or None

    def transform(self, chunk: str) -> Optional[str]:
        """The normalized string of the longest key that is a prefix of
        `chunk`, or None."""
        hit = self._hits.get(chunk)
        if hit is not None:
            return hit[0]
        results = self.trie.common_prefix_search(chunk.encode("utf-8"))
        out = None
        if results:
            index = results[-1]
            end = self.normalized_blob.find(b"\x00", index)
            out = self.normalized_blob[index:None if end == -1 else end].decode("utf-8")
        self._hits.set(chunk, (out,))
        return out

    def normalize(self, normalized) -> None:
        transformations: List[Tuple[str, int]] = []
        modified = False
        for grapheme in graphemes(normalized.get()):
            if len(grapheme.encode("utf-8")) < 6:
                norm = self.transform(grapheme)
                if norm is not None:
                    modified = True
                    _replace(transformations, grapheme, norm)
                    continue
            for c in grapheme:
                norm = self.transform(c)
                if norm is not None:
                    modified = True
                    _replace(transformations, c, norm)
                else:
                    transformations.append((c, 0))
        if modified:
            normalized.transform(transformations, 0)


def _replace(transformations: List[Tuple[str, int]], old_part: str, new_part: str) -> None:
    """(reference `normalizers/precompiled.rs:6-31`): the new chars, the
    ones past the old count as insertions, or the last one taking the
    removals; with an empty new part and nothing before it the removal is
    dropped, as there."""
    diff = len(new_part) - len(old_part)
    transformations.extend((c, 0) for c in new_part)
    if diff > 0:
        for i in range(len(transformations) - diff, len(transformations)):
            transformations[i] = (transformations[i][0], 1)
    elif diff < 0 and transformations:
        c, cs = transformations[-1]
        transformations[-1] = (c, cs + diff)
