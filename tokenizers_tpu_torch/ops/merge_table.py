"""BPE merge-rank table: host-built 2-way cuckoo hash, queried on the card.

A copy of `tokenizers_tpu.ops.merge_table` (numpy, host side) plus the
torch form of its pair hash.  Every key (left_id, right_id) resides in one
of its two slots, so a lookup is two row reads: `rows0[hash(a, b, 0)]` and
`rows1[hash(a, b, 1)]`, each an [S, 8] row (`rows8`), or an [S, 4] row
(`rows`) for the whole-word table, keyed by a word's two rolling hashes.

The torch hash (`hash_pair`) runs in int64 masked to 32 bits after every
step: torch on the CPU has no uint32 shifts, and int64 arithmetic masked to
32 bits is exactly uint32 wraparound.  The CUDA kernels compute the same
hash in `uint32_t` (`csrc/merge_round.cu`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# odd 32-bit mixing constants (Knuth-style multiplicative hashing)
_C1 = np.int32(np.uint32(0x9E3779B1).astype(np.int32))
_C2 = np.int32(np.uint32(0x85EBCA77).astype(np.int32))
_C3 = np.int32(np.uint32(0xC2B2AE3D).astype(np.int32))
_M32 = 0xFFFFFFFF


def _hash(a: np.ndarray, b: np.ndarray, seed: int, mask: int, which: int) -> np.ndarray:
    """Vectorized 32-bit hash of (a,b) pairs -> slot index in [0, mask]."""
    a = a.astype(np.uint32)
    b = b.astype(np.uint32)
    c1, c2 = (np.uint32(_C1), np.uint32(_C2)) if which == 0 else (np.uint32(_C2), np.uint32(_C3))
    h = a * c1 + b * c2 + np.uint32(seed)
    h ^= h >> np.uint32(15)
    h *= np.uint32(0x2C1B3C6D)
    h ^= h >> np.uint32(12)
    return (h & np.uint32(mask)).astype(np.int64)


def _hash1(a: int, b: int, seed: int, mask: int, which: int) -> int:
    """`_hash` of one pair, in Python ints (the same bits, without numpy's
    per-call cost: the table build hashes key by key)."""
    c1, c2 = (0x9E3779B1, 0x85EBCA77) if which == 0 else (0x85EBCA77, 0xC2B2AE3D)
    h = ((a & _M32) * c1 + (b & _M32) * c2 + (seed & _M32)) & _M32
    h ^= h >> 15
    h = (h * 0x2C1B3C6D) & _M32
    h ^= h >> 12
    return h & mask


class CuckooMergeTable:
    """2-way cuckoo hash over (left_id, right_id) -> (rank, new_id)."""

    def __init__(self, merges: Dict[Tuple[int, int], Tuple[int, int]]):
        n = max(1, len(merges))
        size = 1
        while size < n:
            size <<= 1
        size <<= 1  # load factor <= 50% across the two tables combined
        self.seed = 0
        while not self._try_build(merges, size):
            self.seed += 1
            if self.seed % 8 == 0:
                size <<= 1
        self.size = size

    def _try_build(self, merges, size) -> bool:
        mask = size - 1
        # table index t in {0,1}; slot arrays shape [2, size]
        key_a = np.full((2, size), -1, dtype=np.int32)
        key_b = np.full((2, size), -1, dtype=np.int32)
        rank = np.zeros((2, size), dtype=np.int32)
        new_id = np.zeros((2, size), dtype=np.int32)
        max_kicks = 32 + 4 * int(np.log2(size) + 1)

        for (a, b), (r, nid) in merges.items():
            cur = (a, b, r, nid)
            t = 0
            placed = False
            for _ in range(max_kicks):
                h = _hash1(int(cur[0]), int(cur[1]), self.seed, mask, t)
                if key_a[t, h] == -1:
                    key_a[t, h], key_b[t, h] = cur[0], cur[1]
                    rank[t, h], new_id[t, h] = cur[2], cur[3]
                    placed = True
                    break
                # evict occupant, move it to its other table
                ev = (key_a[t, h], key_b[t, h], rank[t, h], new_id[t, h])
                key_a[t, h], key_b[t, h] = cur[0], cur[1]
                rank[t, h], new_id[t, h] = cur[2], cur[3]
                cur = ev
                t ^= 1
            if not placed:
                return False

        self.mask = mask
        self.key_a = key_a
        self.key_b = key_b
        self.rank = rank
        self.new_id = new_id
        return True

    def rows(self, t: int) -> np.ndarray:
        """Table t as [S, 4] rows (key_a, key_b, value0, value1): the
        whole-word table's (h1, h2, length, id)."""
        return np.stack(
            [self.key_a[t], self.key_b[t], self.rank[t], self.new_id[t]], axis=-1
        ).astype(np.int32)

    def rows8(self, t: int, mclr: np.ndarray) -> np.ndarray:
        """Table t as [S, 8] rows (key_a, key_b, rank, new_id,
        MCL(new_id), MCR(new_id), 0, 0): one row read per probe gives the
        rank, the merged id and the merged token's consume-mins."""
        nid = self.new_id[t]
        V = mclr.shape[0]
        cl = np.clip(nid, 0, V - 1)
        empty = self.key_a[t] == -1
        mcl = np.where(empty, 0, mclr[cl, 0])
        mcr = np.where(empty, 0, mclr[cl, 1])
        zero = np.zeros_like(nid)
        return np.stack(
            [self.key_a[t], self.key_b[t], self.rank[t], nid, mcl, mcr, zero, zero],
            axis=-1,
        ).astype(np.int32)


def consume_mins(
    merges: Dict[Tuple[int, int], Tuple[int, int]], n_ids: int
) -> np.ndarray:
    """Per-token minimum consuming ranks, [n_ids, 2] int32:

        [:, 0] = MCL(t) = min rank over merges (x, t)  (t as right member)
        [:, 1] = MCR(t) = min rank over merges (t, y)  (t as left member)

    INF (0x7FFFFFFF) where no such merge exists."""
    INF32 = np.int32(0x7FFFFFFF)
    out = np.full((n_ids, 2), INF32, dtype=np.int32)
    for (a, b), (r, _nid) in merges.items():
        if 0 <= b < n_ids and r < out[b, 0]:
            out[b, 0] = r
        if 0 <= a < n_ids and r < out[a, 1]:
            out[a, 1] = r
    return out


def hash_pair(a: torch.Tensor, b: torch.Tensor, seed, mask: int, which: int) -> torch.Tensor:
    """The cuckoo slot hash of int32 pairs (a, b) -> int32 slot in
    [0, mask], as uint32 arithmetic done in int64 masked to 32 bits.
    `seed` may be a Python int or a 0-d tensor."""
    c1 = 0x9E3779B1 if which == 0 else 0x85EBCA77
    c2 = 0x85EBCA77 if which == 0 else 0xC2B2AE3D
    a = a.to(torch.int64) & _M32
    b = b.to(torch.int64) & _M32
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64) & _M32
    else:
        seed = int(seed) & _M32
    h = (mul32(a, c1) + mul32(b, c2) + seed) & _M32
    h = h ^ (h >> 15)
    h = mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    return (h & mask).to(torch.int32)


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x and c in [0, 2^32), without leaving
    the int64 range: c is split into 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32
