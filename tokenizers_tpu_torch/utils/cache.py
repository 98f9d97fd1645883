"""Bounded word cache; copy of `tokenizers_tpu.utils.cache` (reference
`tokenizers/src/utils/cache.rs`).

The reference's cache gives up under contention (try_read/try_write)
and keeps 10,000 entries; each process here has one thread on the host
path, so a plain dict that inserts only while below capacity behaves the
same.  The BPE and Unigram models cache their words in one.
"""

from __future__ import annotations

from typing import Dict, Generic, Optional, TypeVar

K = TypeVar("K")
V = TypeVar("V")

DEFAULT_CACHE_CAPACITY = 10_000


class Cache(Generic[K, V]):
    __slots__ = ("capacity", "map")

    def __init__(self, capacity: int = DEFAULT_CACHE_CAPACITY):
        self.capacity = capacity
        self.map: Dict[K, V] = {}

    def get(self, key: K) -> Optional[V]:
        return self.map.get(key)

    def set(self, key: K, value: V) -> None:
        if len(self.map) < self.capacity:
            self.map[key] = value

    def clear(self) -> None:
        self.map.clear()

    def __len__(self) -> int:
        return len(self.map)
