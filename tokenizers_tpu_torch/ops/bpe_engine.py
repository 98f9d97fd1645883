"""ByteLevelBpeEngine: the device path of gpt2-style byte-level BPE; port
of `tokenizers_tpu.ops.bpe_engine` (the gpt2 boundary only).

The engine holds its tables as tensors on its device, and the persistent
cross-batch word cache (`bpe_dedup.WordCache`: 1M direct-mapped rows and a
16M-token append buffer), which `bpe_encode.encode_program_scan` updates
in place.  Same-shape chunks of one batch run in order through one
program call, so each distinct word of the batch is merged once.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from .bpe_dedup import WordCache
from .bpe_encode import encode_program_scan
from .engine_base import DeviceEngineBase
from .merge_table import CuckooMergeTable, consume_mins
from .unicode_tables import char_class_flat

TABLE_KEYS = ("byte2id", "cls_table", "merge_rows0", "merge_rows1", "merge_mclr")


def tables_from_numpy(d: dict, device) -> dict:
    """The engine's tables as tensors on `device` from numpy arrays keyed
    as the JAX engine's `_program_args()`: byte2id, cls_table,
    merge_rows0/1, merge_mclr and seed (a scalar)."""
    out = {k: torch.from_numpy(np.array(d[k])).to(device) for k in TABLE_KEYS}
    out["seed"] = int(np.asarray(d["seed"]))
    return out


class ByteLevelBpeEngine(DeviceEngineBase):
    WC_SLOTS = 1 << 20
    WC_CAP = 1 << 24

    def __init__(self, tokenizer, tables: dict, add_prefix_space: bool, device):
        self.tokenizer = tokenizer
        self.add_prefix_space = add_prefix_space
        self.device = torch.device(device)
        self.tables = tables
        self._wc: Optional[WordCache] = None
        self._wc_lock = threading.Lock()  # the cache is updated in place

    @staticmethod
    def build_tables(model, device) -> Optional[dict]:
        """The engine's tables from a BPE model; None when the vocab lacks
        a byte of the byte-level alphabet (the host path handles that)."""
        from ..pre_tokenizers.byte_level import BYTES_CHAR

        byte2id = np.zeros(256, dtype=np.int32)
        for bb in range(256):
            tid = model.vocab.get(BYTES_CHAR[bb])
            if tid is None:
                return None
            byte2id[bb] = tid
        table = CuckooMergeTable(model.merges)
        n_ids = max([len(model.vocab)] + [nid + 1 for (_r, nid) in model.merges.values()])
        mclr = consume_mins(model.merges, n_ids)
        return tables_from_numpy(
            dict(
                byte2id=byte2id,
                cls_table=char_class_flat(),
                merge_rows0=table.rows8(0, mclr),
                merge_rows1=table.rows8(1, mclr),
                merge_mclr=mclr,
                seed=table.seed,
            ),
            device,
        )

    @staticmethod
    def try_build(tokenizer, device) -> Optional["ByteLevelBpeEngine"]:
        """The engine for the tokenizer's gpt2-style pipeline (its loader
        admits no other), or None when the vocab lacks a byte.  On a card
        it builds every kernel first, all at once."""
        tables = ByteLevelBpeEngine.build_tables(tokenizer.model, device)
        if tables is None:
            return None
        if torch.device(device).type == "cuda":
            from .kernel_build import build

            build()
        return ByteLevelBpeEngine(
            tokenizer, tables, tokenizer.pre_tokenizer.add_prefix_space, device
        )

    def _ensure_cache(self) -> WordCache:
        if self._wc is None:
            self._wc = WordCache(self.WC_SLOTS, self.WC_CAP, self.device)
        return self._wc

    @staticmethod
    def _is_ascii(buf: np.ndarray) -> bool:
        return int(buf.max(initial=0)) < 128

    def _program_many(self, chunks) -> List[tuple]:
        """Group same-shape, same-ascii chunks (in first-seen order) and run
        each group through one `encode_program_scan` call with the word
        cache."""
        groups: dict = {}
        for i, (buf, _lens, _orig) in enumerate(chunks):
            groups.setdefault((buf.shape, self._is_ascii(buf)), []).append(i)
        out: List[Optional[tuple]] = [None] * len(chunks)
        with self._wc_lock:
            cache = self._ensure_cache()
            for (_shape, ascii_only), idxs in groups.items():
                bufs = torch.from_numpy(np.stack([chunks[i][0] for i in idxs]))
                lens = torch.from_numpy(np.stack([chunks[i][1] for i in idxs]))
                ids, ntok, bad = encode_program_scan(
                    bufs.to(self.device), lens.to(self.device), self.tables,
                    cache=cache, ascii_only=ascii_only,
                )
                for k, i in enumerate(idxs):
                    out[i] = (ids[k], ntok[k], bad[k])
        return out
