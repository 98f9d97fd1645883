"""WordLevelEngine: the device path of WordLevel pipelines; port of
`tokenizers_tpu.ops.wordlevel_engine`.

WordLevel with Whitespace, WhitespaceSplit or BertPreTokenizer and any
normalizer of the port (applied on the host in `_prepare`, and on a
NormalizedString in `_prepare_aligned` for the offsets path, whose spans
are in the normalized bytes: `offsets_space = "normalized_bytes"`).  The
engine holds its tables as tensors on its device: the pre-split class
table of its kind and the vocab's cuckoo table, keyed by each entry's two
rolling hashes and valued by its byte length and id.  Both programs are
`wordlevel_encode.wordlevel_program`, one chunk at a time; no kernel of
`csrc/` runs on this path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .bpe_dedup import H1_MULT, H2_MULT
from .bpe_engine import _roll_hash
from .engine_base import DeviceEngineBase
from .merge_table import CuckooMergeTable
from .wordlevel_encode import wordlevel_class_tables, wordlevel_program

TABLE_KEYS = ("cls_s1", "cls_s2", "vrows0", "vrows1")
SCALAR_KEYS = ("vseed", "unk_id")


def tables_from_numpy(d: dict, device) -> dict:
    """The engine's tables: the arrays of TABLE_KEYS as tensors on
    `device`, the scalars of SCALAR_KEYS as ints."""
    out = {k: torch.from_numpy(np.array(d[k])).to(device) for k in TABLE_KEYS}
    out.update({k: int(np.asarray(d[k])) for k in SCALAR_KEYS})
    return out


def pretok_kind(pt) -> Optional[str]:
    """The class-table kind of a pre-tokenizer, None for another."""
    from ..pre_tokenizers.bert import BertPreTokenizer
    from ..pre_tokenizers.whitespace import Whitespace, WhitespaceSplit

    for cls, kind in ((BertPreTokenizer, "bert"), (Whitespace, "whitespace"),
                      (WhitespaceSplit, "whitespace_split")):
        if isinstance(pt, cls):
            return kind
    return None


class NormalizingEngine(DeviceEngineBase):
    """The host side shared by the engines whose normalizer runs on the
    host (WordLevel, char-level BPE)."""

    supports_offsets = True
    offsets_space = "normalized_bytes"

    def _prepare(self, s: str) -> bytes:
        nz = self.tokenizer.normalizer
        return (s if nz is None else nz.normalize_str(s)).encode("utf-8")

    def _needs_host(self, s: str, added) -> bool:
        """An added token in the raw text, or any added token's content in
        the normalized one."""
        if super()._needs_host(s, added):
            return True
        nz = self.tokenizer.normalizer
        if nz is None or not added:
            return False
        ns = nz.normalize_str(s)
        return any(t in ns for t in added)

    def _prepare_aligned(self, s: str):
        nz = self.tokenizer.normalizer
        if nz is None:
            return s.encode("utf-8"), None
        from ..normalized import NormalizedString

        ns = NormalizedString(s)
        nz.normalize(ns)
        return ns.get().encode("utf-8"), ns

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _program_many(self, chunks) -> List[tuple]:
        return [self._program(buf, lens) for buf, lens, _orig in chunks]


class WordLevelEngine(NormalizingEngine):
    def __init__(self, tokenizer, tables: dict, device):
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.tables = tables

    @staticmethod
    def build_tables(model, kind: str, device) -> Optional[dict]:
        """The engine's tables; None when two vocab entries share both
        hashes (the host path then runs everything)."""
        entries = {}
        for word, tid in model.vocab.items():
            bs = word.encode("utf-8")
            if not bs:
                continue
            key = (_roll_hash(bs, H1_MULT), _roll_hash(bs, H2_MULT))
            if key in entries:
                return None
            entries[key] = (len(bs), tid)
        if not entries:
            return None
        vtab = CuckooMergeTable(entries)
        s1, s2 = wordlevel_class_tables(kind)
        return tables_from_numpy(dict(cls_s1=s1, cls_s2=s2, vrows0=vtab.rows(0),
                                      vrows1=vtab.rows(1), vseed=vtab.seed,
                                      unk_id=model.vocab[model.unk_token]), device)

    @staticmethod
    def try_build(tokenizer, device) -> Optional["WordLevelEngine"]:
        """The engine, or None: another model or pre-tokenizer, an unk
        token outside the vocab (the host raises on it) or no tables."""
        from ..models.wordlevel import WordLevel

        m = tokenizer.model
        kind = pretok_kind(tokenizer.pre_tokenizer)
        if not isinstance(m, WordLevel) or m.unk_token not in m.vocab or kind is None:
            return None
        tables = WordLevelEngine.build_tables(m, kind, device)
        return None if tables is None else WordLevelEngine(tokenizer, tables, device)

    def _program(self, buf: np.ndarray, lengths: np.ndarray):
        return wordlevel_program(self._stage(buf), self._stage(lengths), self.tables)

    def _program_offsets(self, buf: np.ndarray, lengths: np.ndarray):
        return wordlevel_program(self._stage(buf), self._stage(lengths), self.tables,
                                 with_offsets=True)
