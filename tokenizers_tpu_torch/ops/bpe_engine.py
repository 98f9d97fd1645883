"""ByteLevelBpeEngine: the device path of byte-level BPE; port of
`tokenizers_tpu.ops.bpe_engine` for its two pipelines:

* **gpt2**: the ByteLevel pre-tokenizer with its GPT-2 regex split and a
  plain BPE model;
* **llama3**: Split(the llama-3 pattern, Isolated) then ByteLevel without
  its regex.

Either with BPE `ignore_merges`: a word that is itself a vocab entry
takes that id without merging, through a second cuckoo table of the
vocab's words keyed by their two rolling hashes.  `try_build` takes the
pipelines the JAX engine's takes (`tokenizers_tpu/ops/bpe_engine.py:96-141`).
Where the llama-3 Sequence's ByteLevel adds a prefix space, the reference
adds it to every llama-3 piece that lacks one, where the JAX engine adds
one to the whole text (its ids then differ from the reference's): the
port's program splits the text first and inserts those spaces on the
device (`bpe_encode.prefix_pieces`, boundary "llama3_prefix"), and the
offsets of such a pipeline are the host's (`supports_offsets` False).

The engine holds its tables as tensors on its device, and the persistent
cross-batch word cache (`bpe_dedup.WordCache`: 1M direct-mapped rows and a
16M-token append buffer), which `bpe_encode.encode_program_scan` updates
in place.  Same-shape chunks of one batch run in order through one
program call, so each distinct word of the batch is merged once.

The offsets path (`_program_offsets`) runs one chunk at a time through
`bpe_encode.encode_core_offsets`, with no word cache; so does each rank
on a mesh through `encode_core` (`_program_mesh`).
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from .bpe_dedup import H1_MULT, H2_MULT, WordCache
from .bpe_encode import encode_core, encode_core_offsets, encode_program_scan
from .engine_base import DeviceEngineBase
from .merge_table import CuckooMergeTable, consume_mins
from .unicode_tables import char_class_flat

TABLE_KEYS = ("byte2id", "cls_table", "merge_rows0", "merge_rows1", "merge_mclr")
WW_KEYS = ("ww_rows0", "ww_rows1")


def tables_from_numpy(d: dict, device) -> dict:
    """The engine's tables as tensors on `device` from numpy arrays keyed
    as the JAX engine's `_program_args()`: byte2id, cls_table,
    merge_rows0/1, merge_mclr and seed (a scalar); for the llama3 pipeline
    also ww_rows0/1 and ww_seed (the whole-word table).  `boundary` and
    `whole_word` default to gpt2 without the bypass."""
    out = {k: torch.from_numpy(np.array(d[k])).to(device) for k in TABLE_KEYS}
    out["seed"] = int(np.asarray(d["seed"]))
    out["boundary"] = d.get("boundary", "gpt2")
    out["whole_word"] = bool(d.get("whole_word", False))
    if out["whole_word"]:
        for k in WW_KEYS:
            out[k] = torch.from_numpy(np.array(d[k])).to(device)
        out["ww_seed"] = int(np.asarray(d["ww_seed"]))
    return out


def _roll_hash(data: bytes, mult: int) -> int:
    """The rolling word hash of `bpe_dedup.rolling_hash`, as int32."""
    h = 0
    for byte in data:
        h = (h * mult + byte + 1) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def whole_word_table(vocab: dict) -> Optional[CuckooMergeTable]:
    """The cuckoo table of the vocab's entries of two or more bytes, keyed
    (h1, h2) by their rolling hashes, valued (byte length, id); None when
    two entries share both hashes (the host path then runs everything)."""
    from ..pre_tokenizers.byte_level import CHAR_BYTES

    entries = {}
    for tok_str, tid in vocab.items():
        bs = bytearray()
        for c in tok_str:
            bb = CHAR_BYTES.get(c)
            if bb is None:
                break
            bs.append(bb)
        else:
            if len(bs) < 2:
                continue
            key = (_roll_hash(bytes(bs), H1_MULT), _roll_hash(bytes(bs), H2_MULT))
            if key in entries:
                return None
            entries[key] = (len(bs), tid)
    return CuckooMergeTable(entries)


class ByteLevelBpeEngine(DeviceEngineBase):
    supports_offsets = True
    WC_SLOTS = 1 << 20
    WC_CAP = 1 << 24

    def __init__(self, tokenizer, tables: dict, add_prefix_space: bool, device):
        self.tokenizer = tokenizer
        self.add_prefix_space = add_prefix_space
        if tables["boundary"] == "llama3_prefix":  # each piece's space comes on the device
            self.add_prefix_space, self.supports_offsets = False, False
        self.device = torch.device(device)
        self.tables = tables
        self._wc: Optional[WordCache] = None
        self._wc_lock = threading.Lock()  # the cache is updated in place

    @staticmethod
    def build_tables(model, device, boundary="gpt2") -> Optional[dict]:
        """The engine's tables from a BPE model; None when the vocab lacks
        a byte of the byte-level alphabet, or when two whole-word entries
        collide (the host path handles those)."""
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
        d = dict(
            byte2id=byte2id,
            cls_table=char_class_flat(),
            merge_rows0=table.rows8(0, mclr),
            merge_rows1=table.rows8(1, mclr),
            merge_mclr=mclr,
            seed=table.seed,
            boundary=boundary,
            whole_word=model.ignore_merges,
        )
        if model.ignore_merges:
            ww = whole_word_table(model.vocab)
            if ww is None:
                return None
            d.update(ww_rows0=ww.rows(0), ww_rows1=ww.rows(1), ww_seed=ww.seed)
        return tables_from_numpy(d, device)

    @staticmethod
    def pipeline(tokenizer):
        """(boundary, add_prefix_space) of the pipelines the JAX engine
        takes: no normalizer, BPE without dropout, affixes or byte
        fallback, and the ByteLevel pre-tokenizer with its regex ("gpt2")
        or the Sequence of the llama-3 Split (a regex, Isolated, not
        inverted) and ByteLevel without its regex ("llama3", or
        "llama3_prefix" with a prefix space); else None."""
        from ..models.bpe import BPE
        from ..pre_tokenizers import Sequence, Split
        from ..pre_tokenizers.byte_level import ByteLevel

        m, pt = tokenizer.model, tokenizer.pre_tokenizer
        if tokenizer.normalizer is not None or not isinstance(m, BPE) or m.dropout or (
                m.continuing_subword_prefix or m.end_of_word_suffix or m.byte_fallback):
            return None
        if isinstance(pt, ByteLevel) and pt.use_regex:
            return "gpt2", pt.add_prefix_space
        if isinstance(pt, Sequence) and len(pt) == 2 and isinstance(pt[0], Split) \
                and isinstance(pt[1], ByteLevel) and pt[0].is_llama3() and not pt[1].use_regex:
            return ("llama3_prefix" if pt[1].add_prefix_space else "llama3"), \
                pt[1].add_prefix_space
        return None

    @staticmethod
    def try_build(tokenizer, device) -> Optional["ByteLevelBpeEngine"]:
        """The engine for the tokenizer's pipeline (`pipeline`), or None:
        another pipeline, or no tables (`build_tables`).  On a card it
        builds every kernel first, all at once."""
        shape = ByteLevelBpeEngine.pipeline(tokenizer)
        if shape is None:
            return None
        boundary, add_prefix_space = shape
        tables = ByteLevelBpeEngine.build_tables(tokenizer.model, device, boundary)
        if tables is None:
            return None
        if torch.device(device).type == "cuda":
            from .kernel_build import build

            build()
        return ByteLevelBpeEngine(tokenizer, tables, add_prefix_space, device)

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
                    boundary=self.tables["boundary"],
                    whole_word=self.tables["whole_word"],
                )
                for k, i in enumerate(idxs):
                    out[i] = (ids[k], ntok[k], bad[k])
        return out

    def _program_mesh(self, buf: np.ndarray, lengths: np.ndarray, rows: int):
        """One rank's block of a chunk on the mesh: `encode_core` with no
        word cache (JAX's mesh branch) and the whole chunk's buffer sizes."""
        T = self.tables
        return encode_core(torch.from_numpy(buf).to(self.device),
                           torch.from_numpy(lengths).to(self.device), T, cache=None,
                           ascii_only=self._is_ascii(buf), boundary=T["boundary"],
                           whole_word=T["whole_word"], geom_rows=rows)

    def _program_offsets(self, buf: np.ndarray, lengths: np.ndarray):
        """One packed chunk through the offsets path: (ids, ntok, row_bad,
        starts, ends, word ids) on the engine's device."""
        T = self.tables
        return encode_core_offsets(
            torch.from_numpy(buf).to(self.device), torch.from_numpy(lengths).to(self.device),
            T, ascii_only=self._is_ascii(buf), boundary=T["boundary"],
            whole_word=T["whole_word"],
        )
