"""WordPieceEngine: the device path of the BERT pipeline (BertNormalizer,
BertPreTokenizer, WordPiece); port of `tokenizers_tpu.ops.wordpiece_engine`.

The engine holds its tables as tensors on its device (`tables_from_numpy`):
the normalizer and class tables of `bert_tables`, their ASCII byte maps,
the vocab's cuckoo table keyed by each entry's two rolling hashes (the
`##` continuation mixed in) and the hashes' powers; and the persistent
cross-batch word cache (`bpe_dedup.WordCache`: 1M direct-mapped rows and
a 16M-token append buffer, about 80 MB).

Routing: every ASCII chunk (read from the numpy buffer before it is
staged) takes the dedup program (`wordpiece_dedup.wordpiece_dedup_scan`,
same-shape chunks in order with the word cache), on every device; the
JAX package takes it only off the CPU.  On a mesh each rank runs its
block of a chunk through the dense program with no cache
(`_program_mesh`), as JAX's mesh routing does.  Chunks with multi-byte
characters take the dense `wordpiece_encode.wordpiece_program` (generic
variant), and so does everything on the offsets path (`_program_offsets`,
the ASCII variant for ASCII chunks), which gives spans in the original
chars of each piece (`offsets_space = "original_chars"`).

No kernel of `csrc/` runs on this path: the JAX package computes it in
plain XLA, and the port in torch ops.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from .bert_tables import bert_class_tables, bert_normalizer_tables
from .bpe_dedup import WordCache
from .bpe_engine import _roll_hash
from .engine_base import DeviceEngineBase
from .merge_table import CuckooMergeTable
from .wordpiece_dedup import wordpiece_dedup_scan
from .wordpiece_encode import CONT_MIX1, CONT_MIX2, H1_MULT, H2_MULT, wordpiece_program

TABLE_KEYS = ("norm_s1", "norm_ob", "norm_ol", "cls_s1", "cls_s2", "ascii_nb", "ascii_cls",
              "vrows0", "vrows1")
HOST_KEYS = ("pow1", "pow2")  # read one entry a sweep step: kept as numpy uint32
SCALAR_KEYS = ("vseed", "unk_id", "max_len", "max_word_chars")


def tables_from_numpy(d: dict, device) -> dict:
    """The engine's tables from numpy arrays keyed as the JAX engine's
    attributes without their `d_` prefix (norm_s1/ob/ol, cls_s1/s2,
    ascii_nb/cls, vrows0/1, pow1/2) and its scalars (vseed, unk_id,
    max_len, max_word_chars): the arrays as tensors on `device`, pow1/2 as
    uint32 numpy, the scalars as ints; and `ascii_ok`, the JAX engine's
    flag that ASCII chunks may take the byte-map variant."""
    out = {k: torch.from_numpy(np.array(d[k])).to(device) for k in TABLE_KEYS}
    out.update({k: np.asarray(d[k], np.uint32) for k in HOST_KEYS})
    out.update({k: int(np.asarray(d[k])) for k in SCALAR_KEYS})
    out["ascii_ok"] = bool(d["ascii_ok"])
    return out


def _powers(mult: int, n: int) -> np.ndarray:
    p = np.ones(n + 1, np.uint32)
    with np.errstate(over="ignore"):
        for i in range(1, n + 1):
            p[i] = p[i - 1] * np.uint32(mult)
    return p


def _ascii_maps(norm_tables, cls_tables):
    """(ok, byte map int32[256], class map int32[256]): each ASCII char's
    one normalized byte (255 = dropped) and its class, from the generic
    tables, so both variants agree byte for byte.  ok is False when an
    ASCII char normalizes to more than one byte or to a non-ASCII one."""
    s1, ob, ol = norm_tables
    c1, c2 = cls_tables
    nbmap = np.full(256, 255, np.int32)
    ok = True
    for cp in range(128):
        t = (int(s1[cp >> 8]) << 8) | cp
        ln = int(ol[t])
        if ln == 0:
            continue
        if ln == 1 and int(ob[t, 0]) < 128:
            nbmap[cp] = int(ob[t, 0])
        else:
            ok = False
            break
    clsmap = np.zeros(256, np.int32)
    clsmap[:128] = c2[(int(c1[0]) << 8) + np.arange(128)]
    return ok, nbmap, clsmap


class WordPieceEngine(DeviceEngineBase):
    supports_offsets = True
    offsets_space = "original_chars"
    WC_SLOTS = 1 << 20
    WC_CAP = 1 << 24

    def __init__(self, tokenizer, tables: dict, device):
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.tables = tables
        self._wc: Optional[WordCache] = None
        self._wc_lock = threading.Lock()  # the cache is updated in place

    @staticmethod
    def build_tables(model, normalizer, device) -> Optional[dict]:
        """The engine's tables; None when two vocab entries share both
        hashes or an entry is longer than 128 bytes (the host path then
        runs everything)."""
        prefix = model.continuing_subword_prefix or ""
        entries = {}
        max_len = 1
        for tok_str, tid in model.vocab.items():
            cont = bool(prefix) and tok_str.startswith(prefix)
            bs = (tok_str[len(prefix):] if cont else tok_str).encode("utf-8")
            if not bs:
                continue
            k1 = _roll_hash(bs, H1_MULT) ^ (CONT_MIX1 if cont else 0)
            k2 = _roll_hash(bs, H2_MULT) ^ (CONT_MIX2 if cont else 0)
            if (k1, k2) in entries:
                return None
            entries[(k1, k2)] = (len(bs), tid)
            max_len = max(max_len, len(bs))
        if max_len > 128:
            return None
        vtab = CuckooMergeTable(entries)
        norm = bert_normalizer_tables(*normalizer.flags)
        cls = bert_class_tables()
        ascii_ok, nbmap, clsmap = _ascii_maps(norm, cls)
        d = dict(norm_s1=norm[0], norm_ob=norm[1], norm_ol=norm[2], cls_s1=cls[0],
                 cls_s2=cls[1], ascii_nb=nbmap, ascii_cls=clsmap, vrows0=vtab.rows(0),
                 vrows1=vtab.rows(1), pow1=_powers(H1_MULT, max_len),
                 pow2=_powers(H2_MULT, max_len), vseed=vtab.seed,
                 unk_id=model.vocab[model.unk_token], max_len=max_len,
                 max_word_chars=model.max_input_chars_per_word, ascii_ok=ascii_ok)
        return tables_from_numpy(d, device)

    @staticmethod
    def try_build(tokenizer, device) -> Optional["WordPieceEngine"]:
        """The engine for the BERT pipeline, or None: another pipeline, an
        unk token outside the vocab, or no tables (`build_tables`)."""
        from ..models.wordpiece import WordPiece
        from ..normalizers.bert import BertNormalizer
        from ..pre_tokenizers.bert import BertPreTokenizer

        m = tokenizer.model
        if not (isinstance(m, WordPiece) and isinstance(tokenizer.pre_tokenizer, BertPreTokenizer)
                and isinstance(tokenizer.normalizer, BertNormalizer)
                and m.unk_token in m.vocab):
            return None
        tables = WordPieceEngine.build_tables(m, tokenizer.normalizer, device)
        return None if tables is None else WordPieceEngine(tokenizer, tables, device)

    def _ensure_cache(self) -> WordCache:
        if self._wc is None:
            self._wc = WordCache(self.WC_SLOTS, self.WC_CAP, self.device)
        return self._wc

    @staticmethod
    def _is_ascii(buf: np.ndarray) -> bool:
        return int(buf.max(initial=0)) < 128

    def _use_dedup(self, buf: np.ndarray) -> bool:
        return self.tables["ascii_ok"] and self._is_ascii(buf)

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _dense(self, buf: np.ndarray, lengths: np.ndarray, with_offsets: bool):
        ascii_fast = self._use_dedup(buf)
        return wordpiece_program(self._stage(buf), self._stage(lengths), self.tables,
                                 expand=1 if ascii_fast else 2, with_offsets=with_offsets,
                                 ascii_only=ascii_fast)

    def _program_many(self, chunks) -> List[tuple]:
        """Same-shape ASCII chunks (in first-seen order) through one
        `wordpiece_dedup_scan` call with the word cache; other chunks one
        by one through the dense program."""
        groups: dict = {}
        for i, (buf, _lens, _orig) in enumerate(chunks):
            groups.setdefault(buf.shape if self._use_dedup(buf) else None, []).append(i)
        out: List[Optional[tuple]] = [None] * len(chunks)
        for key, idxs in groups.items():
            if key is None:
                for i in idxs:
                    out[i] = self._dense(chunks[i][0], chunks[i][1], False)
                continue
            with self._wc_lock:
                ids, ntok, bad = wordpiece_dedup_scan(
                    self._stage(np.stack([chunks[i][0] for i in idxs])),
                    self._stage(np.stack([chunks[i][1] for i in idxs])),
                    self.tables, cache=self._ensure_cache())
            for k, i in enumerate(idxs):
                out[i] = (ids[k], ntok[k], bad[k])
        return out

    def _program_mesh(self, buf: np.ndarray, lengths: np.ndarray, rows: int):
        """One rank's block of a chunk on the mesh: the dense program, no
        scan and no cache (JAX's mesh routing)."""
        return self._dense(buf, lengths, False)

    def _program_offsets(self, buf: np.ndarray, lengths: np.ndarray):
        """One packed chunk through the dense program with offsets: (ids,
        ntok, row_bad, start char, end char, word rank), spans in the
        original chars of each row."""
        return self._dense(buf, lengths, True)
