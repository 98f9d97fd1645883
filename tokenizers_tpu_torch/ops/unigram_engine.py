"""UnigramEngine: the device path of the SentencePiece Unigram pipeline
(Nmt and the `" {2,}"` space collapse, Metaspace, Unigram: the xlnet-style
config of the reference's `unigram_benchmark.rs`, with or without byte
fallback); port of `tokenizers_tpu.ops.unigram_engine`.

The engine holds its tables as tensors on its device: the Nmt + space
class table (`unigram_encode.nmt_metaspace_class_table`), the vocab's
cuckoo table keyed by each piece's two rolling hashes as [S, 8] rows
(key1, key2, byte length, id, score hi bits, score lo bits, 0, 0: the
double-float split of its f64 score, `unigram_dedup.dd_split`), the f64
scores slot-aligned with the two tables, the hashes' powers, the unk
score (`min_score - 10`, f64 and split) and the byte-fallback table; and
the persistent cross-batch word cache (`bpe_dedup.WordCache`).

Routing, on every device (the JAX package's accelerator routing; its
CPU route is the dense `unigram_program`, which the port does not
have): ids take the dedup program with the word cache
(`unigram_dedup.unigram_dedup_scan`, same-shape chunks in order), whose
flagged words come back as patch records the host splices
(`_encode_word_host`); on a mesh each rank runs its block of a chunk
through the same program with no cache (`_program_mesh`), its patch
records rebased to the chunk's rows; offsets take the packed f64 program
(`unigram_packed.unigram_program_packed`), spans in original chars
(`offsets_space = "original_chars"`).

No kernel of `csrc/` runs on this path: the JAX package computes it in
plain XLA, and the port in torch ops.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ..normalizers import Nmt
from .bpe_dedup import WordCache
from .bpe_engine import _roll_hash
from .engine_base import DeviceEngineBase
from .merge_table import CuckooMergeTable, _hash
from .unigram_dedup import dd_split, unigram_dedup_core, unigram_dedup_scan
from .unigram_encode import nmt_metaspace_class_table
from .unigram_packed import unigram_program_packed
from .wordpiece_encode import H1_MULT, H2_MULT
from .wordpiece_engine import _powers

MAX_PIECE_BYTES = 64


def unigram_tables(pieces, unk_id: int, min_score: float, bf_ids, device) -> Optional[dict]:
    """The engine's tables for `pieces` [(piece, f64 score)], or None where
    two distinct pieces share both 64 bits of hash, a piece is over 64
    bytes, or one cannot be placed in the table (the host path then runs
    everything).  A piece listed twice takes its last id and score, as
    the reference's `token_to_ids`.  `bf_ids`: the 256 byte-fallback ids,
    or None."""
    entries, key_bytes = {}, {}
    max_len = 4
    for i, (piece, score) in enumerate(pieces):
        bs = piece.encode("utf-8")
        if not bs:
            continue
        key = (_roll_hash(bs, H1_MULT), _roll_hash(bs, H2_MULT))
        if key in entries and key_bytes[key] != bs:
            return None  # a true 64-bit collision: the table cannot tell them apart
        entries[key] = (len(bs), i, float(score))
        key_bytes[key] = bs
        max_len = max(max_len, len(bs))
    if max_len > MAX_PIECE_BYTES:
        return None
    vtab = CuckooMergeTable({k: (ln, i) for k, (ln, i, _s) in entries.items()})
    scores = np.zeros((2, vtab.size), np.float64)
    for (k1, k2), (_l, _i, sc) in entries.items():
        for t in (0, 1):
            h = int(_hash(np.array([k1]), np.array([k2]), vtab.seed, vtab.mask, t)[0])
            if vtab.key_a[t][h] == k1 and vtab.key_b[t][h] == k2:
                scores[t][h] = sc
                break
        else:
            return None
    unk_score = np.float64(min_score - 10.0)
    uhi, ulo = dd_split(np.asarray([unk_score]))
    rows = []
    for t in (0, 1):
        hi, lo = dd_split(scores[t])
        z = np.zeros_like(vtab.rank[t])
        rows.append(np.stack([vtab.key_a[t], vtab.key_b[t], vtab.rank[t], vtab.new_id[t],
                              hi.view(np.int32), lo.view(np.int32), z, z], -1).astype(np.int32))
    s1, s2 = nmt_metaspace_class_table()

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return dict(
        cls_s1=dev(s1), cls_s2=dev(s2), vrows0=dev(rows[0]), vrows1=dev(rows[1]),
        vscore=dev(scores), vseed=int(vtab.seed),
        pow1=_powers(H1_MULT, max_len), pow2=_powers(H2_MULT, max_len),
        unk_id=int(unk_id), unk_score=float(unk_score), unk_hi=float(uhi[0]),
        unk_lo=float(ulo[0]), max_len=max_len,
        bf_tab=None if bf_ids is None else dev(np.asarray(bf_ids, np.int32)),
    )


class UnigramEngine(DeviceEngineBase):
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
    def try_build(tokenizer, device) -> Optional["UnigramEngine"]:
        """The engine for the Unigram pipeline, or None: another pipeline,
        no unk id, byte fallback without all 256 `<0xXX>` pieces, or no
        tables (`unigram_tables`)."""
        from ..models.unigram import Unigram
        from ..normalizers import Replace, Sequence
        from ..pre_tokenizers.metaspace import Metaspace

        m, nz, pt = tokenizer.model, tokenizer.normalizer, tokenizer.pre_tokenizer
        if not isinstance(m, Unigram) or m.unk_id is None or not m.fuse_unk:
            return None
        bf_ids = None
        if m.byte_fallback:
            bf_ids = [m.vocab.get("<0x%02X>" % b) for b in range(256)]
            if any(i is None for i in bf_ids):
                return None
        if not (isinstance(nz, Sequence) and len(nz.normalizers) == 2
                and isinstance(nz.normalizers[0], Nmt)
                and isinstance(nz.normalizers[1], Replace) and nz.normalizers[1].regex
                and nz.normalizers[1].pattern == " {2,}" and nz.normalizers[1].content == " "):
            return None
        if not (isinstance(pt, Metaspace) and pt.replacement == "▁" and pt.split
                and pt.prepend_scheme == "always"):
            return None
        tables = unigram_tables(m.pieces, m.unk_id, m.min_score, bf_ids, device)
        return None if tables is None else UnigramEngine(tokenizer, tables, device)

    def _ensure_cache(self) -> WordCache:
        if self._wc is None:
            self._wc = WordCache(self.WC_SLOTS, self.WC_CAP, self.device)
        return self._wc

    def _stage(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _program_many(self, chunks) -> List[tuple]:
        """Same-shape chunks (in first-seen order) through one
        `unigram_dedup_scan` call with the word cache: per chunk (ids,
        ntok, row_bad, (patch table, patch count))."""
        groups: dict = {}
        for i, (buf, _lens, _orig) in enumerate(chunks):
            groups.setdefault(buf.shape, []).append(i)
        out: List[Optional[tuple]] = [None] * len(chunks)
        for idxs in groups.values():
            with self._wc_lock:
                ids, ntok, bad, ptab, nflag = unigram_dedup_scan(
                    self._stage(np.stack([chunks[i][0] for i in idxs])),
                    self._stage(np.stack([chunks[i][1] for i in idxs])),
                    self.tables, cache=self._ensure_cache())
            for k, i in enumerate(idxs):
                out[i] = (ids[k], ntok[k], bad[k], (ptab[k], nflag[k]))
        return out

    def _program_mesh(self, buf: np.ndarray, lengths: np.ndarray, rows: int):
        """One rank's block of a chunk on the mesh: the dedup program with
        no word cache and the whole chunk's buffer sizes, (ids, ntok,
        row_bad, (patch table, patch count))."""
        ids, ntok, bad, ptab, nflag = unigram_dedup_core(self._stage(buf), self._stage(lengths),
                                                         self.tables, cache=None, geom_rows=rows)
        return ids, ntok, bad, (ptab, nflag)

    def _program_offsets(self, buf: np.ndarray, lengths: np.ndarray):
        """One packed chunk through the packed f64 program with offsets:
        (ids, ntok, row_bad, start char, end char, word rank)."""
        return unigram_program_packed(self._stage(buf), self._stage(lengths), self.tables,
                                      with_offsets=True)

    def _token_strings(self, ids, text=None, st=None, en=None):
        """An unk token's string is the text it covers (the reference emits
        the fused piece) less the chars Nmt deletes; the others' are their
        pieces.  `st`, `en`: the tokens' char spans in `text`."""
        vr = self.tokenizer.model.vocab_r
        unk = self.tables["unk_id"]
        return ["".join(c for c in text[int(st[k]):int(en[k])] if ord(c) not in Nmt.FILTERED)
                if t == unk else vr[t] for k, t in enumerate(ids)]

    def _encode_word_host(self, prepared: bytes, col: int, wlen: int):
        """Host ids of one flagged word: `col`, `wlen` address the device's
        normalized stream, rebuilt here (`_norm_stream`); the word is
        encoded by the f64 host model."""
        piece = self._norm_stream(prepared)[col:col + wlen]
        try:
            word = piece.decode("utf-8")
        except UnicodeDecodeError:
            return None
        return np.asarray(self.tokenizer.model.tokenize_ids(word), np.int32)

    def _norm_stream(self, prepared: bytes) -> bytes:
        """The device programs' normalized text, on the host: the
        normalizer, then Metaspace's replacement and prepend."""
        meta = self.tokenizer.normalizer.normalize_str(prepared.decode("utf-8")).replace(" ", "▁")
        if not meta.startswith("▁"):
            meta = "▁" + meta
        return meta.encode("utf-8")
