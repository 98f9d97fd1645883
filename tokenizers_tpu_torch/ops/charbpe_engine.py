"""CharBpeEngine: the device path of char-level BPE pipelines; port of
`tokenizers_tpu.ops.charbpe_engine`.

* Whitespace, WhitespaceSplit or BertPreTokenizer and BPE (the
  `CharBPETokenizer` recipe, `end_of_word_suffix="</w>"`);
* Metaspace and BPE (`SentencePieceBPETokenizer`): the space -> `▁`
  replacement and the prepend run on the card for ids, on the host for
  offsets (`_prepare_aligned`);
* no pre-tokenizer (the Llama-2 SPM shape: the normalizer prepends and
  replaces, byte fallback covers every byte); the row is one word, but
  where no vocab entry holds a `▁` after another char the merge loop
  takes each run from one such seam to the next as a word of its own
  (`meta_seams`: the same ids in tens of rounds, where the whole row
  takes about as many rounds as merges; the JAX program merges the row
  whole);
* with `continuing_subword_prefix`, `byte_fallback`, `fuse_unk` or no
  unk token (`models/bpe/model.rs:382-460`).

The normalizer runs on the host (`NormalizingEngine`); spans are in the
normalized bytes.  Its tables are tensors on its device: the per-char id
table (`charbpe_encode.build_char_id_tables`), the `<0xXX>` ids, the
merge table's [S, 8] rows and consume-mins, and the pre-split class
table.  The programs (`charbpe_encode.charbpe_program`, one chunk at a
time) merge through the keys kernel (B2) and the fused merge round (B1).

Metaspace rows grow to 2L + 4 bytes on the card, and B1 takes rows of at
most 65,536 positions, so the ids path takes Metaspace pieces of at most
16 KB (`_piece_max`): longer inputs split at safe seams (a seam before a
space starts a piece that the card does not prepend again), and one with
a piece still longer goes to the host.  The JAX package runs those rows
whole in plain XLA.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .bpe_merge2 import WORD_CAP
from .charbpe_encode import build_char_id_tables, charbpe_program
from .engine_base import MAX_L
from .longdoc import split_long
from .merge_table import CuckooMergeTable, consume_mins
from .wordlevel_encode import wordlevel_class_tables
from .wordlevel_engine import NormalizingEngine, pretok_kind

TABLE_KEYS = ("id_s1", "id_s2", "fb256", "merge_rows0", "merge_rows1", "merge_mclr")
CLS_KEYS = ("cls_s1", "cls_s2")
SCALAR_KEYS = ("unk_id", "seed")
METASPACE_PIECE = 1 << 14  # its rows, 2L + 4 with L <= 16384, fit B1's 65,536
META = b"\xe2\x96\x81"


def tables_from_numpy(d: dict, device) -> dict:
    """The engine's tables: the arrays of TABLE_KEYS (and CLS_KEYS when
    given) as tensors on `device`, the scalars of SCALAR_KEYS as ints."""
    out = {k: torch.from_numpy(np.array(d[k])).to(device)
           for k in TABLE_KEYS + CLS_KEYS if k in d}
    out.update({k: int(np.asarray(d[k])) for k in SCALAR_KEYS})
    return out


class CharBpeEngine(NormalizingEngine):
    def __init__(self, tokenizer, tables: dict, kind: str, device, prepend: bool = True):
        m = tokenizer.model
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.tables = tables
        self.kind = kind
        self.prepend = prepend
        self.flags = dict(byte_fallback=bool(m.byte_fallback), has_unk=m.unk_token is not None,
                          fuse_unk=bool(m.fuse_unk), prepend=prepend)
        self._cross_safe = None
        if kind == "none":
            # merge each run between seams on its own: identical ids, and a
            # round count set by the longest run, not the whole row
            self.flags["meta_seams"] = self.cross_safe() and "▁" in m.vocab

    @staticmethod
    def kind_of(tokenizer):
        """(kind, prepend) of the pipeline, or None where the engine does
        not take it."""
        from ..pre_tokenizers.metaspace import Metaspace

        pt = tokenizer.pre_tokenizer
        if pt is None:
            return "none", True
        if isinstance(pt, Metaspace):
            if pt.replacement != "▁" or not pt.split:
                return None
            # an input of the engine holds no added token, so it is its
            # text's first piece: "first" prepends as "always" does
            return "metaspace", pt.prepend_scheme in ("always", "first")
        kind = pretok_kind(pt)
        return None if kind is None else (kind, True)

    @staticmethod
    def build_tables(m, kind: str, device) -> Optional[dict]:
        """The engine's tables; None for what the engine refuses, as the
        JAX engine does: byte fallback with an affix, kind "none" without
        every `<0xXX>` token or with a vocab entry over WORD_CAP bytes, an
        unk token outside the vocab, no merges."""
        fb256 = np.full(256, -1, np.int32)
        if m.byte_fallback:
            if m.continuing_subword_prefix or m.end_of_word_suffix:
                return None  # the reference falls back on the affixed string's bytes
            for bb in range(256):
                fb256[bb] = m.vocab.get(f"<0x{bb:02X}>", -1)
        if kind == "none" and (not m.byte_fallback or (fb256 < 0).any() or max(
                len(k.encode("utf-8")) for k in m.vocab) > WORD_CAP):
            return None
        unk_id = -1
        if m.unk_token is not None:
            if m.unk_token not in m.vocab:
                return None  # the host raises on it
            unk_id = m.vocab[m.unk_token]
        if not m.merges:
            return None
        id_s1, id_s2 = build_char_id_tables(m.vocab, m.continuing_subword_prefix,
                                            m.end_of_word_suffix)
        table = CuckooMergeTable(m.merges)
        n_ids = max([len(m.vocab)] + [nid + 1 for (_r, nid) in m.merges.values()])
        mclr = consume_mins(m.merges, n_ids)
        d = dict(id_s1=id_s1, id_s2=id_s2, fb256=fb256, merge_rows0=table.rows8(0, mclr),
                 merge_rows1=table.rows8(1, mclr), merge_mclr=mclr, unk_id=max(unk_id, 0),
                 seed=table.seed)
        if kind not in ("metaspace", "none"):
            d["cls_s1"], d["cls_s2"] = wordlevel_class_tables(kind)
        return tables_from_numpy(d, device)

    @staticmethod
    def try_build(tokenizer, device) -> Optional["CharBpeEngine"]:
        """The engine, or None: another model or pre-tokenizer, BPE dropout
        or `ignore_merges`, or no tables (`build_tables`).  On a card it
        builds every kernel first, all at once."""
        from ..models.bpe import BPE

        m = tokenizer.model
        if not isinstance(m, BPE) or m.ignore_merges or m.dropout:
            return None
        kp = CharBpeEngine.kind_of(tokenizer)
        if kp is None:
            return None
        tables = CharBpeEngine.build_tables(m, kp[0], device)
        if tables is None:
            return None
        if torch.device(device).type == "cuda":
            from .kernel_build import build

            build()
        return CharBpeEngine(tokenizer, tables, kp[0], device, kp[1])

    # ---------------------------------------------------------------- pieces

    def _piece_max(self, offsets: bool) -> int:
        return METASPACE_PIECE if self.kind == "metaspace" and not offsets else MAX_L // 2

    def cross_safe(self) -> bool:
        """Kind "none" (the normalizer's `▁` in place of spaces): is a seam
        before a `▁` that follows another char safe?  Yes when no vocab
        entry holds a `▁` after another char: every token of the merge is
        a vocab entry, so none can cross the seam."""
        if self._cross_safe is None:
            self._cross_safe = not any(c == "▁" and k and key[k - 1] != "▁"
                                       for key in self.tokenizer.model.vocab
                                       for k, c in enumerate(key))
        return self._cross_safe

    def _split_long(self, data: bytes, target: int) -> List[bytes]:
        """Kind "none": split at the seams of `cross_safe` (none when it
        does not hold); other kinds split at spaces."""
        if self.kind != "none":
            return split_long(data, target)
        if not self.cross_safe():
            return [data]
        out = []
        start, n = 0, len(data)
        while n - start > target:
            seam = -1
            for i in range(min(n - 3, start + target), start, -1):
                if data[i:i + 3] == META and data[i - 3:i] != META:
                    seam = i
                    break
            if seam <= start:
                return [data]
            out.append(data[start:seam])
            start = seam
        out.append(data[start:])
        return out

    def _prepare_aligned(self, s: str):
        """The normalizer, and for Metaspace the replacement and prepend,
        on a NormalizedString (the offsets program takes the text so)."""
        from ..normalized import NormalizedString

        ns = NormalizedString(s)
        nz = self.tokenizer.normalizer
        if nz is not None:
            nz.normalize(ns)
        if self.kind == "metaspace":
            self.tokenizer.pre_tokenizer.apply(ns, first=True)
        return ns.get().encode("utf-8"), ns

    # -------------------------------------------------------------- programs

    def _program(self, buf: np.ndarray, lengths: np.ndarray):
        return charbpe_program(self._stage(buf), self._stage(lengths), self.tables,
                               kind=self.kind, **self.flags)

    def _program_offsets(self, buf: np.ndarray, lengths: np.ndarray):
        kind = "metaspace_pre" if self.kind == "metaspace" else self.kind
        return charbpe_program(self._stage(buf), self._stage(lengths), self.tables, kind=kind,
                               with_offsets=True, **self.flags)
