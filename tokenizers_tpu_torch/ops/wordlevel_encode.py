"""WordLevel encode on packed [B, L] byte chunks: pre-split by char-class
tables, then one exact whole-word vocab lookup per word; port of
`tokenizers_tpu.ops.wordlevel_encode` (plain XLA there, torch ops here:
no kernel of `csrc/` runs on this path).

1. Pre-split by a two-stage codepoint -> class table
   (`wordlevel_class_tables`):
     * "whitespace": `\\w+|[^\\w\\s]+` (reference
       `pre_tokenizers/whitespace.rs:12`), classes WL_A (\\w), WL_B and WL_WS;
     * "whitespace_split": splits on whitespace;
     * "bert": whitespace removed, punctuation isolated (BertPreTokenizer).
   The first two are committed files (`data/wl_class_*.npz`, written by
   `python -m tokenizers_tpu_torch.data.regen` from the `regex` module's
   \\w, as the JAX package builds them); "bert" remaps the port's
   `bert_tables` classes.  The host pre-tokenizers split by the same
   tables (`pre_tokenizers/whitespace.py`).
2. Each word's two rolling hashes by a segmented affine scan, in closed
   form (`bpe_dedup.rolling_hash` with `keep`): whitespace bytes are the
   scan's identity, so the hash at any position from a word's last byte
   to the next head is the word's.
3. The vocab's cuckoo table (`merge_table`, keyed by the two hashes,
   valued by byte length and id) maps each word to its id, unk on a miss;
   one token per word, packed to [B, L // 2 + 1].

Hash equality with the exact length stands in for string equality.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .bert_tables import BERT_OTHER, BERT_PUNCT, BERT_WS, PAGE_BITS, bert_class_tables
from .bpe_dedup import H1_MULT, H2_MULT, _to_i32, rolling_hash
from .bpe_merge2 import _shift_prev, fill_next
from .merge_table import hash_pair
from .wordpiece_encode import decode_chars

# pre-split classes
WL_WS = 0
WL_A = 1  # \w word chars ("whitespace") or everything but whitespace
WL_B = 2  # runs of non-word non-space chars ("whitespace")
WL_PUNCT = 3  # a word of its own ("bert")
WL_END = -2

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
KINDS = ("whitespace", "whitespace_split", "bert")
_cls_cache: dict = {}


def class_table_path(kind: str) -> str:
    return os.path.join(DATA, f"wl_class_{kind}.npz")


def wordlevel_class_tables(kind: str):
    """(s1 int32[MAX_CP >> 8], s2 int8[n_pages * 256]) of a pre-split kind."""
    if kind not in _cls_cache:
        if kind == "bert":
            s1, s2 = bert_class_tables()
            remap = np.zeros(256, np.int8)
            remap[[BERT_WS, BERT_PUNCT, BERT_OTHER]] = [WL_WS, WL_PUNCT, WL_A]
            _cls_cache[kind] = (s1, remap[s2.view(np.uint8)])
        elif kind in KINDS:
            with np.load(class_table_path(kind)) as z:
                _cls_cache[kind] = (z["s1"].astype(np.int32), z["s2"].astype(np.int8))
        else:
            raise ValueError(kind)
    return _cls_cache[kind]


def char_classes(kind: str, text: str) -> list:
    """The class of each char of `text` (the host pre-tokenizers')."""
    s1, s2 = wordlevel_class_tables(kind)
    return [int(s2[(int(s1[ord(c) >> PAGE_BITS]) << PAGE_BITS) | (ord(c) & 255)])
            for c in text]


def word_boundaries(b, inb, cls_s1, cls_s2):
    """(bnd, is_word_b): word-head bytes and bytes inside words of packed
    UTF-8 rows b int32 [B, L] under a class table; the rule of
    `wordlevel_program`, shared with `charbpe_encode`."""
    cp, is_start, _ = decode_chars(b, inb)
    page = cls_s1[(cp >> PAGE_BITS).to(torch.int64)].to(torch.int64)
    cls = cls_s2[(page << PAGE_BITS) | (cp & 255).to(torch.int64)].to(torch.int32)
    f = torch.where(is_start, cls, -1)
    for _ in range(3):  # fill the class over continuation bytes
        f = torch.where(f >= 0, f, _shift_prev(f, -1))
    cls_fill = torch.where(inb, f, WL_END)
    is_word_b = inb & (cls_fill != WL_WS)
    prev_cls = _shift_prev(cls_fill, WL_END)
    bnd = is_start & is_word_b & (
        (prev_cls == WL_WS) | (prev_cls == WL_END) | (cls != prev_cls) | (cls == WL_PUNCT))
    return bnd, is_word_b


def pack_rows(x, keep, k, width, fill):
    """x at the positions `keep` (their ordinals k), packed to [B, width];
    ordinals >= width are dropped."""
    B = x.shape[0]
    tgt = torch.where(keep, torch.clamp(k, max=width), width).to(torch.int64)
    out = torch.full((B, width + 1), fill, dtype=torch.int32, device=x.device)
    out.scatter_(1, tgt, torch.where(keep, x, fill).to(torch.int32))
    return out[:, :width].contiguous()


def wordlevel_program(bytes_u8, lengths, T, with_offsets=False):
    """-> (ids int32[B, W], ntok int32[B], row_bad bool[B]), W = L // 2 + 1;
    with `with_offsets` also (starts, ends, words): each token's byte span
    in the row (the host-normalized text) and its word index.  row_bad:
    rows with more words than W.  `T`: the engine's tables (cls_s1,
    cls_s2, vrows0, vrows1, vseed, unk_id)."""
    B, L = bytes_u8.shape
    dev = bytes_u8.device
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(B, L)
    inb = pos < lengths[:, None]
    b = torch.where(inb, bytes_u8.to(torch.int32), 0)
    bnd, is_word_b = word_boundaries(b, inb, T["cls_s1"], T["cls_s2"])

    # whole-word hashes: bytes outside words leave them as they were, so
    # the hash from a word's last byte to the next head is the word's
    h1 = _to_i32(rolling_hash(b, bnd, H1_MULT, keep=is_word_b))
    h2 = _to_i32(rolling_hash(b, bnd, H2_MULT, keep=is_word_b))
    wlen_inc = torch.cumsum(is_word_b.to(torch.int32), 1, dtype=torch.int32)
    # each word's final hash and length, read at its last word byte (the
    # byte before the next head, or the row's last) and delivered to its head
    (nh,), nfnd = fill_next([torch.where(bnd, pos, 0)], bnd, k_steps=17)
    last = torch.where(nfnd, nh - 1, lengths[:, None] - 1).clamp(0, L - 1).to(torch.int64)
    wh1, wh2 = h1.gather(1, last), h2.gather(1, last)
    wl = wlen_inc.gather(1, last) - (wlen_inc - is_word_b.to(torch.int32))

    rows0, rows1 = T["vrows0"], T["vrows1"]
    vmask = rows0.shape[0] - 1
    r0 = rows0[hash_pair(wh1, wh2, T["vseed"], vmask, 0).to(torch.int64)]
    r1 = rows1[hash_pair(wh1, wh2, T["vseed"], vmask, 1).to(torch.int64)]
    hit0 = (r0[..., 0] == wh1) & (r0[..., 1] == wh2)
    hit1 = (r1[..., 0] == wh1) & (r1[..., 1] == wh2)
    stored_l = torch.where(hit0, r0[..., 2], r1[..., 2])
    stored_id = torch.where(hit0, r0[..., 3], r1[..., 3])
    hit = bnd & (hit0 | hit1) & (stored_l == wl)
    out_id = torch.where(hit, stored_id, T["unk_id"])

    W = L // 2 + 1
    k = torch.cumsum(bnd.to(torch.int32), 1, dtype=torch.int32) - 1
    ntok = bnd.sum(1, dtype=torch.int32)
    row_bad = ntok > W
    ids = pack_rows(out_id, bnd, k, W, -1)
    if not with_offsets:
        return ids, ntok, row_bad
    starts = pack_rows(pos, bnd, k, W, 0)
    ends = pack_rows(pos + wl, bnd, k, W, 0)
    opos = torch.arange(W, device=dev, dtype=torch.int32).expand(B, W)
    words = torch.where(opos < ntok[:, None], opos, -1)
    return ids, ntok, row_bad, starts, ends, words
