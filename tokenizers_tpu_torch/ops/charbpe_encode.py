"""Char-level BPE encode on packed [B, L] byte chunks; port of
`tokenizers_tpu.ops.charbpe_encode`.

The BPE pipelines whose first symbols are characters (with affixes), not
bytes (reference `models/bpe/model.rs:382-460` `merge_word`):

* Whitespace, WhitespaceSplit or BertPreTokenizer and BPE (the
  `CharBPETokenizer` recipe: BertNormalizer, BertPreTokenizer and
  `end_of_word_suffix="</w>"`); words from the class tables of
  `wordlevel_encode` ("whitespace", "whitespace_split", "bert");
* Metaspace and BPE (the `SentencePieceBPETokenizer` recipe: NFKC,
  Metaspace, `fuse_unk`): space -> `▁` and the prepend run on the card
  (`metaspace_expand`, rows of 2L + 4 bytes; kind "metaspace"), so long
  inputs still split at spaces; the offsets path gets the text already
  replaced on the host (kind "metaspace_pre");
* no pre-tokenizer (the Llama-2 SPM shape, with byte fallback; kind
  "none"): the whole text is one word.

Seeding, per char, as `merge_word`: the vocab id of its affixed string
(`prefix + c` past a word's first char, `c + suffix` on its last; one
gather in the [page, 4] table of `build_char_id_tables`); else its
bytes' `<0xXX>` ids with byte fallback; else unk (runs of unk chars of a
word fused to the first with `fuse_unk`); else (no unk token) dropped.
Then the merge loop, `bpe_merge2.run_merge_phases`: the keys kernel (B2)
and the fused merge round (B1) of `csrc/merge_round.cu`, on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .bert_tables import MAX_CP, PAGE_BITS
from .bpe_encode import take256
from .bpe_merge2 import (
    WORD_CAP, _rev_cummin, _shift_next, _shift_prev, fill_prev, run_merge_phases,
)
from .wordlevel_encode import pack_rows, word_boundaries
from .wordpiece_encode import decode_chars, fill_last

# how a char is emitted
K_KNOWN = 0
K_FB = 1
K_UNK = 2
K_DROP = 3

META = (0xE2, 0x96, 0x81)  # '▁'
BIGP = 0x7FFFFFFF


def build_char_id_tables(vocab, prefix, suffix):
    """(page_of int32[MAX_CP >> 8], s2 int32[(pages + 1) * 256, 4]): each
    codepoint's vocab ids as [plain, prefix + c, c + suffix,
    prefix + c + suffix], -1 where missing; page 0 misses everywhere.
    An absent affix falls back to the column without it, so the card
    picks a column with no branch on the configuration."""
    plain, pre, suf, presuf = {}, {}, {}, {}
    lp = len(prefix) if prefix else 0
    ls = len(suffix) if suffix else 0
    for key, tid in vocab.items():
        if len(key) == 1:
            plain[ord(key)] = tid
        if prefix and key.startswith(prefix) and len(key) == lp + 1:
            pre[ord(key[lp])] = tid
        if suffix and key.endswith(suffix) and len(key) == ls + 1:
            suf[ord(key[0])] = tid
        if (prefix and suffix and key.startswith(prefix) and key.endswith(suffix)
                and len(key) == lp + ls + 1):
            presuf[ord(key[lp])] = tid
    if not prefix:
        pre, presuf = plain, suf
    if not suffix:
        suf, presuf = plain, pre
    if not prefix and not suffix:
        presuf = plain
    cols = [plain, pre, suf, presuf]
    used = sorted({cp >> PAGE_BITS for col in cols for cp in col})
    page_of = np.zeros(MAX_CP >> PAGE_BITS, np.int32)
    page_of[used] = np.arange(1, len(used) + 1, dtype=np.int32)
    s2 = np.full(((len(used) + 1) << PAGE_BITS, 4), -1, np.int32)
    for c, col in enumerate(cols):
        for cp, tid in col.items():
            s2[(page_of[cp >> PAGE_BITS] << PAGE_BITS) | (cp & 255), c] = tid
    return page_of, s2


def metaspace_expand(b, inb, lengths, prepend):
    """Metaspace on the card: each space becomes `▁` (3 bytes), and `▁` is
    prepended where `prepend` and the text starts with neither a space nor
    `▁` (reference `pre_tokenizers/metaspace.rs:123-147`: replace, then
    prepend).  Returns (nb int32 [B, 2L + 4], in-text mask, length,
    word heads: each `▁` and the text start, overflow: rows whose text
    outgrew 2L + 4)."""
    B, L = b.shape
    L2 = 2 * L + 4
    dev = b.device
    space = inb & (b == 0x20)
    out_len = torch.where(inb, torch.where(space, 3, 1), 0)
    orig_meta = (inb & (b == META[0]) & (_shift_next(b, 0) == META[1])
                 & (_shift_next(b, 0, 2) == META[2]))
    starts_meta = (b[:, 0] == 0x20) | orig_meta[:, 0]
    do_prepend = bool(prepend) & (lengths > 0) & ~starts_meta
    base = torch.where(do_prepend, 3, 0).to(torch.int32)
    csum = torch.cumsum(out_len, 1, dtype=torch.int32)
    opos = base[:, None] + csum - out_len
    total = base + csum[:, -1] if L else base
    overflow = total > L2

    junk = L2 + 3  # a column past the row: written, then cut away

    def at(mask, col):
        return torch.where(mask & (col < junk), col, junk).to(torch.int64)

    nb = torch.zeros((B, L2 + 4), dtype=torch.int32, device=dev)
    nb[:, :3] = torch.where(do_prepend[:, None], torch.tensor(META, device=dev), 0)
    for k, v in enumerate(META):
        nb.scatter_(1, at(space, opos + k), torch.where(space, v, 0).to(torch.int32))
    copy = inb & ~space
    nb.scatter_(1, at(copy, opos), torch.where(copy, b, 0))
    wbnd = torch.zeros((B, L2 + 4), dtype=torch.bool, device=dev)
    head = space | orig_meta
    wbnd.scatter_(1, at(head, opos), head)  # heads land on distinct columns
    wbnd[:, 0] |= do_prepend | (lengths > 0)
    npos = torch.arange(L2, device=dev).expand(B, L2)
    ninb = npos < total[:, None]
    return (torch.where(ninb, nb[:, :L2], 0), ninb, total, wbnd[:, :L2] & ninb, overflow)


def charbpe_program(bytes_u8, lengths, T, kind="whitespace", byte_fallback=False,
                    has_unk=True, fuse_unk=False, prepend=True, with_offsets=False,
                    meta_seams=False):
    """-> (ids int32[B, OUT], ntok int32[B], row_bad bool[B]); with
    `with_offsets` also (starts, ends, words): each token's byte span in
    the row's text (the host-normalized text; for kind "metaspace_pre"
    with `▁` already in it) and its word id.  `T`: the engine's tables
    (id_s1, id_s2, fb256, unk_id, merge_rows0/1, seed, merge_mclr and,
    for the class-table kinds, cls_s1/cls_s2).  row_bad: a word over
    WORD_CAP bytes (not for "none"), a Metaspace row that outgrew its
    buffer, or a merge buffer overflow.  `meta_seams` (kind "none"):
    merge each run between `▁` seams on its own."""
    B, L = bytes_u8.shape
    dev = bytes_u8.device
    pos0 = torch.arange(L, device=dev, dtype=torch.int32).expand(B, L)
    inb = pos0 < lengths[:, None]
    b = torch.where(inb, bytes_u8.to(torch.int32), 0)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    total = lengths

    if kind == "metaspace":
        b, inb, total, bnd, overflow = metaspace_expand(b, inb, lengths, prepend)
        is_word_b = inb
    elif kind == "metaspace_pre":
        # ' ' -> '▁' and the prepend ran on the host (exact alignments);
        # words start at each '▁' and at the text start
        is_meta = (inb & (b == META[0]) & (_shift_next(b, 0) == META[1])
                   & (_shift_next(b, 0, 2) == META[2]))
        bnd = (is_meta | (pos0 == 0)) & inb
        is_word_b = inb
    elif kind == "none":
        # one word per row; the engine requires every <0xXX> token, so no
        # unk run is fused and the gaps inside the word stay short
        bnd = (pos0 == 0) & (lengths[:, None] > 0)
        is_word_b = inb
        if meta_seams:
            # merge segments: a '▁' after another char starts one (no vocab
            # entry holds such a pair, so no token crosses it)
            is_meta = (inb & (b == META[0]) & (_shift_next(b, 0) == META[1])
                       & (_shift_next(b, 0, 2) == META[2]))
            seg_head = bnd | (is_meta & ~_shift_prev(is_meta, False, 3))
    else:
        bnd, is_word_b = word_boundaries(b, inb, T["cls_s1"], T["cls_s2"])
    L2 = b.shape[1]
    pos = torch.arange(L2, device=dev, dtype=torch.int32).expand(B, L2)
    cp, is_start, charlen = decode_chars(b, inb)
    cstart = is_start & is_word_b

    # ---- word extents (word bytes run on from the head in every kind) ---
    nxt_bnd = _shift_next(_rev_cummin(torch.where(bnd, pos, BIGP)), BIGP)
    wb_inc = torch.cumsum(is_word_b.to(torch.int32), 1, dtype=torch.int32)
    bnd_end = torch.minimum(nxt_bnd, total[:, None])  # exclusive
    wlen_at_head = (wb_inc.gather(1, (bnd_end - 1).clamp(0, L2 - 1).to(torch.int64))
                    - wb_inc + is_word_b.to(torch.int32))
    row_bad = overflow
    if kind != "none":  # there the longest vocab entry bounds the gaps
        row_bad = row_bad | (bnd & (wlen_at_head > WORD_CAP)).any(1)
    wend_f = fill_last(torch.where(bnd, pos + wlen_at_head, 0), 0)  # word end, exclusive

    # ---- each char's id, by its place in the word --------------------------
    is_first = cstart & bnd
    is_last = cstart & ((pos + charlen) >= wend_f)
    variant = torch.where(is_first, 0, 1) + torch.where(is_last, 2, 0)
    page = T["id_s1"][(cp >> PAGE_BITS).to(torch.int64)].to(torch.int64)
    vrow = T["id_s2"][(page << PAGE_BITS) | (cp & 255).to(torch.int64)]
    cid = vrow.gather(-1, variant.to(torch.int64)[..., None])[..., 0]
    known = cstart & (cid >= 0)

    # ---- a miss: byte fallback, then unk, then dropped ----------------------
    fb_char = torch.zeros_like(known)
    if byte_fallback:
        fb = take256(b, T["fb256"])
        fb_ok = fb >= 0
        ok = fb_ok
        for k in range(1, 4):  # every byte of the char has its token
            ok = ok & (_shift_next(fb_ok, True, k) | (charlen <= k))
        fb_char = cstart & ~known & ok
    unk_char = cstart & ~known & ~fb_char if has_unk else torch.zeros_like(known)
    kind_c = torch.where(known, K_KNOWN, torch.where(fb_char, K_FB,
                                                     torch.where(unk_char, K_UNK, K_DROP)))
    wid = torch.where(is_word_b, torch.cumsum(bnd.to(torch.int32), 1, dtype=torch.int32) - 1,
                      -1)
    if has_unk and fuse_unk:
        # plain torch: the reach 2^10 is past the keys kernel's 2^9
        (pk, pw), pf = fill_prev([kind_c, wid], cstart, k_steps=10)
        unk_char = unk_char & ~(pf & (pw == wid) & (pk == K_UNK))

    ids0 = torch.where(known, cid, -1)
    ids0 = torch.where(unk_char, T["unk_id"], ids0)
    if byte_fallback:
        # every byte of a fallback char emits its <0xXX> id
        fb_fill = fill_last(torch.where(cstart, fb_char.to(torch.int32), -1), -1)
        ids0 = torch.where((fb_fill == 1) & is_word_b, fb, ids0)
    ids0 = ids0.to(torch.int32).contiguous()

    # ---- merge, then pack --------------------------------------------------
    # kind "none": a word (or a run between seams) may hold more tokens
    # than the tail ladder's rungs keep in a row's slack (WORD_CAP), so its
    # rounds run at the 1/2 width until dry (the JAX program ladders it,
    # and can cut such a word across two rung rows)
    mwid = wid
    if kind == "none" and meta_seams:
        mwid = torch.where(is_word_b, torch.cumsum(seg_head.to(torch.int32), 1,
                                                   dtype=torch.int32) - 1, -1)
    out = run_merge_phases(ids0, mwid, T["merge_rows0"], T["merge_rows1"], T["seed"],
                           T["merge_mclr"], ladder_depth=0 if kind == "none" else 2,
                           obp=pos.contiguous() if with_offsets else None)
    ids, wid2 = out[0], out[1]
    if mwid is not wid:
        wid2 = torch.where(wid2 >= 0, 0, wid2)  # the row is still one word
    row_bad = row_bad | out[2]
    out_w = ids.shape[1]
    alive = ids >= 0
    k = torch.cumsum(alive.to(torch.int32), 1, dtype=torch.int32) - 1
    ntok = alive.sum(1, dtype=torch.int32)
    packed = pack_rows(ids, alive, k, out_w, -1)
    row_bad = row_bad | (ntok > out_w)
    if not with_offsets:
        return packed, ntok, row_bad

    # spans: a token starts at its kept (left) byte and ends at the next
    # token's start in the same word, else at its word's end
    starts = pack_rows(out[3], alive, k, out_w, 0)
    wids_out = pack_rows(wid2, alive, k, out_w, -2)
    tok = torch.arange(out_w, device=dev).expand(B, out_w)
    in_tok = tok < ntok[:, None]
    sidx = starts.clamp(0, L2 - 1).to(torch.int64)
    wend_at = wend_f.gather(1, sidx)
    if not has_unk:
        # a dropped char takes no room: the reference counts a token's
        # span from the lengths of the tokens before it in its word
        # (`models/bpe/word.rs`), so spans past a dropped char shift left
        kfill = fill_last(torch.where(cstart, kind_c, -1), -1)
        kept = (is_word_b & (kfill != K_DROP)).to(torch.int32)
        kinc = torch.cumsum(kept, 1, dtype=torch.int32)
        excl = torch.cat([kinc - kept, kinc[:, -1:]], 1)  # kept bytes before each byte
        head = fill_last(torch.where(bnd, pos, -1), -1).gather(1, sidx).clamp(min=0)
        base = head - excl.gather(1, head.to(torch.int64))
        starts = base + excl.gather(1, sidx)
        wend_at = base + excl.gather(1, wend_at.clamp(0, L2).to(torch.int64))
    ends = torch.where(in_tok & (_shift_next(wids_out, -3) == wids_out)
                       & _shift_next(in_tok, False), _shift_next(starts, 0), wend_at)
    return (packed, ntok, row_bad, torch.where(in_tok, starts, 0).to(torch.int32),
            torch.where(in_tok, ends, 0).to(torch.int32), torch.where(in_tok, wids_out, -1))
