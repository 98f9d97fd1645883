"""WordPiece over the batch word-dedup machinery (ASCII chunks); port of
`tokenizers_tpu.ops.wordpiece_dedup`.

WordPiece is a per-word function, as BPE is, so an ASCII chunk reuses
`bpe_dedup`'s layout and expansion: normalize (the 256-entry byte map and
one compaction), BERT pre-split boundaries, `dedup_layout` to elect one
representative per distinct word, this module's longest-match encoder
over the unique buffer (`wordpiece_unique_encoder`, the `encode_fn` of
`dedup_finish`), and `_finish_expand` to route the tokens back, with the
persistent cross-batch word cache (`bpe_dedup.WordCache`).  The
candidate sweep and the greedy chain then run over the distinct words
only.

Chunks with multi-byte characters take the dense
`wordpiece_encode.wordpiece_program`, which is also this path's oracle
(the two agree on every row that neither flags).
"""

from __future__ import annotations

import torch

from .bpe_dedup import buffer_geometry, dedup_finish, dedup_layout
from .bpe_encode import take256
from .bpe_merge2 import WORD_CAP
from .route import compact_left
from .wordpiece_encode import bert_split, chain_reach, fill_last, longest_match, word_fail


def wordpiece_unique_encoder(T):
    """encode_fn for `dedup_finish`: longest match and greedy chain over
    the unique-word buffer, ASCII bytes only (one char a byte).  `T`: the
    engine's tables."""

    def encode(b_u, uhead, inb_u, wid_u, wend_f, upos_f):
        ru, uc = b_u.shape
        npos = torch.arange(uc, dtype=torch.int32, device=b_u.device).expand(ru, uc)
        # wend_f and upos_f are flat (row * uc + col): the last byte's column
        wend_col = wend_f - (upos_f - npos) - 1
        m, mid = longest_match(b_u, inb_u, inb_u & ~uhead, wend_col, T)
        # words over the char cap are whole-word [UNK] (chars == bytes)
        wlen_at = torch.where(uhead, wend_col - npos + 1, 0)
        long_word = uhead & (wlen_at > T["max_word_chars"])
        reach = chain_reach(uhead & ~long_word, inb_u, m, T["max_word_chars"])
        fail_pos = (reach & inb_u & (m == 0)) | long_word
        headp = fill_last(torch.where(uhead, npos, torch.where(inb_u, -3, -1)), -3)
        in_fail_word = word_fail(uhead, inb_u, headp, fail_pos)
        token = (reach & ~in_fail_word & (m > 0)) | (uhead & in_fail_word)
        out_id = torch.where(in_fail_word, T["unk_id"], mid)
        ids = torch.where(token, out_id, -1).to(torch.int32)
        return ids, wid_u, torch.zeros((), dtype=torch.bool, device=b_u.device)

    return encode


def wordpiece_dedup_core(bytes_u8, lengths, T, cache=None):
    """ASCII chunks only: normalize, BERT pre-split and the deduplicated
    longest match.  uint8[B, L] + int32[B] -> (ids int32[B, out_w], ntok
    int32[B], row_bad bool[B]), out_w = max(L // 2, 64).

    `cache`: the persistent `WordCache`, updated in place; when this chunk
    could overflow its token buffer the epoch is reset first (rows zeroed,
    p = 0).  A row with a word over WORD_CAP bytes, and every row of a
    chunk whose distinct words overflow the unique buffer, come back
    `row_bad` (one host read decides the latter)."""
    B, L = bytes_u8.shape
    dev = bytes_u8.device
    npos = torch.arange(L, dtype=torch.int32, device=dev).expand(B, L)
    inb = npos < lengths[:, None]
    b_in = torch.where(inb, bytes_u8.to(torch.int32), 0)

    ob = take256(b_in, T["ascii_nb"])
    (nb,), total = compact_left((ob,), inb & (ob != 255), (0,))
    ninb = npos < total[:, None]
    nb = torch.where(ninb, nb, 0)
    cls = torch.where(ninb, take256(nb, T["ascii_cls"]), -1)
    bnd, _is_ws, in_word, _marker, nxt_bnd = bert_split(nb, ninb, ninb, cls, cls, total)

    # a word longer than the buffer slack cannot be laid out: its row goes
    # to the host
    row_long = (bnd & ((nxt_bnd - npos) > WORD_CAP)).any(1)

    geom = buffer_geometry(B * L)
    out_w = max(L // 2, 64)
    reset = False
    if cache is not None:
        reset = cache.p + (B * L) // 2 > cache.buf.shape[0] - 1
        if reset:
            cache.rows.zero_()
            cache.p = 0
    # whitespace bytes are out of every word, like the dense pre-split;
    # rows with a long word are left out whole
    fits, dops = dedup_layout(
        nb, bnd & ~row_long[:, None], in_word & ~row_long[:, None],
        torch.where(row_long, 0, total), nxt_bnd, T["vseed"], geom,
        cache=(cache.rows, reset) if cache is not None else None,
    )
    if fits:
        ids, ntok, bad = dedup_finish(
            dops, nb, None, None, None, T["vseed"], None, out_w, geom,
            cache_state=cache,
            encode_fn=wordpiece_unique_encoder(T),
        )
    else:  # the unique buffer overflows: every row to the host
        ids = torch.full((B, out_w), -1, dtype=torch.int32, device=dev)
        ntok = torch.zeros((B,), dtype=torch.int32, device=dev)
        bad = torch.ones((B,), dtype=torch.bool, device=dev)
    return ids, ntok, bad | row_long


def wordpiece_dedup_scan(bytes_u8, lengths, T, cache=None):
    """N same-shape ASCII chunks (uint8[N, B, L], int32[N, B]) in order,
    carrying the word cache from chunk to chunk (the JAX package's
    `lax.scan`), so each distinct word of the batch runs the sweep and the
    chain once.  Returns (ids [N, B, out_w], ntok [N, B], row_bad [N, B])."""
    outs = [wordpiece_dedup_core(bytes_u8[k], lengths[k], T, cache=cache)
            for k in range(bytes_u8.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))
