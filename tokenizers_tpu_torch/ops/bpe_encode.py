"""Byte-level BPE batch encode on packed [B, L] byte chunks; port of
`tokenizers_tpu.ops.bpe_encode` (the gpt2 and llama3 boundaries, dedup
branch).

Per chunk (`encode_core`):

1. Pre-split boundaries.  gpt2: the layout kernel (B3, `layout_kernels`)
   on pure-ASCII chunks, else `gpt2_boundaries` with the UTF-8 decode.
   The split pattern `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
   ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+` is not run as a regex: its match
   starts are a local function of neighboring character classes plus a
   bounded contraction lookahead.  llama3: `llama3_presplit`.
2. Word dedup (`bpe_dedup`): each distinct word not in the persistent
   word cache is merged once, in the unique buffer, by the merge kernels.
   With `whole_word` (BPE `ignore_merges`), a word that is itself a vocab
   entry takes that id and skips the merge (`bpe_dedup.whole_word_ids`).
3. Expansion to left-packed per-row ids.

The offsets path (`encode_core_offsets`) runs the same boundaries but no
dedup and no word cache: every chunk merges at full width with each
token's original byte position riding the merge phases, and comes back
with each token's start, end and word id in the prepared bytes.

Rows that cannot be encoded on the device (a word longer than WORD_CAP
bytes, a buffer overflow) come back flagged `row_bad` for the host path.

Torch idiom: plain functions on tensors on the caller's device; the word
cache is a `bpe_dedup.WordCache` updated in place; the JAX program's
`lax.cond` branches and `lax.scan` over chunks are Python `if`s and a
Python loop, reading a few scalars from the device per chunk.
"""

from __future__ import annotations

import os

import torch

from .bpe_dedup import (
    H1_MULT,
    H2_MULT,
    _to_i32,
    buffer_geometry,
    dedup_finish,
    dedup_layout,
    rolling_hash,
    whole_word_ids,
)
from .bpe_merge2 import WORD_CAP, _shift_next, _shift_prev, run_merge_phases
from .layout_kernels import layout_fused, next_boundary, supported
from .llama3_presplit import llama3_boundaries
from .unicode_tables import CLS_END, CLS_L, CLS_N, CLS_O, CLS_SP, CLS_WS


def take256(idx, table):
    """`table[idx]` for a 256-entry table (the JAX program's one-hot
    matmul is a TPU workaround for gathers)."""
    return table[idx.to(torch.int64)]


def ascii_cls(b):
    """Char class for byte values < 128, elementwise."""
    bl = b | 32
    is_l = (bl >= 97) & (bl <= 122)
    is_n = (b >= 48) & (b <= 57)
    is_ws = (b >= 9) & (b <= 13)
    out = torch.full_like(b, CLS_O)
    out = torch.where(is_ws, CLS_WS, out)
    out = torch.where(b == 32, CLS_SP, out)
    out = torch.where(is_n, CLS_N, out)
    return torch.where(is_l, CLS_L, out)


def gpt2_boundaries(b, inb, cls_table, ascii_only=False):
    """Match-start mask of the GPT-2 split pattern over packed bytes.

    b: int32[B, L] byte values (0 outside text); inb: bool[B, L] in-text.
    cls_table: flat int8[0x110000] codepoint -> class table (unused when
    `ascii_only`).  Returns (bnd bool[B, L], is_start bool[B, L])."""
    B, L = b.shape
    pos = torch.arange(L, device=b.device).expand(B, L)
    length = inb.sum(1, keepdim=True)

    b1 = _shift_next(b, 0)
    b2 = _shift_next(b, 0, 2)

    if ascii_only:
        is_start = inb
        cls = cls_fill = ascii_cls(b)
        next_exists = (pos + 1) < length
        next_cls = torch.where(next_exists, _shift_next(cls_fill, -1), CLS_END)
    else:
        is_cont = (b & 0xC0) == 0x80
        is_start = inb & ~is_cont
        charlen = 1 + (b >= 0xC0).int() + (b >= 0xE0).int() + (b >= 0xF0).int()
        b3 = _shift_next(b, 0, 3)
        cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
        cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
        cp4 = (((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
               | (b3 & 0x3F))
        cp = torch.where(
            charlen == 1, b,
            torch.where(charlen == 2, cp2, torch.where(charlen == 3, cp3, cp4)),
        ).clamp(0, 0x10FFFF)
        cls = cls_table[cp.to(torch.int64)].to(torch.int32)

        # forward-fill class over continuation bytes (<= 3 steps)
        f = torch.where(is_start, cls, -1)
        for _ in range(3):
            f = torch.where(f >= 0, f, _shift_prev(f, -1))
        cls_fill = f

        # class of the next char, at distance charlen in {1..4}
        next_exists = (pos + charlen) < length
        next_cls_raw = _shift_next(cls_fill, -1)
        for k in (2, 3, 4):
            next_cls_raw = torch.where(
                charlen == k, _shift_next(cls_fill, -1, k), next_cls_raw
            )
        next_cls = torch.where(next_exists, next_cls_raw, CLS_END)
    prev_cls = _shift_prev(cls_fill, CLS_END)

    # contraction: 's|'t|'re|'ve|'m|'ll|'d at a match-start apostrophe
    apo = is_start & (b == 0x27)
    p_ok = (pos == 0) | (prev_cls == CLS_L) | (prev_cls == CLS_N) | (prev_cls == CLS_WS)
    is3 = (
        ((b1 == ord("r")) & (b2 == ord("e")))
        | ((b1 == ord("v")) & (b2 == ord("e")))
        | ((b1 == ord("l")) & (b2 == ord("l")))
    ) & ((pos + 2) < length)
    is2 = (
        (b1 == ord("s")) | (b1 == ord("t")) | (b1 == ord("m")) | (b1 == ord("d"))
    ) & ((pos + 1) < length)
    contr = apo & p_ok & (is3 | is2)
    contr3 = contr & is3
    contr2 = contr & ~is3

    interior = _shift_prev(contr, False) | _shift_prev(contr3, False, 2)
    contr_end = _shift_prev(contr2, False, 2) | _shift_prev(contr3, False, 3)

    is_ws = (cls == CLS_SP) | (cls == CLS_WS)
    p_is_ws = (prev_cls == CLS_SP) | (prev_cls == CLS_WS)
    n_nonws = next_exists & (next_cls != CLS_SP) & (next_cls != CLS_WS)

    # non-whitespace char: new match unless it extends the previous run or
    # attaches to a preceding literal space
    b_nonws = torch.where(
        prev_cls == CLS_L, cls != CLS_L,
        torch.where(prev_cls == CLS_N, cls != CLS_N, (cls == CLS_L) | (cls == CLS_N)),
    )
    b_nonws = torch.where(prev_cls == CLS_WS, True, b_nonws)
    b_nonws = torch.where(prev_cls == CLS_SP, False, b_nonws)
    # whitespace char: run-internal split before the final pre-word space
    b_ws = torch.where(p_is_ws, n_nonws, True)

    bnd = torch.where(is_ws, b_ws, b_nonws)
    bnd = bnd | (pos == 0) | contr_end
    bnd = bnd & ~interior & is_start & inb
    return bnd, is_start


def encode_core(bytes_u8, lengths, tables, cache=None, ascii_only=False,
                boundary="gpt2", whole_word=False, geom_rows=None):
    """uint8[B, L] bytes + int32[B] lengths -> (ids int32[B, out_w],
    ntok int32[B], row_bad bool[B]), out_w = max(L // 2, 64).

    `tables`: the engine's tensors (`bpe_engine.tables_from_numpy`).
    `cache`: the persistent `WordCache`, updated in place; when this chunk
    could overflow its token buffer the epoch is reset first (rows zeroed,
    p = 0, no hits).  `ascii_only`: every byte < 128 (the layout kernel's
    chunks).  `boundary`: the pre-split rule set, "gpt2", "llama3", or
    "llama3_prefix" (the llama-3 pieces, a space put before each that
    lacks one: `prefix_pieces`, which widens the rows).
    `whole_word`: the BPE `ignore_merges` bypass through the whole-word
    table (`tables["ww_rows0"]`, `["ww_rows1"]`, `["ww_seed"]`).
    `geom_rows`: the rows the buffers are sized for (default B; a rank's
    block of a chunk on a mesh takes the whole chunk's, so that it fits
    wherever the whole chunk would; it holds only its block's words, so
    where the whole chunk overflows, the blocks flag fewer rows)."""
    B, L = bytes_u8.shape
    dev = bytes_u8.device
    b = bytes_u8.to(torch.int32)
    pos = torch.arange(L, device=dev).expand(B, L)
    inb = pos < lengths[:, None]
    b = torch.where(inb, b, 0)
    seed = tables["seed"]

    if boundary == "llama3_prefix":
        b, inb, lengths, bnd = prefix_pieces(b, inb, lengths, tables["cls_table"], ascii_only)
        B, L = b.shape
        pos = torch.arange(L, device=dev).expand(B, L)
        nxt_bnd, hashes = next_boundary(bnd), None
    else:
        bnd, nxt_bnd, hashes = _boundaries(b, inb, lengths, tables, ascii_only, boundary)

    word_id = torch.where(inb, torch.cumsum(bnd.int(), 1, dtype=torch.int32) - 1, -1)
    # word-length guard (fill depth in the merge loop is bounded by WORD_CAP)
    wlen = torch.minimum(nxt_bnd, lengths[:, None]) - pos
    row_bad = (bnd & (wlen > WORD_CAP)).any(1)

    BL = (B if geom_rows is None else geom_rows) * L
    geom = buffer_geometry(BL)
    out_w = max(L // 2, 64)
    reset = False
    if cache is not None:
        # epoch reset when this chunk's tokens could overflow the buffer
        reset = cache.p + (B * L) // 2 > cache.buf.shape[0] - 1
        if reset:
            cache.rows.zero_()
            cache.p = 0
    fits, dops = dedup_layout(
        b, bnd, inb, lengths, nxt_bnd, seed, geom,
        cache=(cache.rows, reset) if cache is not None else None,
        hashes=hashes,
    )
    ww = {}
    if whole_word:
        ww = dict(whole_word=True, ww_rows0=tables["ww_rows0"],
                  ww_rows1=tables["ww_rows1"], ww_seed=tables["ww_seed"])
    if fits:
        ids_pk, ntok, badm = dedup_finish(
            dops, b, tables["byte2id"], tables["merge_rows0"],
            tables["merge_rows1"], seed, tables["merge_mclr"], out_w, geom,
            cache_state=cache, **ww,
        )
    elif BL >= int(os.environ.get("TOKENIZERS_TPU_BIG_BUCKET_MIN", 1 << 20)):
        # big buckets whose unique words overflow the dedup buffer go to
        # the host whole (row_bad)
        ids_pk = torch.full((B, out_w), -1, dtype=torch.int32, device=dev)
        ntok = torch.zeros((B,), dtype=torch.int32, device=dev)
        badm = torch.ones((B,), dtype=torch.bool, device=dev)
    else:
        ids0 = torch.where(inb, take256(b, tables["byte2id"]), -1)
        if whole_word:
            ids0 = _whole_word_full(ids0, b, bnd, inb, nxt_bnd, lengths, tables)
        ids_pk, ntok, badm = _branch_full(ids0, word_id, tables, out_w)
    return ids_pk, ntok, row_bad | badm


def prefix_pieces(b, inb, lengths, cls_table, ascii_only):
    """The llama-3 pieces of int32 bytes [B, L] with a space put before
    each piece that does not start with one (the reference's ByteLevel
    with `add_prefix_space` after the llama-3 Split prepends to every
    split, `pre_tokenizers/byte_level.rs:126-135`): (bytes [B, L2], inb,
    lengths, piece starts), L2 = L plus the most spaces a row gains,
    rounded up to a multiple of 64.  The pieces are the llama-3 rule's on
    the original bytes; every original byte moves right by the spaces put
    at or before it."""
    bnd, _ = llama3_boundaries(b, inb, cls_table, ascii_only=ascii_only)
    bnd = bnd & inb
    ins = bnd & (b != 0x20)
    shift = torch.cumsum(ins.int(), 1)
    grown = shift[:, -1]
    B, L = b.shape
    L2 = -(-(L + int(grown.max())) // 64) * 64
    rows = torch.arange(B, device=b.device)[:, None].expand(B, L)
    dest = (torch.arange(L, device=b.device)[None, :] + shift).to(torch.int64)
    b2 = torch.zeros((B, L2), dtype=b.dtype, device=b.device)
    bnd2 = torch.zeros((B, L2), dtype=torch.bool, device=b.device)
    b2[rows[inb], dest[inb]] = b[inb]
    b2[rows[ins], dest[ins] - 1] = 0x20
    bnd2[rows[ins], dest[ins] - 1] = True
    keep = bnd & ~ins
    bnd2[rows[keep], dest[keep]] = True
    lengths2 = (lengths + grown).to(lengths.dtype)
    inb2 = torch.arange(L2, device=b.device)[None, :] < lengths2[:, None]
    return b2, inb2, lengths2, bnd2


def _whole_word_full(ids0, b, bnd, inb, nxt_bnd, lengths, tables):
    """The whole-word bypass over a [B, L] chunk: each word's two rolling
    hashes, read at its last byte (unbounded, as the JAX program's scan)."""
    L = b.shape[1]
    pos = torch.arange(L, device=b.device).expand_as(b)
    end_pos = torch.minimum(nxt_bnd, lengths[:, None]) - 1
    end_cl = end_pos.clamp(0, L - 1).to(torch.int64)
    wh1, wh2 = (_to_i32(rolling_hash(b, bnd, m)).gather(1, end_cl)
                for m in (H1_MULT, H2_MULT))
    return whole_word_ids(ids0, bnd, inb, wh1, wh2, end_pos - pos + 1,
                          tables["ww_rows0"], tables["ww_rows1"], tables["ww_seed"])


def _branch_full(ids0, word_id, tables, out_w):
    """Small chunks whose words do not dedup into the buffer: the merge at
    full width (plain while tail), left-packed to out_w."""
    ids, _w, bad2 = run_merge_phases(
        ids0, word_id, tables["merge_rows0"], tables["merge_rows1"],
        tables["seed"], tables["merge_mclr"], ladder_depth=0,
    )
    alive = ids >= 0
    k = torch.cumsum(alive.int(), 1) - 1
    ntok = alive.sum(1, dtype=torch.int32)
    (packed,) = _left_pack((ids,), alive & (k < out_w), out_w)
    # the merge width (5W/8) exceeds out_w: rows with more tokens than
    # out_w are flagged here
    over = ntok > out_w
    return packed, torch.where(over, 0, ntok), bad2 | over


def _boundaries(b, inb, lengths, tables, ascii_only, boundary):
    """(bnd, nxt_bnd, hashes): the pre-split boundaries, the next boundary
    of every position and, from the layout kernel (B3, gpt2 ASCII chunks),
    the two word hashes (else None).  The JAX program leaves B3 out under
    the whole-word bypass; its outputs are those of the plain rule and the
    same hashes, so the port runs it there too."""
    if boundary == "gpt2" and ascii_only and supported(b.shape):
        bnd, nxt_bnd, h1k, h2k = layout_fused(b, lengths)
        return bnd, nxt_bnd, (h1k, h2k)
    if boundary == "gpt2":
        bnd, _ = gpt2_boundaries(b, inb, tables["cls_table"], ascii_only=ascii_only)
    elif boundary == "llama3":
        bnd, _ = llama3_boundaries(b, inb, tables["cls_table"], ascii_only=ascii_only)
    else:
        raise ValueError(f"unknown boundary {boundary!r}")
    return bnd, next_boundary(bnd), None


def _left_pack(vals, alive, width):
    """Each of `vals` ([B, C] int32) left-packed over its row's alive
    positions into [B, width] (at most `width` alive a row), -1
    elsewhere."""
    B = alive.shape[0]
    k = (torch.cumsum(alive.int(), 1) - 1)[alive].to(torch.int64)
    rows = torch.arange(B, device=alive.device)[:, None].expand_as(alive)[alive]
    outs = []
    for v in vals:
        o = torch.full((B, width), -1, dtype=torch.int32, device=alive.device)
        o[rows, k] = v[alive].to(torch.int32)
        outs.append(o)
    return outs


def encode_core_offsets(bytes_u8, lengths, tables, ascii_only=False,
                        boundary="gpt2", whole_word=False):
    """The offsets path of one chunk (JAX `_encode_core` with
    `with_offsets`): uint8[B, L] bytes + int32[B] lengths -> (ids, ntok,
    row_bad, starts, ends, word ids), each [B, W] int32 left-packed to
    W = the merge's 1/2 width, -1 past ntok (0 for ends).

    No dedup and no word cache: the chunk merges at full width
    (`run_merge_phases` with its tail ladder), each token carrying its
    original byte position, which merges keep from the left token.  A
    token's start is that position; its end the next token's start where
    that token is of the same word, else the word's end (its next
    boundary, at most the row's length), read at the token's start.
    Starts, ends and word ids index the prepared bytes of the row."""
    B, L = bytes_u8.shape
    dev = bytes_u8.device
    b = bytes_u8.to(torch.int32)
    pos = torch.arange(L, device=dev, dtype=torch.int32).expand(B, L)
    inb = pos < lengths[:, None]
    b = torch.where(inb, b, 0)
    bnd, nxt_bnd, _h = _boundaries(b, inb, lengths, tables, ascii_only, boundary)
    word_id = torch.where(inb, torch.cumsum(bnd.int(), 1, dtype=torch.int32) - 1, -1)
    wend = torch.minimum(nxt_bnd, lengths[:, None])  # each position's word end
    row_bad = (bnd & (wend - pos > WORD_CAP)).any(1)

    ids0 = torch.where(inb, take256(b, tables["byte2id"]), -1)
    if whole_word:
        ids0 = _whole_word_full(ids0, b, bnd, inb, nxt_bnd, lengths, tables)
    ids, wid, bad, obp = run_merge_phases(
        ids0, word_id, tables["merge_rows0"], tables["merge_rows1"],
        tables["seed"], tables["merge_mclr"], obp=pos.contiguous(),
    )
    alive = ids >= 0
    W = ids.shape[1]
    ntok = alive.sum(1, dtype=torch.int32)
    ids_pk, starts, wids = _left_pack((ids, obp, wid), alive, W)
    in_tok = torch.arange(W, device=dev)[None, :] < ntok[:, None]
    wend_at = wend.gather(1, starts.clamp(0, L - 1).to(torch.int64))
    same_word = in_tok & _shift_next(in_tok, False) & (_shift_next(wids, -2) == wids)
    ends = torch.where(same_word, _shift_next(starts, 0), wend_at)
    ends = torch.where(in_tok, ends, 0).to(torch.int32)
    return ids_pk, ntok, row_bad | bad, starts, ends, wids


def encode_program_scan(bytes_u8, lengths, tables, cache=None, ascii_only=False,
                        boundary="gpt2", whole_word=False):
    """N same-shape chunks (uint8[N, B, L], int32[N, B]) in order, carrying
    the word cache from chunk to chunk, so each distinct word of the whole
    batch is merged once.  Returns (ids int32[N, B, out_w], ntok int32[N, B],
    row_bad bool[N, B]); the cache is updated in place.  Under "llama3_prefix"
    each chunk's rows widen by its own spaces: the ids are padded with -1
    to the widest."""
    outs = [
        encode_core(bytes_u8[k], lengths[k], tables, cache=cache,
                    ascii_only=ascii_only, boundary=boundary,
                    whole_word=whole_word)
        for k in range(bytes_u8.shape[0])
    ]
    w = max(o[0].shape[1] for o in outs)
    ids = torch.stack([torch.nn.functional.pad(o[0], (0, w - o[0].shape[1]), value=-1)
                       for o in outs])
    return (ids,) + tuple(torch.stack(x) for x in list(zip(*outs))[1:])
