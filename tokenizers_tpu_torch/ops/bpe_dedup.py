"""Batch word-dedup BPE encode: merge each distinct word once.  Port of
`tokenizers_tpu.ops.bpe_dedup`.

1. `dedup_layout`: one record per word (flat position, two rolling
   hashes, length) in a [wr, wc] word table, a hash table electing each
   distinct word's first occurrence as representative, the persistent
   word cache's hits, and the offsets of the uncached representatives in
   the unique buffer.  Produces the `fits` predicate.
2. `dedup_finish`: copy the representatives' bytes into the [ru, uc]
   unique buffer (words placed at (uoff // uceff, uoff % uceff); the
   WORD_CAP slack keeps every word inside a row), run `run_merge_phases`
   on the smallest row slice that holds them, then `_finish_expand` back
   to the packed per-row output, reading cached words from the cache.

Word identity is two independent 32-bit rolling hashes.  The persistent
word cache (`WordCache`) is updated in place: the JAX program donated the
same buffers to each call.  Slot collisions among new words are resolved
as the JAX package's scatter resolves them on the CPU: the last word in
word-table order wins.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bpe_merge2 import (
    WORD_CAP,
    _g_excl_cumsum,
    _seg_count,
    _shift_prev,
    _word_any,
    fill_next,
    run_merge_phases,
)
from .merge_table import hash_pair, mul32
from .route import compact_left, scatter_flat

INF = 0x7FFFFFFF
H1_MULT = 0x01000193
H2_MULT = 0x0000C597
_M32 = 0xFFFFFFFF

g_excl_cumsum = _g_excl_cumsum


class WordCache:
    """Persistent cross-batch word cache: `rows` int32[Sc, 4] direct-mapped
    (h1, h2, tok_start, tok_count), `buf` int32[CAP + 1] appended token
    ids, `p` the append position.  An epoch reset (all rows zeroed, p = 0)
    happens in `bpe_encode.encode_core` when a chunk could overflow `buf`."""

    def __init__(self, slots: int, cap: int, device):
        self.rows = torch.zeros((slots, 4), dtype=torch.int32, device=device)
        self.buf = torch.full((cap + 1,), -1, dtype=torch.int32, device=device)
        self.p = 0


def buffer_geometry(bl, denom=None):
    """Static sizes: word-table [Wr, Wc] and unique buffer [Ru, UC], as
    (nw_cap, wc, uc, uceff, ru).  Unique capacity is ~bl/8 bytes for
    chunks of >= 1M positions, ~bl/4 below."""
    if denom is None:
        denom = 8 if bl >= (1 << 20) else 4
    raw = max(bl // 4, 1 << 10)
    wc = min(4096, 1 << (raw.bit_length() - 1))
    nw_cap = -(-raw // wc) * wc
    uraw = max(bl // denom, 1 << 10)
    uc = min(4096, 1 << (uraw.bit_length() - 1))
    uceff = uc - min(WORD_CAP, uc // 2)
    ru = -(-uraw // uceff)
    return nw_cap, wc, uc, uceff, ru


def _fill_last(vals, isset):
    """Per position (per row): the values at the last position at-or-before
    it where `isset` (0 where none), plus whether there is one."""
    C = isset.shape[1]
    pos = torch.arange(C, device=isset.device).expand_as(isset)
    j = torch.cummax(torch.where(isset, pos, -1), 1).values
    found = j >= 0
    jc = j.clamp(min=0)
    return [torch.where(found, v.gather(1, jc), 0) for v in vals], found


def _fill_last_wrap(vals, isset):
    """`_fill_last` in row-major order over the whole [R, C] array."""
    shape = isset.shape
    out, found = _fill_last([v.reshape(1, -1) for v in vals], isset.reshape(1, -1))
    return [o.reshape(shape) for o in out], found.reshape(shape)


@functools.lru_cache(maxsize=None)
def _powers(mult: int, n: int) -> np.ndarray:
    """mult^k mod 2^32 for k < n, as int64."""
    a = np.full(n, mult, dtype=np.uint64)
    a[0] = 1
    return (np.cumprod(a) & np.uint64(_M32)).astype(np.int64)


_POWERS_ON: dict = {}


def _powers_on(mult: int, n: int, dev) -> torch.Tensor:
    """`_powers` on `dev`, uploaded once per (mult, n, device)."""
    key = (mult, n, str(dev))
    t = _POWERS_ON.get(key)
    if t is None:
        t = _POWERS_ON[key] = torch.from_numpy(_powers(mult, n)).to(dev)
    return t


def _to_i32(x):
    """[0, 2^32) int64 -> the int32 of the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def rolling_hash(b, bnd, mult, keep=None):
    """h_i = h_{i-1} * mult + (b_i + 1) mod 2^32, restarting at each
    boundary (and at the row start), as int64 in [0, 2^32).  With `keep`,
    only the bytes it marks enter; the others leave h as it was (the JAX
    WordLevel program's segmented scan, whose whitespace is its identity).

    A closed form instead of a scan: mult is odd, so invertible mod 2^32,
    and h_i = mult^n_i * (S_i - S_{s-1}) with S_i = sum_{k<=i} c_k
    mult^-n_k, n_k the count of entering bytes before or at k (the
    position without `keep`) and s the segment start."""
    B, L = b.shape
    dev = b.device
    pw = _powers_on(mult, L + 1, dev)
    pinv = _powers_on(pow(mult, -1, 1 << 32), L + 1, dev)
    if keep is None:
        n, c = torch.arange(L, device=dev), b.to(torch.int64) + 1  # n broadcasts over rows
    else:
        n = torch.cumsum(keep.to(torch.int64), 1)
        c = torch.where(keep, b.to(torch.int64) + 1, 0)
    S = torch.cumsum(mul32(c, pinv[n]), 1)
    pos = torch.arange(L, device=dev).expand(B, L)
    start = torch.cummax(torch.where(bnd, pos, -1), 1).values
    base = torch.where(start >= 1, S.gather(1, (start - 1).clamp(min=0)), 0)
    return mul32((S - base) & _M32, pw[n])


def word_hash_heads(b, bnd, inb, mult):
    """Rolling hash of each word, delivered from the word's last byte back
    over the word (2^9 positions at most; words longer than WORD_CAP are
    flagged row_bad upstream).  int32."""
    h = _to_i32(rolling_hash(b, bnd, mult))
    nxt_in = torch.cat([inb[:, 1:], torch.zeros_like(inb[:, :1])], 1)
    nxt_head = torch.cat([bnd[:, 1:], torch.ones_like(bnd[:, :1])], 1)
    is_end = inb & (nxt_head | ~nxt_in)
    (he,), fnd = fill_next([h], is_end, k_steps=9)
    return torch.where(is_end, h, torch.where(fnd, he, 0))


def dedup_layout(b, bnd, inb, lengths, nxt_bnd, seed, geom, cache=None,
                 hashes=None, max_wlen=None):
    """Word records, representative election, unique-buffer layout.

    `cache`: optional (cache_rows [Sc, 4], reset bool); cached words are
    kept out of the merge buffer.  `hashes`: the head-delivered word hashes
    when the layout kernel already made them.  `max_wlen`: words longer
    than this stay out of the unique buffer and never hit the cache; they
    get no device tokens and become patch records (`dedup_finish`'s
    `patch_cap`), so one long word does not send its row to the host.

    Returns (fits, ops), `ops` the operand tuple of `dedup_finish`."""
    nw_cap, wc, uc, uceff, ru = geom
    wr = nw_cap // wc
    B, L = b.shape
    dev = b.device
    pos = torch.arange(L, dtype=torch.int32, device=dev).expand(B, L)
    rowi = torch.arange(B, dtype=torch.int32, device=dev)[:, None].expand(B, L)

    wend = torch.minimum(nxt_bnd, lengths[:, None])
    wlen = wend - pos
    if hashes is not None:
        h1, h2 = hashes
    else:
        h1 = word_hash_heads(b, bnd, inb, H1_MULT)
        h2 = word_hash_heads(b, bnd, inb, H2_MULT)
    fpos = pos + rowi * L
    nw = int(bnd.sum())

    (c_fpos, c_h1, c_h2, c_wlen), _cnt = compact_left(
        (fpos, h1, h2, wlen), bnd & inb, (0, -1, -1, 0), wrap=True
    )

    def to_wtab(x):
        flat = x.reshape(-1)
        if flat.shape[0] < nw_cap:
            flat = torch.cat([flat, flat.new_zeros(nw_cap - flat.shape[0])])
        return flat[:nw_cap].reshape(wr, wc)

    widx2 = torch.arange(nw_cap, dtype=torch.int32, device=dev).reshape(wr, wc)
    wvalid = widx2 < nw
    wpos_w = to_wtab(c_fpos)
    wh1 = torch.where(wvalid, to_wtab(c_h1), -1)
    wh2 = torch.where(wvalid, to_wtab(c_h2), -1)
    wlen_w = torch.where(wvalid, to_wtab(c_wlen), 0)

    S = 1 << max(14, int(nw_cap - 1).bit_length())
    slot = hash_pair(wh1, wh2, seed ^ 0x5BD1, S - 1, 0)
    slot = torch.where(wvalid, slot, S).reshape(-1).to(torch.int64)
    tbl = torch.full((S + 8,), INF, dtype=torch.int32, device=dev)
    tbl.scatter_reduce_(0, slot, widx2.reshape(-1), "amin")
    winner = tbl[slot].reshape(wr, wc)
    wi = winner.clamp(0, nw_cap - 1).to(torch.int64)
    same = (
        wvalid
        & (winner < nw_cap)
        & (wh1.reshape(-1)[wi] == wh1)
        & (wh2.reshape(-1)[wi] == wh2)
    )
    rep = torch.where(same, winner, widx2)
    is_rep = wvalid & (rep == widx2)

    if cache is None:
        zeros = torch.zeros((wr, wc), dtype=torch.int32, device=dev)
        hit = zeros > 0
        ct0 = ccnt = cslot = zeros
    else:
        crows, reset = cache
        Sc = crows.shape[0]
        cslot = hash_pair(wh1, wh2, seed ^ 0x9E37, Sc - 1, 0)
        crow = crows[cslot.to(torch.int64)]
        hit = wvalid & (crow[..., 0] == wh1) & (crow[..., 1] == wh2)
        if reset:
            hit = hit & False
        ct0 = crow[..., 2]
        ccnt = crow[..., 3]

    long_w = wvalid & (wlen_w > max_wlen) if max_wlen is not None else torch.zeros_like(wvalid)
    hit = hit & ~long_w
    in_buf = is_rep & ~hit & ~long_w  # uncached representatives get merged
    ulen = torch.where(in_buf, wlen_w, 0)
    uoff = g_excl_cumsum(ulen)
    total_u = int(ulen.sum())
    fits = (nw <= nw_cap) and (total_u <= uceff * ru)
    ops = (rep, in_buf, uoff, total_u, wpos_w, wlen_w, wvalid, nw, hit, ct0,
           ccnt, cslot, wh1, wh2)
    return fits, ops


def layout_fits(ops, geom):
    """Whether a layout's words/unique bytes fit a (possibly smaller)
    buffer geometry sharing the same word-table shape."""
    nw_cap, _wc, _uc, uceff, ru = geom
    return (ops[7] <= nw_cap) and (ops[3] <= uceff * ru)


def _pad_rows(x, rows, fill):
    if x.shape[0] >= rows:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _tier(total_u, ru, uceff, cached):
    """(rows, tiered): the smallest occupancy tier whose rows hold the
    unique bytes, ru/8 (only with the persistent cache), ru/2, else all ru
    rows; `tiered` is False where the buffer is too small for tiers."""
    t_set = (ru // 8, ru // 2) if cached else (ru // 2,)
    tiers = sorted({r for r in t_set if 2 <= r < ru})
    if not (tiers and ru > 4):
        return ru, False
    for ru_s in tiers:
        if total_u <= ru_s * uceff:
            return ru_s, True
    return ru, True


def unique_buffer(ops, b, geom):
    """The [ru, uc] unique buffer of a layout: each uncached
    representative's bytes at (uoff // uceff, uoff % uceff).  Returns
    (b_u, uhead, inb_u, wid_u, wend_f, upos_f): bytes, word heads, in-word
    mask, word rank (-1 outside words), each word's exclusive end and the
    flat position."""
    nw_cap, wc, uc, uceff, ru = geom
    rep, in_buf, uoff, total_u, wpos_w, wlen_w = ops[:6]
    BL = b.numel()
    UFLAT = ru * uc
    dev = b.device
    urow = uoff // uceff
    ucol = uoff - urow * uceff
    uflat = urow * uc + ucol
    (d0, w0), uset = scatter_flat(
        (wpos_w - uflat, uflat + wlen_w), in_buf, torch.where(in_buf, uflat, 0),
        (0, 0), UFLAT,
    )
    uhead = uset.reshape(ru, uc)
    (delta, wend_f), dset = _fill_last([d0.reshape(ru, uc), w0.reshape(ru, uc)], uhead)
    upos_f = torch.arange(UFLAT, dtype=torch.int32, device=dev).reshape(ru, uc)
    src = (delta + upos_f).clamp(0, BL - 1).to(torch.int64)
    inb_u = dset & (upos_f < wend_f)
    b_u = torch.where(inb_u, b.reshape(-1)[src.reshape(-1)].reshape(ru, uc), 0)
    uh = uhead.to(torch.int32)
    wid_u = torch.where(inb_u, g_excl_cumsum(uh) + uh - 1, -1)
    return b_u, uhead, inb_u, wid_u, wend_f, upos_f


def whole_word_ids(ids0, head, inb, wh1, wh2, wlen, ww_rows0, ww_rows1, ww_seed):
    """The BPE `ignore_merges` bypass: a word whose two rolling hashes and
    length hit the whole-word table (the vocab's entries of two or more
    bytes, [S, 4] rows (h1, h2, length, id) of a cuckoo table) takes that
    id at its head, and the rest of the word dies.  `wh1`, `wh2`, `wlen`
    are read at word heads (`head`)."""
    mask = ww_rows0.shape[0] - 1
    w0 = ww_rows0[hash_pair(wh1, wh2, ww_seed, mask, 0).to(torch.int64)]
    w1 = ww_rows1[hash_pair(wh1, wh2, ww_seed, mask, 1).to(torch.int64)]
    hit0 = (w0[..., 0] == wh1) & (w0[..., 1] == wh2)
    hit1 = (w1[..., 0] == wh1) & (w1[..., 1] == wh2)
    stored_len = torch.where(hit0, w0[..., 2], w1[..., 2])
    stored_id = torch.where(hit0, w0[..., 3], w1[..., 3])
    hit = head & (hit0 | hit1) & (stored_len == wlen) & (wlen > 1)
    (filled,), _ = _fill_last([hit.to(torch.int32)], head)
    word_is_hit = (filled == 1) & inb
    ids0 = torch.where(hit, stored_id, ids0)
    return torch.where(word_is_hit & ~head, -1, ids0)


def dedup_finish(ops, b, byte2id, rows0, rows1, seed, mclr, out_w, geom,
                 cache_state=None, encode_fn=None, ladder_depth=2,
                 whole_word=False, ww_rows0=None, ww_rows1=None, ww_seed=0,
                 max_wlen=None, patch_cap=0):
    """The fast branch: encode unique words, expand to per-row output.

    `cache_state`: the `WordCache`, already epoch-reset by the caller;
    updated in place.  `encode_fn(b_u, uhead, inb_u, wid_u, wend_f,
    upos_f) -> (ids, wid2, bad)`: another per-unique-word encoder over the
    unique buffer (default: the byte-level BPE merge).  `whole_word`: the
    `ignore_merges` bypass over the unique buffer (`whole_word_ids`).
    `max_wlen`, `patch_cap`: as in `_finish_expand`.

    Returns (ids[B, out_w], ntok[B], row_bad[B]), and with `patch_cap`
    also (patch_tab int32[patch_cap, 5], n_patch int)."""
    nw_cap, wc, uc, uceff, ru = geom
    total_u = ops[3]
    b_u, uhead, inb_u, wid_u, wend_f, upos_f = unique_buffer(ops, b, geom)

    ru_s, tiered = _tier(total_u, ru, uceff, cache_state is not None)
    if encode_fn is not None:
        ids_u, wid_u2, bad_m = encode_fn(
            b_u[:ru_s], uhead[:ru_s], inb_u[:ru_s], wid_u[:ru_s],
            wend_f[:ru_s], upos_f[:ru_s],
        )
        ids_u = _pad_rows(ids_u, ru, -1)
        wid_u2 = _pad_rows(wid_u2, ru, -1)
        if bad_m.dim() == 2:
            bad_m = _pad_rows(bad_m, ru, False)
    else:
        # every merge round costs the whole slice it runs on, and unique
        # words pack from row 0: merge only the rows that hold them.  Only
        # the ru/2 tier (or an untiered buffer) runs the full tail ladder.
        depth = ladder_depth if (not tiered or ru_s == ru // 2) else 0
        ids0 = torch.where(inb_u, byte2id[b_u.to(torch.int64)], -1)
        if whole_word:
            ids0 = whole_word_ids(
                ids0, uhead, inb_u, word_hash_heads(b_u, uhead, inb_u, H1_MULT),
                word_hash_heads(b_u, uhead, inb_u, H2_MULT),
                torch.where(uhead, wend_f - upos_f, 0), ww_rows0, ww_rows1,
                ww_seed,
            )
        ids_u, wid_u2, bad = run_merge_phases(
            ids0[:ru_s].contiguous(), wid_u[:ru_s].contiguous(), rows0, rows1,
            seed, mclr, ladder_depth=depth,
        )
        ids_u = _pad_rows(ids_u, ru, -1)
        wid_u2 = _pad_rows(wid_u2, ru, -1)
        bad = _pad_rows(bad, ru, False)
        # compaction overflow is per unique-buffer row: spread it over the
        # row's positions so only input rows with words there fall back
        bad_m = bad[:, None].expand(ids_u.shape)
    return _finish_expand(ids_u, wid_u2, bad_m, ops, geom, b.shape, out_w,
                          cache_state, max_wlen=max_wlen, patch_cap=patch_cap)


def _finish_expand(ids_u, wid_u2, bad_m, ops, geom, b_shape, out_w,
                   cache_state, max_wlen=None, patch_cap=0):
    """Per-unique-word token counts, token storage (batch-local or the
    persistent cache), and the routed per-input-row packed output.

    `patch_cap` > 0: flagged words (the encoder's per-word flags, words
    over `max_wlen`, dropped words) become per-word patch records instead
    of sending their rows to the host: (row, col, wlen, tok_off, tok_cnt)
    in word-table order, the first `patch_cap` of them, and their count
    n_patch.  The host re-encodes each word and splices its ids at
    tok_off in place of the device's tok_cnt tokens.  Rows become
    row_bad from word flags only when n_patch > patch_cap."""
    nw_cap, wc, uc, uceff, ru = geom
    wr = nw_cap // wc
    (rep, in_buf, uoff, total_u, wpos_w, wlen_w, wvalid, nw, hit, ct0, ccnt,
     cslot, wh1, wh2) = ops
    B, L = b_shape
    UF2 = ru * ids_u.shape[1]
    dev = ids_u.device

    # bad_m: [ru, uc2] per-position flags (only input rows whose words hit
    # a flag fall back) or a scalar/[B] flag (whole-batch fallback)
    word_level_bad = bad_m.dim() == 2
    alive = ids_u >= 0
    tpos = g_excl_cumsum(alive.to(torch.int32))
    seg = wid_u2 != _shift_prev(wid_u2, -2)
    k_in = _seg_count(alive, seg)
    # dead slots keep their wid: the last token of a word is the one whose
    # next ALIVE position belongs to another word
    (nxt_w,), nfnd = fill_next([wid_u2], alive, k_steps=9)
    is_last = alive & (~nfnd | (nxt_w != wid_u2))
    is_first = alive & seg

    def per_word(mask, vals):
        # indexed by the word's unique-buffer rank (its wid), 0 for a word
        # with no token left.  The JAX package packs the values in buffer
        # order instead, which is the same array unless a compaction
        # overflow dropped every token of a word; then every later word
        # read the next word's counts.  Here the dropped word has count 0
        # and `dropped` below sends its rows to the host.
        out = torch.zeros(nw_cap, dtype=vals.dtype, device=dev)
        out[wid_u2[mask].to(torch.int64)] = vals[mask]
        return out

    tcnt_u = per_word(is_last, k_in)
    t0_u = per_word(is_first, tpos)
    if word_level_bad:
        wbad_u = per_word(is_first, _word_any(bad_m, seg).to(torch.int32))
        ok_ins = True
    else:
        wbad_u = torch.zeros_like(tcnt_u)
        ok_ins = not bool(bad_m.any())

    # ---- token storage ------------------------------------------------
    (utoks2d,), new_tok = compact_left((ids_u,), alive, (-1,), wrap=True)
    utoks = utoks2d.reshape(-1)[:UF2]
    new_tok = int(new_tok)
    if cache_state is None:
        tok_src = utoks
        tok_base = 0
        src_cap = UF2
    else:
        crows, cbuf, p = cache_state.rows, cache_state.buf, cache_state.p
        Sc = crows.shape[0]
        CAP = cbuf.shape[0] - 1
        if UF2 <= CAP + 1:
            # the dense stream drops into the cache buffer as one window
            start = min(max(p, 0), CAP + 1 - UF2)
            win = cbuf[start : start + UF2]
            wi = torch.arange(UF2, device=dev)
            keep = (wi < new_tok) & ok_ins
            cbuf[start : start + UF2] = torch.where(keep, utoks, win)
        else:  # cache smaller than one chunk's tokens
            ttgt = torch.where(alive & ok_ins, torch.clamp(p + tpos, max=CAP), CAP)
            cbuf[ttgt.reshape(-1).to(torch.int64)] = ids_u.reshape(-1)
        tok_src = cbuf
        tok_base = p
        src_cap = CAP

    # ---- expand to per-row packed output -----------------------------
    pair = torch.stack([t0_u, tcnt_u, wbad_u, torch.zeros_like(t0_u)], -1)
    # wid_u2 counts heads in buffer order == the representative's unique
    # order among merged (uncached) representatives
    uord = g_excl_cumsum(in_buf.to(torch.int32))
    uord_of_rep = uord.reshape(-1)[rep.clamp(0, nw_cap - 1).reshape(-1).to(torch.int64)]
    pr = pair[uord_of_rep.clamp(0, nw_cap - 1).to(torch.int64)].reshape(wr, wc, 4)
    t0_w = torch.where(hit, ct0, tok_base + pr[..., 0])
    k_w = torch.where(wvalid, torch.where(hit, ccnt, pr[..., 1]), 0)
    # a merged word with no tokens lost them past a compaction edge: its
    # input rows fall back, and it never enters the cache
    dropped = wvalid & ~hit & (pr[..., 1] == 0) & (wlen_w > 0)
    wbad_w = (wvalid & ~hit & (pr[..., 2] > 0)) | dropped

    if cache_state is not None:
        ins_ok = in_buf & ok_ins & (wlen_w <= WORD_CAP)
        prw0 = pair[uord.clamp(0, nw_cap - 1).reshape(-1).to(torch.int64)].reshape(wr, wc, 4)
        ins_ok = ins_ok & (prw0[..., 1] > 0)
        if word_level_bad:
            ins_ok = ins_ok & (prw0[..., 2] == 0)
        rowvals = torch.stack([wh1, wh2, tok_base + prw0[..., 0], prw0[..., 1]], -1)
        _insert_last_wins(crows, cslot, ins_ok, rowvals)
        cache_state.p = p + (new_tok if ok_ins else 0)

    if max_wlen is not None:
        # long words never entered the unique buffer: no device tokens,
        # always flagged (their rep-derived counts are another word's)
        long_w = wvalid & (wlen_w > max_wlen)
        k_w = torch.where(long_w, 0, k_w)
        wbad_w = wbad_w | long_w

    roww = torch.where(wvalid, wpos_w // L, B)
    roww_f = roww.reshape(-1)
    prevw = torch.cat([roww_f.new_full((1,), -1), roww_f[:-1]]).reshape(wr, wc)
    rfirst = wvalid & (roww != prevw)
    G = g_excl_cumsum(k_w)
    # ooff = G minus G at the output row's first word; the bad-flag cumsum
    # rides the same fill
    badcum = g_excl_cumsum(wbad_w.to(torch.int32))
    (g0, bc0), _ = _fill_last_wrap([G, badcum], rfirst)
    ooff = G - g0
    # per-row totals at the row's last word (roww is sorted in word-table
    # order, invalid words last), row badness in bit 30
    row_any_bad = (badcum + wbad_w.to(torch.int32) - bc0) > 0
    val = (ooff + k_w) | torch.where(row_any_bad, 1 << 30, 0).to(torch.int32)
    rows_b = torch.arange(B, dtype=roww_f.dtype, device=dev)
    idx = torch.searchsorted(roww_f, rows_b, right=True) - 1
    idx_c = idx.clamp(0, roww_f.shape[0] - 1)
    hitr = (idx >= 0) & (roww_f[idx_c] == rows_b)
    packed_row = torch.where(hitr, val.reshape(-1)[idx_c], 0)
    ntok = packed_row & ((1 << 30) - 1)
    tie_rows = packed_row >> 30

    olive = wvalid & (k_w > 0) & (ooff < out_w)
    otgt = torch.where(olive, roww * out_w + ooff, 0)
    (od0,), oset = scatter_flat((t0_w - ooff,), olive, otgt, (0,), B * out_w)
    (od,), odset = _fill_last([od0.reshape(B, out_w)], oset.reshape(B, out_w))
    opos = torch.arange(out_w, dtype=torch.int32, device=dev).expand(B, out_w)
    osrc = (od + opos).clamp(0, src_cap - 1)
    in_out = odset & (opos < ntok[:, None])
    # the JAX program reads tokens as width-4 rows: keep its clamp
    nr4 = tok_src.shape[0] // 4
    fidx = (osrc >> 2).clamp(0, nr4 - 1) * 4 + (osrc & 3)
    fetched = tok_src[fidx.to(torch.int64)]
    ids_out = torch.where(in_out, fetched, -1)

    # token-count overflow is per row; only merge-buffer badness that is
    # not word-level is batch-wide
    row_over = ntok > out_w
    any_bad = False if word_level_bad else bool(bad_m.any())
    ntok = torch.where(row_over, 0, ntok)
    row_bad = row_over | any_bad
    if not patch_cap:
        return ids_out, ntok, row_bad | (tie_rows > 0)
    # flagged words -> patch records; only a table overflow sends their
    # rows to the host
    rank = g_excl_cumsum(wbad_w.to(torch.int32))
    nflag = int(wbad_w.sum())
    col_w = wpos_w - torch.where(wvalid, wpos_w // L, 0) * L
    recs = torch.stack([roww, col_w, wlen_w, ooff, k_w], -1)
    sel = wbad_w & (rank < patch_cap)
    patch_tab = torch.zeros((patch_cap, 5), dtype=torch.int32, device=dev)
    patch_tab[rank[sel].to(torch.int64)] = recs[sel].to(torch.int32)
    if nflag > patch_cap:
        row_bad = row_bad | (tie_rows > 0)
    return ids_out, ntok, row_bad, patch_tab, nflag


def _insert_last_wins(crows, cslot, ins_ok, rowvals):
    """crows[cslot[w]] = rowvals[w] for words with ins_ok; where several
    words share a slot the last in word-table order wins, deterministically
    on any device."""
    Sc = crows.shape[0]
    n = cslot.numel()
    order = torch.arange(n, device=crows.device)
    slot = torch.where(ins_ok, cslot, Sc).reshape(-1).to(torch.int64)
    last = torch.full((Sc + 1,), -1, dtype=torch.int64, device=crows.device)
    last.scatter_reduce_(0, slot, order, "amax")
    win = ins_ok.reshape(-1) & (last[slot] == order)
    crows[slot[win]] = rowvals.reshape(-1, 4)[win]
