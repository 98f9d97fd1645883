"""Word-packed Unigram Viterbi in f64: the offsets path of the Unigram
engine; port of `tokenizers_tpu.ops.unigram_packed` (plain XLA in the
JAX package, torch ops here).

The DP is sequential only within words (the path score restarts at each
`▁`), so the words of a chunk are repacked into a [RU, UC = 512] buffer
(words never cross rows: PACK_SLACK = 256 bytes of slack a row; a row
holding a longer word comes back `row_bad`; the grid stops at the last
row the words fill), and the forward DP runs one step per packed column
in f64 (the reference's `encode_optimized` scores and first-writer tie
rule), then the backtrack one reverse step per boundary, `fuse_unk` and
byte fallback.  Each emitted token carries its input row, its start and
end in the row's normalized bytes and its word; a stable compaction and
one scatter (`route.compact_left`, `route.scatter_flat`, where the JAX
program routes through butterflies) bring the tokens back to their input
rows, and the spans map to original chars through the normalizer's
source chars (`normalize_metaspace(..., with_src=True)`).

One difference from the JAX program, which the wheel decides: with byte
fallback the JAX program numbers the compacted tokens as if their rows
were UC + 1 wide (they are UC wide there), so from the second compacted
row on each input row's ranks skip a slot; this port uses the real flat
position (ROADMAP Queue C).
"""

from __future__ import annotations

import torch

from .bpe_dedup import _fill_last_wrap, g_excl_cumsum
from .bpe_merge2 import _rev_cummin, _shift_next, _shift_prev
from .route import compact_left, scatter_flat
from .unigram_dedup import BIGP, backtrack, fuse_unk, piece_probes, unk_fill
from .unigram_encode import NEG, byte_fallback_expand, normalize_metaspace
from .wordpiece_encode import decode_chars, fill_last

UC = 512  # packed row width = the DP's depth
PACK_SLACK = 256  # the longest word on this path (bytes)
UCEFF = UC - PACK_SLACK
NEG64 = float(NEG)
NEG64_HALF = NEG64 / 2


def _pack_geometry(BL2):
    return -(-BL2 // UCEFF)  # rows for the worst case: every byte packed


def _fill_from_right(v, isset):
    """Per position: v at the nearest position at or after it where
    `isset` (0 where none)."""
    C = isset.shape[1]
    cols = torch.arange(C, device=v.device).expand_as(isset)
    j = _rev_cummin(torch.where(isset, cols, C))
    return torch.where(j < C, v.gather(1, j.clamp(max=C - 1)), 0)


def _shift_prev_flat(x, fill):
    """Row-major flat shift by one (the previous element, across rows)."""
    flat = x.reshape(-1)
    return torch.cat([flat.new_full((1,), fill), flat[:-1]]).reshape(x.shape)


def unigram_program_packed(bytes_u8, lengths, T, with_offsets=False):
    """uint8[B, L] + int32[B] -> (ids int32[B, L2 // 2], ntok int32[B],
    row_bad bool[B]) with L2 = 2L + 4, and with `with_offsets` also
    (start char, end char, word rank) int32[B, L2 // 2], spans in the
    original chars of each row.  `T`: the engine's tables (`vscore`: the
    f64 scores, slot-aligned with the cuckoo tables)."""
    B, L = bytes_u8.shape
    L2 = L * 2 + 4
    dev = bytes_u8.device
    K = T["max_len"]
    unk_id = T["unk_id"]
    nb, wbnd, ninb, total, row_bad, src_char = normalize_metaspace(
        bytes_u8, lengths, T["cls_s1"], T["cls_s2"], with_offsets)
    npos = torch.arange(L2, dtype=torch.int32, device=dev).expand(B, L2)
    rowi = torch.arange(B, dtype=torch.int32, device=dev)[:, None].expand(B, L2)

    # ---- word extents; rows with a word over the slack go to the host ----
    nxt_bnd = _shift_next(_rev_cummin(torch.where(wbnd, npos, BIGP)), BIGP)
    wlen_d = torch.minimum(nxt_bnd, total[:, None]) - npos  # valid at heads
    row_long = (wbnd & (wlen_d > PACK_SLACK)).any(1)
    row_bad = row_bad | row_long

    # ---- pack words into [RU, UC] --------------------------------------
    live = ninb & ~row_long[:, None]
    goff = g_excl_cumsum(torch.where(wbnd & live, wlen_d, 0))
    urow = goff // UCEFF
    uflat_h = urow * UC + (goff - urow * UCEFF)
    jh = torch.cummax(torch.where(wbnd, npos, -1), 1).values
    has_h = jh >= 0
    tgt_h = torch.where(has_h, uflat_h.gather(1, jh.clamp(min=0).to(torch.int64)), 0)
    tgt = tgt_h + (npos - torch.where(has_h, jh, 0))
    # the JAX program's grid has rows for every byte (_pack_geometry); this
    # one stops at the last row the words fill (one host read): the rows
    # past it hold no token, so the outputs are the same
    RU = max(1, min(_pack_geometry(B * L2), int(torch.where(live, tgt, -1).max()) // UC + 1))
    onorm = rowi * L2 + npos
    (nbp, headp, rowidxp, onormp), live_o = scatter_flat(
        (nb, wbnd.to(torch.int32), rowi, onorm), live, torch.where(live, tgt, 0),
        (0, 0, -1, -1), RU * UC)
    ninbp = live_o.reshape(RU, UC)
    nbp = torch.where(ninbp, nbp.reshape(RU, UC), 0)
    uheadp = ninbp & (headp.reshape(RU, UC) > 0)
    rowidxp = torch.where(ninbp, rowidxp.reshape(RU, UC), -1)
    onormp = torch.where(ninbp, onormp.reshape(RU, UC), -1)
    upos = torch.arange(UC, dtype=torch.int32, device=dev).expand(RU, UC)

    # ---- piece scores on the packed grid --------------------------------
    _cp, nstartp, nclenp = decode_chars(nbp, ninbp)
    nxt_hp = _rev_cummin(torch.where(uheadp, upos, BIGP))
    # a packed row's live span can start past column 0: its end is the
    # last live column + 1, not the live count
    rowend = torch.where(ninbp, upos + 1, 0).amax(1)
    wendp = torch.minimum(_shift_next(nxt_hp, BIGP), rowend[:, None]) - 1
    s_ok = ninbp & nstartp
    hit, pid, score = piece_probes(nbp, s_ok, wendp, T, scores64=T["vscore"])
    cost = torch.where(hit, score, NEG64)
    pid = torch.where(hit, pid, -1)
    unk_sel = unk_fill(cost > NEG64_HALF, s_ok, nclenp)
    cost = torch.where(unk_sel, T["unk_score"], cost)
    pid = torch.where(unk_sel, unk_id, pid)

    # ---- forward DP over the 512 packed columns (f64) -------------------
    cost_t = cost.permute(1, 0, 2).contiguous()  # [UC, RU, K]
    pid_t = pid.permute(1, 0, 2).contiguous()
    ok_t = cost_t > NEG64_HALF
    bnd_t = uheadp.t().contiguous()
    psc = torch.full((RU, K), NEG64, dtype=torch.float64, device=dev)
    pst = torch.full((RU, K), -1, dtype=torch.int32, device=dev)
    pidc = torch.full((RU, K), -1, dtype=torch.int32, device=dev)
    neg_col = psc[:, :1].clone()
    none_col = pst[:, :1].clone()
    o_st, o_id = [], []
    for q in range(UC):
        o_st.append(pst[:, 0])
        o_id.append(pidc[:, 0])
        dp = torch.where(bnd_t[q], 0.0, psc[:, 0])
        sh_sc = torch.cat([psc[:, 1:], neg_col], 1)
        sh_st = torch.cat([pst[:, 1:], none_col], 1)
        sh_id = torch.cat([pidc[:, 1:], none_col], 1)
        cand = dp[:, None] + cost_t[q]
        better = ok_t[q] & (dp > NEG64_HALF)[:, None] & (cand > sh_sc)
        psc = torch.where(better, cand, sh_sc)
        pst = torch.where(better, q, sh_st)
        pidc = torch.where(better, pid_t[q], sh_id)
    node_st = torch.stack(o_st + [pst[:, 0]], 1)  # [RU, UC + 1]
    node_id = torch.stack(o_id + [pidc[:, 0]], 1)

    # ---- backtrack from every word head and each row's fill end ----------
    bposp = torch.arange(UC + 1, dtype=torch.int32, device=dev).expand(RU, UC + 1)
    jlen = torch.where(node_st >= 0, bposp - node_st, 0)
    seed = torch.cat([uheadp, torch.zeros_like(uheadp[:, :1])], 1) | (bposp == rowend[:, None])
    tok = backtrack(seed, jlen, K) & (node_st >= 0) & (jlen > 0)

    headb = fill_last(torch.where(uheadp, upos, torch.where(ninbp, -3, -1)), -3)
    head_of = torch.cat([torch.full_like(headb[:, :1], -1), headb], 1)
    # a word key unique over the packed grid (head columns repeat across rows)
    rowbase = torch.arange(RU, dtype=torch.int32, device=dev)[:, None] * UC
    head_flat = torch.where(headb >= 0, rowbase + headb, -1)
    head_key = torch.cat([torch.full_like(head_flat[:, :1], -1), head_flat], 1)
    emit = fuse_unk(tok, node_st, node_id, jlen, head_of, unk_id, K)

    # each word's exclusive end in the original flat normalized space, at
    # the boundary that ends each of its tokens
    is_wlast = ninbp & (upos == wendp)
    wend_b = _fill_from_right(torch.where(is_wlast, onormp + 1, 0), is_wlast)
    wend_orig = _shift_prev(torch.cat([wend_b, torch.zeros_like(wend_b[:, :1])], 1), 0, 1)

    # ---- route the tokens back to their input rows ----------------------
    if T["bf_tab"] is not None:
        ids_b, st_b, en_b, emit_sel = byte_fallback_expand(
            emit, jlen, node_id, unk_id, T["bf_tab"], nbp, ninbp, K)
        vals_tok = (ids_b, torch.where(emit_sel, rowidxp, -1),
                    torch.where(emit_sel, onormp - (upos - st_b), 0),
                    torch.where(emit_sel, onormp + (en_b - upos), 0),
                    torch.where(emit_sel, head_flat, -1))
    else:
        emit_sel = emit
        tok_row = _shift_prev(torch.cat([rowidxp, torch.full_like(rowidxp[:, :1], -1)], 1),
                              -1, 1)
        onorm_pad = torch.cat([onormp, torch.zeros_like(onormp[:, :1])], 1)
        st_orig = torch.zeros_like(onorm_pad)
        for d in range(1, K + 1):
            st_orig = torch.where(emit & (jlen == d), _shift_prev(onorm_pad, 0, d), st_orig)
        vals_tok = (torch.where(emit, node_id, -1), torch.where(emit, tok_row, -1), st_orig,
                    torch.where(emit, wend_orig, 0), torch.where(emit, head_key, -1))
    comp, tcount = compact_left(vals_tok, emit_sel, (-1, -1, 0, 0, -1), wrap=True)
    c_id, c_row, c_st, c_en, c_head = comp
    R2, C2 = c_id.shape
    flatp = torch.arange(R2 * C2, dtype=torch.int32, device=dev).reshape(R2, C2)
    in_tok = flatp < tcount
    row_first = in_tok & (c_row != _shift_prev_flat(c_row, -1))
    (g_first,), _ = _fill_last_wrap([torch.where(row_first, flatp, 0)], row_first)
    rank = flatp - g_first
    out_w = L2 // 2
    n_out = B * out_w
    ok = in_tok & (rank < out_w)
    (o_id, o_st, o_en, o_head), live_out = scatter_flat(
        (c_id, c_st, c_en, c_head), ok, torch.where(ok, c_row * out_w + rank, 0),
        (-1, 0, 0, -1), n_out)
    live_out = live_out.reshape(B, out_w)
    ids_out = torch.where(live_out, o_id.reshape(B, out_w), -1)
    ntok = live_out.sum(1, dtype=torch.int32)
    over = in_tok & (rank >= out_w)
    over_rows = torch.zeros((B + 1,), dtype=torch.bool, device=dev)
    over_rows[c_row[over].clamp(0, B).to(torch.int64)] = True
    row_bad = row_bad | over_rows[:B]
    if not with_offsets:
        return ids_out, ntok, row_bad

    o_st = torch.where(live_out, o_st.reshape(B, out_w), 0)
    o_en = torch.where(live_out, o_en.reshape(B, out_w), 0)
    o_head = torch.where(live_out, o_head.reshape(B, out_w), -1)
    if T["bf_tab"] is not None:
        ends_flat = o_en  # byte-fallback tokens carry their span's end
    else:
        # the next token's start within the same word (fused unk spans),
        # else the word's end
        n_live = _shift_next(live_out, False)
        ends_flat = torch.where(live_out & n_live & (_shift_next(o_head, -2) == o_head),
                                _shift_next(o_st, 0), o_en)
    # flat (row * L2 + position) -> row-local normalized bytes -> chars
    st_loc = torch.where(live_out, o_st - torch.div(o_st, L2, rounding_mode="floor") * L2, 0)
    en_b = ends_flat - 1
    en_loc = torch.where(live_out, en_b - torch.div(en_b, L2, rounding_mode="floor") * L2 + 1, 0)
    src_pad = torch.cat([src_char, torch.zeros_like(src_char[:, :1])], 1)
    st_char = src_pad.gather(1, st_loc.clamp(0, L2).to(torch.int64))
    en_char = src_pad.gather(1, (en_loc - 1).clamp(0, L2 - 1).to(torch.int64)) + 1
    st_char = torch.where(live_out, st_char, 0)
    en_char = torch.where(live_out, en_char, 0)
    new_word = (o_head != _shift_prev(o_head, -3)) & live_out
    word_idx = torch.where(live_out, torch.cumsum(new_word, 1, dtype=torch.int32) - 1, -1)
    return ids_out, ntok, row_bad, st_char, en_char, word_idx
