"""Unigram Viterbi over the batch word-dedup machinery: the ids path of the
Unigram engine; port of `tokenizers_tpu.ops.unigram_dedup` (plain XLA in
the JAX package, torch ops here).

Unigram is a per-word function, as BPE is, so a chunk is normalized
(`unigram_encode.normalize_metaspace`), split at each `▁`, and laid out
by `bpe_dedup` (`dedup_layout`, `dedup_finish`): one representative per
distinct word in a [ru, 640] unique buffer (words over UD_SLACK = 128
bytes stay out), the persistent word cache's hits kept out too.  This
module's encoder (`unigram_unique_encoder`) runs over the unique buffer:

* probes: for each piece length l, the two rolling hashes of every
  substring (closed-form prefix hashes, uint32 arithmetic in masked
  int64) looked up in the vocab's cuckoo table as [S, 8] rows (key1,
  key2, length, id, score hi, score lo, 0, 0);
* the forward DP, one step per column (`UD_UC` steps), with a window of
  the best pending path per boundary; scores in compensated f32
  (double-float (hi, lo) pairs, `dd_add`): every op in f32 in the
  written order, no fusion, so the bits are the JAX program's.  A
  comparison whose two paths are closer than the accumulated error bound
  (`TIE_EPS_REL`) flags its word (near-tie), and the host re-encodes
  that word in f64;
* the backtrack, one reverse step per boundary with a window of pending
  marks; `fuse_unk`; byte fallback (`byte_fallback_expand`).

Flagged words (near-ties, words over UD_SLACK) come back as per-word
patch records (`dedup_finish`'s `patch_cap`), which the engine splices
(`engine_base._apply_patches`), so one such word does not send its row
to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .bpe_dedup import _M32, _to_i32, buffer_geometry, dedup_finish, dedup_layout, mul32
from .bpe_merge2 import _rev_cummin, _shift_next, _shift_prev
from .merge_table import hash_pair
from .unigram_encode import NEG, byte_fallback_expand, normalize_metaspace
from .wordpiece_encode import H1_MULT, H2_MULT, _prefix_hash, decode_chars, fill_last

UD_UC = 640
UD_SLACK = 128
UD_UCEFF = UD_UC - UD_SLACK
PATCH_CAP = 512  # per-word patch records per chunk; more flag their rows

# near-tie bound: eps(q, a, b) = (q + 2) * TIE_EPS_REL * (|a| + |b| + 1)
# over-approximates |dd - f64| of both compared paths at column q
TIE_EPS_REL = np.float32(3e-14)

NEG_HALF = float(NEG / 2)
BIGP = 0x7FFFFFFF


def unigram_geometry(bl):
    """(nw_cap, wc, uc, uceff, ru): the word table as `buffer_geometry`'s,
    the unique buffer in rows of UD_UC (the DP's depth); chunks under 2^20
    positions get half their stream as unique capacity."""
    nw_cap, wc, _uc, _uceff, _ru = buffer_geometry(bl)
    uraw = max(bl // (4 if bl >= (1 << 20) else 2), 1 << 10)
    ru = -(-uraw // UD_UCEFF)
    return nw_cap, wc, UD_UC, UD_UCEFF, ru


# ---- compensated f32 (double-float) arithmetic: TwoSum, Fast2Sum ----------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):  # requires |a| >= |b| (or a == 0)
    s = a + b
    return s, b - (s - a)


def dd_add(h1, l1, h2, l2):
    """(h1, l1) + (h2, l2), renormalized."""
    s, e = _two_sum(h1, h2)
    e = e + (l1 + l2)
    return _fast_two_sum(s, e)


def dd_gt(h1, l1, h2, l2):
    return (h1 > h2) | ((h1 == h2) & (l1 > l2))


def dd_split(x64: np.ndarray):
    """f64 array -> (hi, lo) f32 arrays with hi + lo the double-float of x."""
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


# ---- probes ---------------------------------------------------------------

def piece_probes(nb, s_ok, last, T, scores64=None):
    """For each length l = 1..max_len and each position p of `nb` (int32
    [R, C]) where `s_ok` and p + l - 1 <= `last`: whether the substring
    [p, p + l) is a piece, its id and its score, each [R, C, max_len].
    The score is the row's (hi, lo) f32 pair, or with `scores64` (the f64
    scores [2, S], slot-aligned with the two tables) its f64 value."""
    R, C = nb.shape
    K = T["max_len"]
    dev = nb.device
    npos = torch.arange(C, dtype=torch.int32, device=dev).expand(R, C)
    E1 = _prefix_hash(nb, H1_MULT, K)
    E2 = _prefix_hash(nb, H2_MULT, K)
    E1b, E2b = E1[:, :C], E2[:, :C]
    rows0, rows1, seed = T["vrows0"], T["vrows1"], T["vseed"]
    vmask = rows0.shape[0] - 1
    hit = torch.empty((R, C, K), dtype=torch.bool, device=dev)
    pid = torch.empty((R, C, K), dtype=torch.int32, device=dev)
    if scores64 is None:
        score = torch.empty((R, C, K, 2), dtype=torch.int32, device=dev)
    else:
        score = torch.empty((R, C, K), dtype=torch.float64, device=dev)
    for l in range(1, K + 1):
        valid = s_ok & ((npos + (l - 1)) <= last)
        h1 = _to_i32((E1[:, l:l + C] - mul32(E1b, int(T["pow1"][l]))) & _M32)
        h2 = _to_i32((E2[:, l:l + C] - mul32(E2b, int(T["pow2"][l]))) & _M32)
        g0 = hash_pair(h1, h2, seed, vmask, 0).to(torch.int64)
        g1 = hash_pair(h1, h2, seed, vmask, 1).to(torch.int64)
        r0 = rows0[g0]
        r1 = rows1[g1]
        hit0 = (r0[..., 0] == h1) & (r0[..., 1] == h2)
        hit1 = (r1[..., 0] == h1) & (r1[..., 1] == h2)
        sel = torch.where(hit0[..., None], r0, r1)
        hit[..., l - 1] = valid & (hit0 | hit1) & (sel[..., 2] == l)
        pid[..., l - 1] = sel[..., 3]
        if scores64 is None:
            score[..., l - 1, :] = sel[..., 4:6]
        else:
            score[..., l - 1] = torch.where(hit0, scores64[0][g0], scores64[1][g1])
    return hit, pid, score


def unk_fill(hit, s_ok, nclen):
    """bool [R, C, K]: where a char start has no piece of its own char
    length, the unk piece takes that length (reference `has_single_node`)."""
    K = hit.shape[-1]
    lidx = torch.arange(1, K + 1, dtype=torch.int32, device=hit.device)
    at_len = lidx == nclen[..., None]
    has_single = (at_len & hit).any(-1)
    return (s_ok & ~has_single)[..., None] & at_len


def fuse_unk(tok, node_st, node_id, jlen, head_of, unk_id, K):
    """Emitted tokens at boundaries: a token is fused away when it is unk,
    not its word's first, and the token before it is unk too."""
    prev_id = torch.full_like(node_id, -1)
    prev_is_tok = torch.zeros_like(tok)
    for d in range(1, K + 1):
        m = tok & (jlen == d)
        prev_id = torch.where(m, _shift_prev(node_id, -1, d), prev_id)
        prev_is_tok = prev_is_tok | (m & _shift_prev(tok, False, d))
    first_of_word = tok & (node_st == head_of)
    fused_away = tok & (node_id == unk_id) & ~first_of_word & prev_is_tok & (prev_id == unk_id)
    return tok & ~fused_away


def backtrack(seed, jlen, K):
    """Boundaries on the best paths: one reverse step per boundary q with
    a window of pending marks (slot j = boundary q - j); the seeds are
    the word-end boundaries.  Returns reach bool [R, C + 1]."""
    R, C1 = seed.shape
    dev = seed.device
    slots = torch.arange(K + 1, dtype=torch.int32, device=dev)
    jlen_t = jlen.t().contiguous()
    seed_t = seed.t().contiguous()
    pend = torch.zeros((R, K + 1), dtype=torch.bool, device=dev)
    zero = torch.zeros((R, 1), dtype=torch.bool, device=dev)
    reach = [None] * C1
    for q in range(C1 - 1, -1, -1):
        reach_q = seed_t[q] | pend[:, 0]
        pend = pend | ((slots == jlen_t[q][:, None]) & reach_q[:, None])
        pend = torch.cat([pend[:, 1:], zero], 1)
        reach[q] = reach_q
    return torch.stack(reach, 1)


def forward_dp(ch, cl, pid, uhead):
    """The forward DP over the columns of [R, C, K] piece costs (the (hi,
    lo) f32 pair `ch`, `cl` of the piece of each length starting at each
    position, NEG where none) and ids: slot j of the window holds the best
    pending path to boundary q + j + 1; a candidate replaces it only when
    strictly greater (`dd_gt`), and a comparison of two live paths closer
    than the error bound flags the column (near tie).  Every `uhead`
    position starts a word (path score 0).  Returns (node_st, node_id
    [R, C + 1]: the best piece ending at each boundary, its start and id,
    -1 where none; near bool [R, C])."""
    R, C, K = ch.shape
    dev = ch.device
    ch_t = ch.permute(1, 0, 2).contiguous()  # [C, R, K]
    cl_t = cl.permute(1, 0, 2).contiguous()
    pid_t = pid.permute(1, 0, 2).contiguous()
    ok_t = ch_t > NEG_HALF
    bnd_t = uhead.t().contiguous()
    ph = torch.full((R, K), float(NEG), dtype=torch.float32, device=dev)
    plo = torch.zeros((R, K), dtype=torch.float32, device=dev)
    pst = torch.full((R, K), -1, dtype=torch.int32, device=dev)
    pidc = torch.full((R, K), -1, dtype=torch.int32, device=dev)
    neg_col = ph[:, :1].clone()
    zero_col = plo[:, :1].clone()
    none_col = pst[:, :1].clone()
    o_st, o_id, o_near = [], [], []
    for q in range(C):
        o_st.append(pst[:, 0])
        o_id.append(pidc[:, 0])
        dp_h = torch.where(bnd_t[q], 0.0, ph[:, 0])
        dp_l = torch.where(bnd_t[q], 0.0, plo[:, 0])
        sh_h = torch.cat([ph[:, 1:], neg_col], 1)
        sh_l = torch.cat([plo[:, 1:], zero_col], 1)
        sh_st = torch.cat([pst[:, 1:], none_col], 1)
        sh_id = torch.cat([pidc[:, 1:], none_col], 1)
        cand_h, cand_l = dd_add(dp_h[:, None], dp_l[:, None], ch_t[q], cl_t[q])
        ok = ok_t[q] & (dp_h > NEG_HALF)[:, None]
        both = ok & (sh_h > NEG_HALF)
        # (q + 2) * TIE_EPS_REL in f32, as the JAX program computes it
        eps = float(np.float32(q + 2) * TIE_EPS_REL) * (cand_h.abs() + sh_h.abs() + 1.0)
        near = both & (((cand_h - sh_h) + (cand_l - sh_l)).abs() <= eps)
        o_near.append(near.any(1))
        better = ok & dd_gt(cand_h, cand_l, sh_h, sh_l)
        ph = torch.where(better, cand_h, sh_h)
        plo = torch.where(better, cand_l, sh_l)
        pst = torch.where(better, q, sh_st)
        pidc = torch.where(better, pid_t[q], sh_id)
    node_st = torch.stack(o_st + [pst[:, 0]], 1)
    node_id = torch.stack(o_id + [pidc[:, 0]], 1)
    return node_st, node_id, torch.stack(o_near, 1)


def unigram_unique_encoder(T):
    """encode_fn for `dedup_finish`: the probes, the compensated-f32
    forward DP (`forward_dp`) and the backtrack over the unique-word
    buffer.  Returns (ids at token start bytes, wid, near-tie flags per
    position)."""
    K = T["max_len"]
    unk_id = T["unk_id"]

    def encode(b_u, uhead, inb_u, wid_u, wend_f, upos_f):
        ru, uc = b_u.shape
        dev = b_u.device
        npos = torch.arange(uc, dtype=torch.int32, device=dev).expand(ru, uc)
        wend_col = wend_f - (upos_f - npos) - 1  # the word's last byte column
        _cp, nstart, nclen = decode_chars(b_u, inb_u)
        s_ok = inb_u & nstart
        hit, pid, bits = piece_probes(b_u, s_ok, wend_col, T)
        bits = bits.view(torch.float32)
        ch = torch.where(hit, bits[..., 0], float(NEG))
        cl = torch.where(hit, bits[..., 1], 0.0)
        pid = torch.where(hit, pid, -1)
        unk_sel = unk_fill(ch > NEG_HALF, s_ok, nclen)
        ch = torch.where(unk_sel, T["unk_hi"], ch)
        cl = torch.where(unk_sel, T["unk_lo"], cl)
        pid = torch.where(unk_sel, unk_id, pid)
        node_st, node_id, near = forward_dp(ch, cl, pid, uhead)
        near_f = near & inb_u

        # ---- backtrack from every word's last byte -----------------------
        bpos = torch.arange(uc + 1, dtype=torch.int32, device=dev).expand(ru, uc + 1)
        jlen = torch.where(node_st >= 0, bpos - node_st, 0)
        is_wlast = inb_u & (npos == wend_col)
        seed = _shift_prev(torch.cat([is_wlast, torch.zeros_like(is_wlast[:, :1])], 1), False, 1)
        reach = backtrack(seed, jlen, K)
        tok = reach & (node_st >= 0) & (jlen > 0)

        headb = fill_last(torch.where(uhead, npos, torch.where(inb_u, -3, -1)), -3)
        head_of = torch.cat([torch.full_like(headb[:, :1], -1), headb], 1)
        emit = fuse_unk(tok, node_st, node_id, jlen, head_of, unk_id, K)

        # ---- tokens at their start bytes ---------------------------------
        if T["bf_tab"] is not None:
            ids, _st, _en, _emit_b = byte_fallback_expand(
                emit, jlen, node_id, unk_id, T["bf_tab"], b_u, inb_u, K)
            return ids, wid_u, near_f
        ids = torch.full((ru, uc + 1), -1, dtype=torch.int32, device=dev)
        for d in range(1, K + 1):
            m = _shift_next(emit & (jlen == d), False, d)
            ids = torch.where(m, _shift_next(node_id, -1, d), ids)
        return ids[:, :uc], wid_u, near_f

    return encode


# ---- the chunk program: normalize, dedup, Viterbi, expand (+ cache) -------

def unigram_dedup_core(bytes_u8, lengths, T, cache=None, geom_rows=None):
    """uint8[B, L] + int32[B] -> (ids int32[B, out_w], ntok int32[B],
    row_bad bool[B], patch_tab int32[PATCH_CAP, 5], n_patch int), out_w =
    max(L // 2, 64).  `T`: the engine's tables.  `cache`: the persistent
    `WordCache`, updated in place (epoch reset first when this chunk could
    overflow its token buffer).  Every row of a chunk whose distinct words
    overflow the unique buffer comes back `row_bad`.  `geom_rows`: the
    rows the buffers are sized for (default B; a rank's block on a mesh
    takes the whole chunk's, and, holding only its block's words, flags
    fewer rows where the whole chunk overflows)."""
    B, L = bytes_u8.shape
    L2 = L * 2 + 4
    dev = bytes_u8.device
    nb, wbnd, ninb, total, row_bad, _src = normalize_metaspace(
        bytes_u8, lengths, T["cls_s1"], T["cls_s2"], False)
    npos = torch.arange(L2, dtype=torch.int32, device=dev).expand(B, L2)
    nxt_b = _rev_cummin(torch.where(wbnd, npos, BIGP))
    nxt_bnd = torch.minimum(_shift_next(nxt_b, BIGP), total[:, None])

    geom = unigram_geometry((B if geom_rows is None else geom_rows) * L2)
    out_w = max(L // 2, 64)
    reset = False
    if cache is not None:
        reset = cache.p + (B * L) // 2 > cache.buf.shape[0] - 1
        if reset:
            cache.rows.zero_()
            cache.p = 0
    fits, dops = dedup_layout(
        nb, wbnd, ninb, total, nxt_bnd, T["vseed"], geom,
        cache=(cache.rows, reset) if cache is not None else None, max_wlen=UD_SLACK)
    if fits:
        ids, ntok, bad, ptab, nflag = dedup_finish(
            dops, nb, None, None, None, T["vseed"], None, out_w, geom, cache_state=cache,
            encode_fn=unigram_unique_encoder(T), max_wlen=UD_SLACK,
            patch_cap=PATCH_CAP)
    else:  # the unique buffer overflows: every row to the host
        ids = torch.full((B, out_w), -1, dtype=torch.int32, device=dev)
        ntok = torch.zeros((B,), dtype=torch.int32, device=dev)
        bad = torch.ones((B,), dtype=torch.bool, device=dev)
        ptab = torch.zeros((PATCH_CAP, 5), dtype=torch.int32, device=dev)
        nflag = 0
    return ids, ntok, bad | row_bad, ptab, nflag


def unigram_dedup_scan(bytes_u8, lengths, T, cache=None):
    """N same-shape chunks (uint8[N, B, L], int32[N, B]) in order, the word
    cache carried from chunk to chunk (the JAX package's `lax.scan`).
    Returns (ids [N, B, out_w], ntok [N, B], row_bad [N, B],
    patch_tab [N, PATCH_CAP, 5], n_patch int64[N])."""
    outs = [unigram_dedup_core(bytes_u8[k], lengths[k], T, cache=cache)
            for k in range(bytes_u8.shape[0])]
    ids, ntok, bad, ptab, nflag = zip(*outs)
    return (torch.stack(ids), torch.stack(ntok), torch.stack(bad), torch.stack(ptab),
            torch.tensor(nflag, dtype=torch.int64))
