"""WordPiece encode on packed [B, L] byte chunks: BertNormalizer,
BertPreTokenizer and greedy longest match; port of
`tokenizers_tpu.ops.wordpiece_encode` (the JAX package computes it in
plain XLA, with no Pallas kernel, and so does this port in torch ops).

`wordpiece_program` per chunk:

1. Normalize.  `ascii_only` (every byte < 128): a 256-entry byte map
   (255 = a dropped char) and one stable compaction; the normalized row
   keeps width L.  Otherwise: UTF-8 decode, the two-stage table gather
   of `bert_tables`, and a scatter of each char's up to NORM_K output
   bytes into a [B, 2L] row; rows that would overflow it come back
   `row_bad` for the host.
2. Pre-split: whitespace chars die, each punctuation char is a word of
   its own, other runs are words (the char-class table; no regex).
3. Longest match (`longest_match`): rolling prefix hashes give every
   substring's two 32-bit hashes in O(1); for every char start the
   longest vocab hit (the `##` continuation mixed into the key) is found
   by sweeping the candidate byte lengths against the vocab's cuckoo
   table.  The greedy token chain `s -> s + m[s]` of every word is
   resolved at once by pointer doubling (`chain_reach`, one host read per
   doubling).  A reached position with no match, or a word over
   `max_word_chars` chars, makes the whole word `[UNK]`, as the
   reference does.

With `with_offsets` it also gives each token's span in the original
chars of its row (the source char of each normalized byte rides the
normalization) and its word's rank in the row.

Hash equality stands in for string equality (two 32-bit hashes and the
exact length).  The hashes are uint32 arithmetic done in int64 masked to
32 bits (`merge_table.mul32`), bit for bit the JAX program's.
"""

from __future__ import annotations

import torch

from .bert_tables import BERT_PUNCT, BERT_WS, NORM_K
from .bpe_dedup import H1_MULT, H2_MULT, _M32, _to_i32, rolling_hash
from .bpe_encode import take256
from .bpe_merge2 import _rev_cummin, _shift_next, _shift_prev
from .merge_table import hash_pair, mul32
from .route import compact_left

CONT_MIX1 = 0x5BD1E995
CONT_MIX2 = 0x2545F491
BIG = 0x7FFFFFFF

def decode_chars(b, inb):
    """(codepoint, is_start, charlen) of packed UTF-8 bytes (int32 [B, L]);
    the JAX package's `_decode_chars`."""
    is_cont = (b & 0xC0) == 0x80
    is_start = inb & ~is_cont
    charlen = 1 + (b >= 0xC0).int() + (b >= 0xE0).int() + (b >= 0xF0).int()
    b1, b2, b3 = (_shift_next(b, 0, k) for k in (1, 2, 3))
    cp = torch.where(
        charlen == 1, b,
        torch.where(
            charlen == 2, ((b & 0x1F) << 6) | (b1 & 0x3F),
            torch.where(
                charlen == 3, ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F),
                ((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F),
            ),
        ),
    )
    return cp.clamp(0, 0x10FFFF), is_start, charlen


def fill_last(v, transparent):
    """Per position, the value at the last position at or before it whose
    value is not `transparent` (`transparent` where there is none): the
    JAX program's "rightmost non-transparent wins" scan."""
    pos = torch.arange(v.shape[1], device=v.device).expand_as(v)
    j = torch.cummax(torch.where(v != transparent, pos, -1), 1).values
    return torch.where(j >= 0, v.gather(1, j.clamp(min=0)), transparent)


def _prefix_hash(nb, mult, max_len):
    """E[:, i] = hash(nb[:, :i]) for i in 0..C, then max_len zero columns;
    int64 in [0, 2^32)."""
    B = nb.shape[0]
    hh = rolling_hash(nb, torch.zeros_like(nb, dtype=torch.bool), mult)
    z = hh.new_zeros
    return torch.cat([z((B, 1)), hh, z((B, max_len))], 1)


def longest_match(nb, s_ok, cont, last, T):
    """(m, mid): per position, the byte length and id of the longest vocab
    entry that starts there and ends at or before `last` (0 and 0 where
    none).  Only `s_ok` positions match; `cont` ones look up the `##`
    continuation keys.  `T`: the engine's tables (`tables_from_numpy`)."""
    B, C = nb.shape
    max_len = T["max_len"]
    npos = torch.arange(C, device=nb.device).expand(B, C)
    E1 = _prefix_hash(nb, H1_MULT, max_len)
    E2 = _prefix_hash(nb, H2_MULT, max_len)
    E1b, E2b = E1[:, :C], E2[:, :C]
    mix1 = torch.where(cont, CONT_MIX1, 0).to(torch.int32)
    mix2 = torch.where(cont, CONT_MIX2, 0).to(torch.int32)
    rows0, rows1, seed = T["vrows0"], T["vrows1"], T["vseed"]
    vmask = rows0.shape[0] - 1
    m = torch.zeros((B, C), dtype=torch.int32, device=nb.device)
    mid = torch.zeros_like(m)
    for l in range(1, max_len + 1):
        valid = s_ok & ((npos + (l - 1)) <= last)
        h1 = _to_i32((E1[:, l:l + C] - mul32(E1b, int(T["pow1"][l]))) & _M32) ^ mix1
        h2 = _to_i32((E2[:, l:l + C] - mul32(E2b, int(T["pow2"][l]))) & _M32) ^ mix2
        r0 = rows0[hash_pair(h1, h2, seed, vmask, 0).to(torch.int64)]
        r1 = rows1[hash_pair(h1, h2, seed, vmask, 1).to(torch.int64)]
        hit0 = (r0[..., 0] == h1) & (r0[..., 1] == h2)
        hit1 = (r1[..., 0] == h1) & (r1[..., 1] == h2)
        stored_l = torch.where(hit0, r0[..., 2], r1[..., 2])
        stored_id = torch.where(hit0, r0[..., 3], r1[..., 3])
        hit = valid & (hit0 | hit1) & (stored_l == l)
        m = torch.where(hit, l, m)
        mid = torch.where(hit, stored_id, mid)
    return m, mid


def chain_reach(start, s_ok, m, max_word_chars):
    """The positions each word's greedy token chain reaches from its
    `start` (bool [B, C]): pointer doubling over s -> s + m[s], a
    position without a match jumping to a sink.  Stops when a doubling
    adds nothing, or after max(7, bit_length(max_word_chars)) doublings
    (a chain has at most max_word_chars tokens), as the JAX loop does;
    one host read per doubling."""
    B, C = m.shape
    dev = m.device
    npos = torch.arange(C, device=dev).expand(B, C)
    sink = C
    nxt = torch.where(s_ok & (m > 0), npos + m, sink).clamp(0, C)
    reach = torch.cat([start, torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
    jump = torch.cat([nxt, torch.full((B, 1), sink, device=dev)], 1).to(torch.int64)
    k_dbl = max(7, int(max_word_chars).bit_length())
    for _ in range(k_dbl):
        stepped = torch.zeros((B, C + 1), dtype=torch.uint8, device=dev).scatter_reduce_(
            1, jump, reach.to(torch.uint8), "amax")
        stepped[:, sink] = 0
        stepped = stepped.bool()
        grew = bool((stepped & ~reach).any())
        reach = reach | stepped
        jump = jump.gather(1, jump)
        if not grew:
            break
    return reach[:, :C]


def word_fail(head, in_word, headp, fail_pos):
    """Per position, whether its word has a failure (`fail_pos` anywhere
    in it): the flags gathered at each word's head (`headp`, -1 outside
    words), then filled over the word."""
    B, C = head.shape
    tgt = torch.where(fail_pos & (headp >= 0), headp, C).to(torch.int64)
    wf = torch.zeros((B, C + 1), dtype=torch.uint8, device=head.device).scatter_reduce_(
        1, tgt, fail_pos.to(torch.uint8), "amax")[:, :C].bool()
    fword = torch.where(head, (wf & head).int(), torch.where(in_word, -3, -1))
    return in_word & (fill_last(fword, -3) == 1)


def _normalize_ascii(b, inb, pos, T, with_offsets):
    """(nb, total, src_char): the byte map with dropped chars compacted
    out; src_char the source position of each kept byte (-1 beyond)."""
    ob = take256(b, T["ascii_nb"])
    keep = inb & (ob != 255)
    if with_offsets:
        (nb, src), total = compact_left((ob, pos), keep, (0, -1))
    else:
        (nb,), total = compact_left((ob,), keep, (0,))
        src = None
    return nb, total, src


def _normalize_generic(b, inb, T, L2, with_offsets):
    """(nb [B, L2], total, row_bad, src_char): each char's normalized bytes
    (up to NORM_K, from the two-stage table) scattered to its exclusive
    prefix sum of output lengths; writes past the row go to a dump column
    L2 + NORM_K - 1, which is never read."""
    B, L = b.shape
    dev = b.device
    cp, is_start, _ = decode_chars(b, inb)
    page = T["norm_s1"][(cp >> 8).to(torch.int64)]
    tidx = ((page << 8) | (cp & 255)).to(torch.int64)
    olen = torch.where(is_start, T["norm_ol"][tidx].to(torch.int32), 0)
    row_bad = (olen < 0).any(1)
    olen = olen.clamp(min=0)
    opos = torch.cumsum(olen, 1, dtype=torch.int32) - olen  # exclusive
    total = olen.sum(1, dtype=torch.int32)
    row_bad = row_bad | (total > L2)

    dump = L2 + NORM_K - 1
    kk = torch.arange(NORM_K, device=dev)
    w = (kk < olen[..., None]) & is_start[..., None]  # [B, L, NORM_K]
    tgt = opos[..., None] + kk
    tgt = torch.where(w & (tgt < L2 + NORM_K), tgt, dump).reshape(B, L * NORM_K)
    vals = torch.where(w, T["norm_ob"][tidx], 0).reshape(B, L * NORM_K)
    nb = torch.zeros((B, L2 + NORM_K), dtype=torch.uint8, device=dev)
    nb.scatter_(1, tgt.to(torch.int64), vals.to(torch.uint8))
    nb = nb[:, :L2].to(torch.int32)
    src = None
    if with_offsets:
        # each input char's index at its first output byte, filled forward
        in_char = torch.cumsum(is_start.int(), 1, dtype=torch.int32) - 1
        emit = is_start & (olen > 0)
        stgt = torch.where(emit & (opos < L2 + NORM_K), opos, dump).to(torch.int64)
        srcm = torch.full((B, L2 + NORM_K), -1, dtype=torch.int32, device=dev)
        srcm.scatter_(1, stgt, torch.where(emit, in_char, -1))
        srcm = srcm[:, :L2]
        src = fill_last(srcm, -1)
    return nb, total, row_bad, src


def bert_split(nb, ninb, nstart, cls, cls_fill, total):
    """BertPreTokenizer on normalized bytes.  Returns (bnd: word heads,
    is_ws: whitespace bytes, in_word, marker: heads, whitespace and
    padding, next_marker: the first marker after each position, at most
    the row's length)."""
    B, C = nb.shape
    npos = torch.arange(C, device=nb.device).expand(B, C)
    is_ws = (cls_fill == BERT_WS) & ninb
    in_word = ninb & ~is_ws
    prev_cls = torch.where(npos == 0, -2, _shift_prev(cls_fill, -2))
    bnd = nstart & ~is_ws & ((cls == BERT_PUNCT) | (prev_cls == BERT_WS)
                             | (prev_cls == BERT_PUNCT) | (prev_cls == -2))
    marker = bnd | is_ws | ~ninb
    nxt = _rev_cummin(torch.where(marker, npos, BIG))
    next_marker = torch.minimum(_shift_next(nxt, BIG), total[:, None])
    return bnd, is_ws, in_word, marker, next_marker


def wordpiece_program(bytes_u8, lengths, T, expand=2, with_offsets=False,
                      ascii_only=False):
    """uint8[B, L] bytes + int32[B] lengths -> (ids int32[B, L2], ntok
    int32[B], row_bad bool[B]), L2 = L * expand; with `with_offsets` also
    (st_char, en_char, word_idx), each int32[B, L2]: every token's span in
    the original chars of its row and its word's rank in the row.

    `ascii_only` (every byte < 128, expand 1): the byte map and the
    per-byte classes instead of the UTF-8 decode and the table gathers.
    `T`: the engine's tables (`wordpiece_engine.tables_from_numpy`)."""
    B, L = bytes_u8.shape
    L2 = L * expand
    dev = bytes_u8.device
    pos = torch.arange(L, dtype=torch.int32, device=dev).expand(B, L)
    inb = pos < lengths[:, None]
    b = torch.where(inb, bytes_u8.to(torch.int32), 0)
    npos = torch.arange(L2, dtype=torch.int32, device=dev).expand(B, L2)

    if ascii_only:
        assert expand == 1
        nb, total, src_char = _normalize_ascii(b, inb, pos, T, with_offsets)
        ninb = npos < total[:, None]
        nb = torch.where(ninb, nb, 0)
        row_bad = torch.zeros((B,), dtype=torch.bool, device=dev)
        nstart = ninb
        cls = torch.where(ninb, take256(nb, T["ascii_cls"]), -1)
        cls_fill = cls
    else:
        nb, total, row_bad, src_char = _normalize_generic(b, inb, T, L2, with_offsets)
        ninb = npos < total[:, None]
        nb = torch.where(ninb, nb, 0)
        cp2, nstart, _ = decode_chars(nb, ninb)
        pg2 = T["cls_s1"][(cp2 >> 8).to(torch.int64)]
        cls = T["cls_s2"][((pg2 << 8) | (cp2 & 255)).to(torch.int64)].to(torch.int32)
        f = torch.where(nstart, cls, -1)
        for _ in range(3):  # the class over a char's continuation bytes
            f = torch.where(f >= 0, f, _shift_prev(f, -1))
        cls_fill = f
    if with_offsets:
        src_char = torch.where(ninb, src_char, -1)

    bnd, is_ws, in_word, marker, next_marker = bert_split(nb, ninb, nstart, cls, cls_fill,
                                                          total)
    wend = next_marker - 1  # each word byte's last byte of its word
    h = torch.where(bnd, npos, torch.where(is_ws | ~ninb, -1, -3))
    headp = fill_last(h, -3)
    headp = torch.where(in_word & (headp >= 0), headp, -1)

    # chars per word (max_input_chars_per_word): the char count at the
    # word's last byte, filled back over the word
    char_idx = torch.cumsum(nstart.int(), 1, dtype=torch.int32)
    is_last = ninb & _shift_next(marker, True)
    last_pos = _rev_cummin(torch.where(is_last, npos, BIG))
    cend = torch.where(last_pos < BIG, char_idx.gather(1, last_pos.clamp(max=L2 - 1).long()), 0)
    long_word = bnd & ((cend - char_idx + 1) > T["max_word_chars"])

    s_ok = in_word & nstart
    m, mid = longest_match(nb, s_ok, in_word & nstart & ~bnd, wend, T)
    reach = chain_reach(bnd & ~long_word, s_ok, m, T["max_word_chars"])
    fail_pos = (reach & s_ok & (m == 0)) | long_word
    in_fail_word = word_fail(bnd, in_word, headp, fail_pos)
    token = (reach & ~in_fail_word & (m > 0)) | (bnd & in_fail_word)
    out_id = torch.where(in_fail_word, T["unk_id"], mid).to(torch.int32)

    # left-pack the tokens; other positions write the dump column L2
    k = torch.cumsum(token.int(), 1, dtype=torch.int32) - 1
    ntok = torch.where(token, k + 1, 0).amax(1).to(torch.int32)
    scatter_idx = torch.where(token, k, L2).to(torch.int64)

    def pack(x, fill):
        out = torch.full((B, L2 + 1), fill, dtype=torch.int32, device=dev)
        return out.scatter_(1, scatter_idx, x.to(torch.int32))[:, :L2]

    ids = pack(out_id, -1)
    if not with_offsets:
        return ids, ntok, row_bad

    # token extents in normalized bytes: a token starts at its position
    # ([UNK] at its word's head) and ends at the next token's start in the
    # same word, else at its word's end
    starts_p = pack(torch.where(in_fail_word, headp, npos), 0)
    words_p = pack(torch.where(headp >= 0, headp, 0), -2)
    wend_p = pack(wend.clamp(0, L2 - 1), 0)
    tpos = torch.arange(L2, device=dev).expand(B, L2)
    in_tok = tpos < ntok[:, None]
    same = in_tok & (_shift_next(words_p, -2) == words_p) & _shift_next(in_tok, False)
    ends_p = torch.where(same, _shift_next(starts_p, 0), wend_p + 1)
    ends_p = torch.where(in_tok, ends_p, 0)
    # normalized bytes -> original chars
    src_pad = torch.cat([src_char, src_char.new_zeros((B, 1))], 1)
    st_char = src_pad.gather(1, starts_p.clamp(0, L2).to(torch.int64))
    en_char = src_pad.gather(1, (ends_p - 1).clamp(0, L2).to(torch.int64)) + 1
    st_char = torch.where(in_tok, st_char, 0)
    en_char = torch.where(in_tok, en_char, 0)
    # each token's word: the dense rank of its word's head in the row
    new_word = (words_p != _shift_prev(words_p, -3)) & in_tok
    word_idx = torch.cumsum(new_word.int(), 1, dtype=torch.int32) - 1
    word_idx = torch.where(in_tok, word_idx, -1)
    return ids, ntok, row_bad, st_char, en_char, word_idx
