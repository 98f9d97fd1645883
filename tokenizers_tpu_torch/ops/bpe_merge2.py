"""BPE merge rounds (the encode hot loop), port of
`tokenizers_tpu.ops.bpe_merge2`.

Tokens live in a tombstoned [R, C] buffer (id -1 = dead) with a word id per
position; words never cross rows.  One round merges the *safe set* of pairs
of every word (see `merge_round`), so a word of n bytes needs far fewer
than n rounds.  The loops run the round through the two CUDA kernels of
`merge_kernels` (keys once per loop, then one fused round per step); their
plain versions take over only for tensors on the CPU.  `_round`, one
standalone round, goes through the third (B4).

The helpers below are the plain torch forms of the JAX package's
shift-fills and scans, with the same bounds: `fill_next`/`fill_prev` see
only 2^k_steps positions away, the segmented scans are unbounded.

The data-dependent `while_loop`s of the JAX program are Python loops that
read one flag from the device per round (`.item()`).
"""

from __future__ import annotations

import torch

from .route import compact_left, route_to

INF = 0x7FFFFFFF
BIG = 0x3FFFFFF0
WORD_CAP = 512  # max word length in bytes; FILL_K = 9 covers its gaps
FILL_K = 9


def _cols(x):
    R, C = x.shape
    return torch.arange(C, dtype=torch.int64, device=x.device).expand(R, C)


def _shift_prev(x, fill, k=1):
    """x[:, j-k] (row-wise), first k cols <- fill."""
    if k >= x.shape[1]:
        return torch.full_like(x, fill)
    return torch.cat([torch.full_like(x[:, :k], fill), x[:, :-k]], dim=1)


def _shift_next(x, fill, k=1):
    """x[:, j+k] (row-wise), last k cols <- fill."""
    if k >= x.shape[1]:
        return torch.full_like(x, fill)
    return torch.cat([x[:, k:], torch.full_like(x[:, :k], fill)], dim=1)


def _rev_cummin(x):
    return torch.flip(torch.cummin(torch.flip(x, [1]), 1).values, [1])


def next_index(mask):
    """First position j > i of each row with mask[j], else C (int64)."""
    C = mask.shape[1]
    first = _rev_cummin(torch.where(mask, _cols(mask), C))
    return _shift_next(first, C)


def prev_index(mask):
    """Last position j < i of each row with mask[j], else -1 (int64)."""
    last = torch.cummax(torch.where(mask, _cols(mask), -1), 1).values
    return _shift_prev(last, -1)


def _take(vals, idx, found):
    C = idx.shape[1]
    ic = idx.clamp(0, C - 1)
    return [at(v, ic, found) for v in vals]


def at(v, j, found):
    """v at the positions j where found, else 0 (False)."""
    return torch.where(found, v.gather(1, j), False if v.dtype == torch.bool else 0)


def next_within(alive, k_steps: int):
    """(j, found): the first alive position strictly after each one, found
    within 2^k_steps positions; j clamped into the row."""
    C = alive.shape[1]
    j = next_index(alive)
    fnd = (j < C) & (j - _cols(alive) <= (1 << k_steps))
    return j.clamp_(max=C - 1), fnd


def prev_within(alive, k_steps: int):
    """(j, found): the last alive position strictly before each one, found
    within 2^k_steps positions; j clamped into the row."""
    j = prev_index(alive)
    fnd = (j >= 0) & (_cols(alive) - j <= (1 << k_steps))
    return j.clamp_(min=0), fnd


def fill_next(vals, alive, k_steps=FILL_K):
    """Per position: values at the first alive position strictly after it,
    within 2^k_steps positions (0 and found=False beyond).
    Returns (filled_vals, found_mask)."""
    j, fnd = next_within(alive, k_steps)
    return [at(v, j, fnd) for v in vals], fnd


def fill_prev(vals, alive, k_steps=FILL_K):
    """Per position: values at the last alive position strictly before it,
    within 2^k_steps positions (0 and found=False beyond)."""
    j, fnd = prev_within(alive, k_steps)
    return [at(v, j, fnd) for v in vals], fnd


def neighbour_index(alive, k_steps: int):
    """(j_next, found_next, j_prev, found_prev): `next_within` and
    `prev_within` at once; fills of several values at one `alive` are
    gathers at these indices (`at`)."""
    return (*next_within(alive, k_steps), *prev_within(alive, k_steps))


def _group_ids(seg):
    """Row-unique int64 group index of each position's segment (positions
    before a row's first segment start form a group of their own)."""
    R, C = seg.shape
    g = torch.cumsum(seg.to(torch.int64), 1)
    return g + torch.arange(R, device=seg.device)[:, None] * (C + 1)


def _seg_min(r, seg_start):
    """Min of r over each contiguous segment delimited by seg_start."""
    g = _group_ids(seg_start).reshape(-1)
    R, C = r.shape
    tbl = torch.full((R * (C + 1),), INF, dtype=r.dtype, device=r.device)
    tbl.scatter_reduce_(0, g, r.reshape(-1), "amin")
    return tbl[g].reshape(R, C)


def _seg_count(add, reset):
    """Inclusive segmented sum of `add`, restarting at `reset` positions."""
    a = add.to(torch.int64)
    c = torch.cumsum(a, 1)
    last = torch.cummax(torch.where(reset, _cols(a), -1), 1).values
    base = torch.where(last >= 0, (c - a).gather(1, last.clamp(0)), 0)
    return (c - base).to(torch.int32)


def _fill_last_vals(vals, isset, reverse=False):
    """Per position: the values at the last position at-or-before it where
    `isset` (at-or-after when reverse); 0 where there is none."""
    C = isset.shape[1]
    if reverse:
        j = _rev_cummin(torch.where(isset, _cols(isset), C))
        found = j < C
    else:
        j = torch.cummax(torch.where(isset, _cols(isset), -1), 1).values
        found = j >= 0
    return _take(vals, j, found)


def _seg_of(wid):
    return wid != _shift_prev(wid, -2)


def select_rows(ids, nid, h0, h1, rows0, rows1):
    """Merge-table row reads at the carried slot hashes, and the hit
    select: (rank, new_id, MCL(new_id), MCR(new_id)), rank INF on a miss.
    A hit in table 0 takes precedence."""
    r0 = rows0[h0.to(torch.int64)]
    r1 = rows1[h1.to(torch.int64)]
    hit0 = (r0[..., 0] == ids) & (r0[..., 1] == nid)
    hit1 = (r1[..., 0] == ids) & (r1[..., 1] == nid)

    def sel(k):
        return torch.where(hit0, r0[..., k], r1[..., k])

    r_in = torch.where(hit0 | hit1, sel(2), torch.full_like(ids, INF))
    return r_in, sel(3), sel(4), sel(5)


def lookup_pairs8(a, b, rows0, rows1, seed):
    """(rank, new_id, MCL(new_id), MCR(new_id)) of pairs (a, b)."""
    from .merge_table import hash_pair

    mask = rows0.shape[0] - 1
    h0 = hash_pair(a, b, seed, mask, 0)
    h1 = hash_pair(a, b, seed, mask, 1)
    return select_rows(a, b, h0, h1, rows0, rows1)


def apply_round(ids, own_l, own_r, wid, seg, r_in, new_id, mcl_new, mcr_new,
                k_steps=FILL_K):
    """The merge decision and its application, given each position's
    looked-up pair row (`select_rows`).  Returns (ids, own_l, own_r, f).

    A candidate pair p = (L, R) with rank r, neighbor tokens P (left) and
    N (right) is inevitable iff r < r_prev, r <= MCL(P), r < r_next and
    r <= MCR(N) + 1 (MCL/MCR: the minimum ranks of merges that consume a
    token from the right/left, `merge_table.consume_mins`).  Runs of equal
    ranks (the same pair repeated) merge at odd ordinals, gated by the
    run's head and tail safety; each word's minimum-rank pair merges as
    well.  The merged set is the reference's sequential (rank, pos) heap
    order for well-formed tables."""
    alive = ids >= 0
    inf = torch.full_like(ids, INF)
    mcl_own = torch.where(alive, own_l, inf)
    mcr_own = torch.where(alive, own_r, inf)

    (nid, nwid, nmcr), nfnd = fill_next([ids, wid, mcr_own], alive, k_steps)
    valid = alive & nfnd & (nwid == wid)
    r = torch.where(valid, r_in, inf)
    cand = valid & (r < INF)

    (nr, nvalid, nnmcr), _ = fill_next(
        [r, valid.to(torch.int32), nmcr], alive, k_steps
    )
    (pr, pw, pmcl), pfound = fill_prev([r, wid, mcl_own], alive, k_steps)
    prev_in_word = pfound & (pw == wid)

    same_run_prev = cand & prev_in_word & (pr == r)
    run_start = cand & ~same_run_prev
    has_next_pair = valid & nfnd & (nvalid == 1)
    same_run_next = cand & has_next_pair & (nr == r)
    tail = cand & ~same_run_next

    head_ok = run_start & (~prev_in_word | ((r < pr) & (r <= pmcl)))
    tail_ok = tail & (r < nr) & (
        ~has_next_pair | (r <= torch.clamp(nnmcr, max=BIG) + 1)
    )

    q = _seg_count(cand, seg)
    hl, q_head = _fill_last_vals([head_ok.to(torch.int32), q], run_start)
    (tl,) = _fill_last_vals([tail_ok.to(torch.int32)], tail, reverse=True)
    parity_odd = ((q - q_head) & 1) == 0

    wmin = _seg_min(r, seg)
    f = cand & parity_odd & ((r == wmin) | ((hl == 1) & (tl == 1)))

    (pm,), pfnd = fill_prev([f.to(torch.int32)], alive, k_steps)
    kill = alive & pfnd & (pm == 1)
    ids = torch.where(f, new_id, ids)
    ids = torch.where(kill, torch.full_like(ids, -1), ids)
    own_l = torch.where(f, mcl_new, own_l)
    own_r = torch.where(f, mcr_new, own_r)
    return ids, own_l, own_r, f


def merge_round(ids, own_l, own_r, wid, seg, rows0, rows1, seed,
                k_steps=FILL_K):
    """One self-contained merge round (the oracle of the fused kernel):
    pair keys, table lookup, `apply_round`.  Returns (ids, own_l, own_r,
    f) with f the merged-head mask."""
    alive = ids >= 0
    (nid,), _ = fill_next([ids], alive, k_steps)
    r_in, new_id, mcl_new, mcr_new = lookup_pairs8(ids, nid, rows0, rows1, seed)
    return apply_round(
        ids, own_l, own_r, wid, seg, r_in, new_id, mcl_new, mcr_new, k_steps
    )


def _round(ids, own_l, own_r, wid, rows0, rows1, seed, k_steps=FILL_K):
    """One standalone merge round (keys recomputed, none carried out):
    kernel B4 on the card, its plain version (`merge_round`) on the CPU.
    Word segments derive from wid.  Returns (ids, own_l, own_r, f).  The
    merge loops use `make_round_driver` instead, which carries the keys."""
    from .merge_kernels import merge_round_standalone

    return merge_round_standalone(ids, own_l, own_r, wid, rows0, rows1, seed,
                                  k_steps=k_steps)


def init_own(ids, mclr):
    """Initial per-position (MCL, MCR) carried state for the rounds."""
    V = mclr.shape[0]
    own = mclr[ids.clamp(0, V - 1).to(torch.int64)]
    return own[..., 0].contiguous(), own[..., 1].contiguous()


def make_round_driver(wid, rows0, rows1, seed, k_steps=FILL_K):
    """(init, step, unpack) for running merge rounds in a loop.

    The state carries the NEXT round's pair keys (h0, h1, next-id): `init`
    launches the keys kernel once, and each `step` is one fused round
    kernel that applies the merges and emits the next keys.  Word
    segments come from `wid` (the kernel derives them)."""
    from .merge_kernels import keys, merge_round_fused

    def init(ids, own_l, own_r):
        h0, h1, nid = keys(ids, rows0, seed, k_steps=k_steps)
        return (ids, own_l, own_r, h0, h1, nid)

    def step(st):
        ids, ol, orr, h0, h1, nid = st
        ids2, ol2, orr2, f, h0n, h1n, nidn = merge_round_fused(
            ids, ol, orr, wid, h0, h1, nid, rows0, rows1, seed,
            k_steps=k_steps,
        )
        return (ids2, ol2, orr2, h0n, h1n, nidn), f

    def unpack(st):
        return st[0], st[1], st[2]

    return init, step, unpack


def compact(ids, wid, w_new, extras=()):
    """Left-pack alive tokens into width w_new; overflow rows flagged.
    Returns (ids, wid, bad, extras)."""
    alive = ids >= 0
    vals = (ids, wid) + tuple(extras)
    out, ntok = compact_left(vals, alive, (-1,) * len(vals))
    bad = ntok > w_new
    out = tuple(v[:, :w_new].contiguous() for v in out)
    return out[0], out[1], bad, out[2:]


def _word_any(f, seg):
    """Per position: whether any position of its word has `f` set."""
    g = _group_ids(seg).reshape(-1)
    R, C = f.shape
    tbl = torch.zeros((R * (C + 1),), dtype=torch.int32, device=f.device)
    tbl.scatter_reduce_(0, g, f.reshape(-1).to(torch.int32), "amax")
    return tbl[g].reshape(R, C) > 0


def _g_excl_cumsum(x):
    """Row-major global exclusive cumsum of a 2D int array (int32)."""
    flat = x.reshape(-1).to(torch.int64)
    return (torch.cumsum(flat, 0) - flat).to(torch.int32).reshape(x.shape)


def _tail_ladder(ids, own_l, own_r, f, wid3, seg3, rows0, rows1, seed,
                 obp=None, depth=2):
    """Data-dependent merge tail on buffers sized to the ACTIVE words.

    A word with no merge in a round is finished for good (every round
    merges each word's minimum-rank pair), so after the scheduled rounds
    the still-active words are moved into a buffer of half the rows (then
    1/8 of that, `depth` rungs), merged there until dry, and routed back
    to their home positions.  `obp` (each token's original byte position,
    the offsets path's) rides the moves there and back.  Returns
    (ids, obp') at the input shape (obp' None without obp)."""
    return _ladder_rung(
        ids, own_l, own_r, f, wid3, seg3, rows0, rows1, seed, obp=obp,
        depth=depth,
    )


def _ladder_rung(ids, own_l, own_r, f, wid3, seg3, rows0, rows1, seed,
                 obp=None, depth=0, ratio=2):
    B3, C3 = ids.shape
    R4 = max(B3 // ratio, 2)
    C4 = C3
    slack = min(WORD_CAP, C4 // 2)
    C4eff = C4 - slack
    CAP4 = R4 * C4eff
    last = depth == 0 or R4 >= B3

    init, step, unpack = make_round_driver(wid3, rows0, rows1, seed)

    if last:
        # bottom rung: plain rounds until dry
        st = init(ids, own_l, own_r)
        any_f = bool(f.any())
        while any_f:
            st, f2 = step(st)
            any_f = bool(f2.any())
        return unpack(st)[0], obp

    def act_stats(ids_, f_):
        alive_ = ids_ >= 0
        act = alive_ & _word_any(f_ & alive_, seg3)
        return act, int(act.sum())

    # rounds at this width while the active set is too big for the next rung
    _a, n = act_stats(ids, f)
    st = init(ids, own_l, own_r)
    while bool(f.any()) and n > CAP4:
        st, f = step(st)
        _a, n = act_stats(st[0], f)
    ids, own_l, own_r = unpack(st)
    act, _n = act_stats(ids, f)

    # ---- move the active words' alive tokens to [R4, C4] ---------------
    dev = ids.device
    rowi = torch.arange(B3, device=dev, dtype=torch.int32)[:, None].expand(B3, C3)
    coli = torch.arange(C3, device=dev, dtype=torch.int32).expand(B3, C3)
    # global word ordinal: words from different rows that become adjacent
    # after compaction must still compare unequal
    segi = seg3.to(torch.int32)
    gw = _g_excl_cumsum(segi) + segi - 1
    r_d = _g_excl_cumsum(act.to(torch.int32))  # dense rank among actives
    k_w = _seg_count(act, seg3) - 1  # within-word rank (at act positions)
    b_w = r_d - k_w  # word base = first active position's dense rank
    tgt = (b_w // C4eff) * C4 + (b_w % C4eff) + k_w
    home = rowi * C3 + coli
    extra = () if obp is None else (obp,)
    routed, live4 = route_to(
        (ids, own_l, own_r, gw, home) + extra, act, torch.where(act, tgt, 0),
        (-1, 0, 0, -1, 0) + (0,) * len(extra), wrap=True, n_out=R4 * C4,
    )
    ids4, ol4, orr4, gw4, home4 = routed[:5]
    seg4 = _seg_of(gw4)

    # ---- recurse: rounds at 1/8 of these rows (and below) until dry ----
    ids4, obp4 = _ladder_rung(
        ids4, ol4, orr4, live4, gw4, seg4, rows0, rows1, seed,
        obp=routed[5] if extra else None, depth=depth - 1, ratio=8,
    )

    # ---- route finished tokens back to their home positions ------------
    alive4 = ids4 >= 0
    extra = () if obp is None else (obp4,)
    backed, liveb = route_to(
        (ids4,) + extra, alive4, torch.where(alive4, home4, 0),
        (-1,) + (0,) * len(extra), wrap=True, n_out=B3 * C3,
    )
    ids = torch.where(liveb, backed[0], torch.where(act, -1, ids))
    if obp is not None:
        obp = torch.where(liveb, backed[1], obp)
    return ids, obp


def _rounds_loop(ids, own_l, own_r, wid, rows0, rows1, seed, n_max):
    """Up to `n_max` merge rounds at this width, stopping early when a
    round makes no merges.  Returns (ids, own_l, own_r, f) with `f` the
    last round's merged-head mask (all True if no round ran)."""
    init, step, unpack = make_round_driver(wid, rows0, rows1, seed)
    st = init(ids, own_l, own_r)
    f = torch.ones(wid.shape, dtype=torch.bool, device=wid.device)
    rounds = 0
    any_f = True
    while any_f and rounds < n_max:
        st, f = step(st)
        any_f = bool(f.any())
        rounds += 1
    ids, own_l, own_r = unpack(st)
    return ids, own_l, own_r, f


def _round_width(W, frac_num, frac_den):
    w = (W * frac_num) // frac_den
    if w >= 256:
        w = -(-w // 128) * 128
    return max(w, 64)


def run_merge_phases(ids, wid, rows0, rows1, seed, mclr, ladder_depth=2,
                     obp=None):
    """Full merge to completion: two rounds at input width, compact to 5/8
    width, two rounds, compact to 1/2 width, two rounds, then the tail
    ladder.  Returns (ids, wid, row_bad) at the 1/2 width; compaction
    overflow flags row_bad (host fallback).

    `obp` (the offsets path's original byte position of each token) rides
    every compaction and ladder move; merges keep the left token's
    position, so the kernels never see it.  Given `obp`, the result has
    obp' as a fourth element."""
    W = ids.shape[1]
    extra = () if obp is None else (obp,)
    own_l, own_r = init_own(ids, mclr)
    ids, own_l, own_r, f = _rounds_loop(ids, own_l, own_r, wid, rows0, rows1, seed, 2)

    ids, wid2, bad, (own_l, own_r, *extra) = compact(
        ids, wid, _round_width(W, 5, 8), (own_l, own_r, *extra))
    ids, own_l, own_r, f = _rounds_loop(ids, own_l, own_r, wid2, rows0, rows1, seed, 2)

    ids, wid3, bad3, (own_l, own_r, *extra) = compact(
        ids, wid2, _round_width(W, 1, 2), (own_l, own_r, *extra))
    bad = bad | bad3
    ids, own_l, own_r, f = _rounds_loop(ids, own_l, own_r, wid3, rows0, rows1, seed, 2)

    ids, obp = _tail_ladder(
        ids, own_l, own_r, f, wid3, _seg_of(wid3), rows0, rows1, seed,
        obp=extra[0] if extra else None, depth=ladder_depth,
    )
    return (ids, wid3, bad) + (() if obp is None else (obp,))
