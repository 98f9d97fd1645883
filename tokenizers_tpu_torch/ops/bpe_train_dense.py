"""Device-resident BPE training: every merge on the device, the pair counts
in one dense `int32[v_cap, v_pad]` matrix; port of
`tokenizers_tpu.ops.bpe_train_dense`.

Selection is a flat argmax over the matrix: its first maximum is the
reference's (count desc, pair asc) tie-break (`models/bpe/trainer.rs:30-39`).
Each merge then runs one pass over the packed corpus (`pack_corpus`: words
never cross a row of `ncol` symbols) that finds the merge sites (overlap
parity within `aaa` chains), their left and right neighbours, and adds the
pair-count deltas straight into the matrix (`index_add_` of int32: integer
sums do not depend on order, so the counts are those of the JAX package's
per-merge delta matrix).

The JAX package runs the loop as one `lax.while_loop`, and so mints each
new token on the device by composable 32-bit fold hashes (`fold_hash`,
`seed_hash_state`; kept here as the JAX package's identity state) and
replays the decisions on real strings afterwards.  Here the loop is a
Python loop with one host read per merge: the next pair is selected and
its sites found, then (best, a, b, the number of sites) come back
together, and the host mints the token on its real string (an existing
id when the string exists: ("ab", "c") and ("a", "bc") make one token)
and hands the id to the device as an int.  The stop test and
the choice of delta branch (packed sites when they fit `site_cap`, else
every position; both give the same counts) are made on that read.

Over a process group (`shard`) the packed rows are split over the ranks
(`pack_corpus(..., nshard=ranks)`, each rank a contiguous block) and the
matrix is replicated.  The JAX package adds `psum(D)` of a dense delta
matrix each merge; here each rank's merge pass gives its (flat index,
delta) list, the lists are gathered (variable length) and every rank
`index_add_`s all of them: integer sums in any order, so the matrices stay
bit-equal, and no dense matrix crosses the group (about 1 GB a merge at
v_cap 16,385).  The initial matrix is counted from every row on every
rank, and the stop test reads the sites summed over the group.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .bpe_merge2 import _seg_count, at, neighbour_index
from ..trainers.bpe_trainer import merged_token

H1_MULT = 0x01000193
H2_MULT = 0x0000C597
M32 = 0xFFFFFFFF

# dense registry cap: v_cap^2 * 4 bytes; the JAX package sized it for a
# matrix replicated on each 16 GB TPU chip.  Above it the per-round
# registry path (parallel/bpe_train.py) takes over.
DENSE_VCAP_MAX = 16384
NCOL_MAX = 1 << 15
SITE_CAP = 8192


def fold_hash(data: bytes, mult: int) -> Tuple[int, int]:
    """(hash, MULT^len mod 2^32) of a byte string; it composes as
    h(A.B) = h(A)*pw(B) + h(B) (mod 2^32)."""
    h = 0
    pw = 1
    m = int(mult)
    for byte in data:
        h = (h * m + byte + 1) & M32
        pw = (pw * m) & M32
    return h, pw


def seed_hash_state(id_to_word: List[str], v_cap: int, prefix: str):
    """(H1, H2, HS1, HS2, PS1, PS2, BF, BS): the identity state of the
    initial vocabulary, numpy uint32 (hashes) and int32 (byte lengths)."""
    H1 = np.zeros(v_cap, np.uint32)
    H2 = np.zeros(v_cap, np.uint32)
    HS1 = np.zeros(v_cap, np.uint32)
    HS2 = np.zeros(v_cap, np.uint32)
    PS1 = np.ones(v_cap, np.uint32)
    PS2 = np.ones(v_cap, np.uint32)
    BF = np.zeros(v_cap, np.int32)
    BS = np.zeros(v_cap, np.int32)
    n_prefix = len(prefix.encode("utf-8"))
    for i, w in enumerate(id_to_word):
        wb = w.encode("utf-8")
        sb = wb[n_prefix:] if prefix and w.startswith(prefix) else wb
        H1[i], _ = fold_hash(wb, H1_MULT)
        H2[i], _ = fold_hash(wb, H2_MULT)
        HS1[i], PS1[i] = fold_hash(sb, H1_MULT)
        HS2[i], PS2[i] = fold_hash(sb, H2_MULT)
        BF[i] = len(wb)
        BS[i] = len(sb)
    return H1, H2, HS1, HS2, PS1, PS2, BF, BS


def pack_corpus(words, counts, ncol: int, nshard: int = 1):
    """Pack tokenized words into a flat [R, ncol] symbol stream.

    Words never cross a row boundary; rows pad with -1.  Returns
    (ids [R, ncol] i32, wid [R, ncol] i32 word index or -1, wcnt [R, ncol]
    i32 the word's count at each of its positions), numpy, with R a
    multiple of nshard."""
    rows: List[List[Tuple[int, int, int]]] = [[]]
    used = 0
    for i, (w, _lens) in enumerate(words):
        n = len(w)
        if n == 0:
            continue
        if n > ncol:
            raise ValueError(f"word of {n} symbols exceeds ncol={ncol}")
        if used + n > ncol:
            rows.append([])
            used = 0
        rows[-1].append((i, counts[i], n))
        used += n
    R = -(-max(len(rows), 1) // nshard) * nshard
    ids = np.full((R, ncol), -1, np.int32)
    wid = np.full((R, ncol), -1, np.int32)
    wcnt = np.zeros((R, ncol), np.int32)
    for r, row in enumerate(rows):
        c = 0
        for (i, cnt, n) in row:
            ids[r, c : c + n] = words[i][0]
            wid[r, c : c + n] = i
            wcnt[r, c : c + n] = cnt
            c += n
    return ids, wid, wcnt


def _spread(n: int, size: int, device) -> torch.Tensor:
    """n distinct-as-possible flat indices below `size`: where a masked
    entry adds 0 (anywhere is right; spread, the atomics do not collide)."""
    return torch.arange(n, dtype=torch.int64, device=device) % size


def initial_pair_matrix(ids: torch.Tensor, wid: torch.Tensor, wcnt: torch.Tensor,
                        v_cap: int, v_pad: int) -> torch.Tensor:
    """Dense initial pair counts int32 [v_cap, v_pad] of the packed stream,
    on its device (sums mod 2^32, as the JAX package's int64 sums cast)."""
    a = ids[:, :-1].reshape(-1).to(torch.int64)
    b = ids[:, 1:].reshape(-1).to(torch.int64)
    ok = (a >= 0) & (b >= 0) & (wid[:, :-1] == wid[:, 1:]).reshape(-1)
    c = wcnt[:, :-1].reshape(-1)
    C = torch.zeros(v_cap * v_pad, dtype=torch.int32, device=ids.device)
    idx = torch.where(ok, a * v_pad + b, _spread(a.numel(), C.numel(), ids.device))
    C.index_add_(0, idx, torch.where(ok, c, 0))
    return C.view(v_cap, v_pad)


def _select(C: torch.Tensor, v_pad: int):
    """(best, a, b) as 0-d tensors: the max count, at the first flat index,
    so (a, b) ascending among equal counts."""
    flat = C.view(-1)
    idx = torch.argmax(flat)
    # a gather: indexing by a 0-d tensor (`flat[idx]`) reads idx to the host
    return flat.gather(0, idx.view(1)).view(()), idx // v_pad, idx % v_pad


class Sites(NamedTuple):
    """One merge's sites and their neighbours over the [R, ncol] stream
    (`merge_sites`)."""

    site: torch.Tensor
    y: torch.Tensor
    r_ok: torch.Tensor
    x_pre: torch.Tensor
    l_exists: torch.Tensor
    lp_site: torch.Tensor
    kill: torch.Tensor
    new_len: torch.Tensor
    y_len: torch.Tensor
    x_len: torch.Tensor
    n_sites: torch.Tensor


def merge_sites(words, lens, wid, sa, sb, k_steps: int) -> Sites:
    """The sites of pair (sa, sb) (left-most first within a chain of equal
    symbols), the symbol after each absorbed one (y, pre-merge), the
    symbol before each site (x_pre, post-merge: the merged token when the
    left neighbour merges too, `lp_site`), and the positions the merge
    kills.  `lens` holds each symbol's length in chars at its position
    (the reference's `Symbol::len`: one id may cover different chars at
    two positions, '#' + strip('##') = '#' with the prefix '##'); the
    sites' new token, y and x_pre get theirs.  `sa`, `sb` may be 0-d
    tensors."""
    alive = words >= 0
    jn, fn, jp, fp = neighbour_index(alive, k_steps)
    nid, nwid, nlen = at(words, jn, fn), at(wid, jn, fn), at(lens, jn, fn)
    is_pair = alive & fn & (words == sa) & (nid == sb) & (nwid == wid)
    cnt = _seg_count(is_pair, alive & ~is_pair)
    site = is_pair & ((cnt % 2 == 1) | (sa != sb))

    # right context: y = the symbol after the absorbed one (pre-merge)
    nid2 = at(torch.where(fn, nid, -1), jn, fn)
    nwid2 = at(torch.where(fn, nwid, -1), jn, fn)
    r_ok = site & at(fn, jn, fn) & (nwid2 == wid)

    # left context: the previous alive symbol, and whether IT merges this
    # round (the left id is then the new token)
    p_id, p_wid, p_site = at(words, jp, fp), at(wid, jp, fp), at(site, jp, fp)
    p_len = at(lens, jp, fp)
    pp_id = at(torch.where(fp, p_id, -1), jp, fp)
    pv_killed = fp & at(fp, jp, fp) & at(p_site, jp, fp)
    return Sites(site=site, y=torch.where(r_ok, nid2, -1), r_ok=r_ok,
                 x_pre=torch.where(pv_killed, pp_id, p_id), l_exists=site & fp & (p_wid == wid),
                 lp_site=pv_killed | p_site, kill=alive & fp & p_site, new_len=lens + nlen,
                 y_len=at(nlen, jn, fn),
                 x_len=torch.where(pv_killed, at(p_len, jp, fp) + p_len, p_len),
                 n_sites=site.sum())


def _site_deltas(C, used, sa: int, sb: int, new_id: int, max_len: int,
                 y, r_ok, x_pre, l_exists, lp_site, c, new_len, y_len, x_len, group=None):
    """Add the per-site pair-count deltas into C in place:
      own pair (sa, sb): -c per site;
      right adjacency (sb, y) dies: -c; (new, y): +c, gated by length;
      left adjacency (x_post, sa) dies (x_post = new when the left symbol
      merged this round): -c; (x_post, new): +c, gated by length.
    With a process `group` the sites are this rank's, and every rank's
    (flat index, delta) list is gathered and added on every rank."""
    v_cap, v_pad = C.shape
    c = torch.where(used, c, 0)
    own = c.sum().to(torch.int32)
    if group is None:
        C[sa, sb] -= own

    rmask = used & r_ok
    yc = y.clamp(0, v_cap - 1).to(torch.int64)
    r_add = rmask & ((y_len + new_len) < max_len)
    lmask = used & l_exists
    xc = x_pre.clamp(0, v_cap - 1).to(torch.int64)
    l_add = lmask & ((x_len + new_len) < max_len)
    new_b = torch.full_like(yc, new_id)
    rows = torch.cat([torch.full_like(yc, sb), new_b, torch.where(lp_site, new_b, xc),
                      torch.where(lp_site, new_b, xc)])
    cols = torch.cat([yc, yc, torch.full_like(xc, sa), new_b])
    mask = torch.cat([rmask, r_add, lmask, l_add])
    vals = torch.cat([-c, c, -c, c])
    Cf = C.view(-1)
    if group is not None:
        from ..parallel.runtime import gather_cat

        keep = mask.nonzero().squeeze(1)
        idx = torch.cat([(rows * v_pad + cols)[keep], (rows.new_tensor([sa]) * v_pad + sb)])
        vals = torch.cat([vals[keep], -own.view(1)]).to(torch.int64)
        pairs = gather_cat(torch.stack([idx, vals], 1), group)  # one exchange a merge
        Cf.index_add_(0, pairs[:, 0], pairs[:, 1].to(C.dtype))
        return
    idx = torch.where(mask, rows * v_pad + cols, _spread(mask.numel(), Cf.numel(), C.device))
    Cf.index_add_(0, idx, torch.where(mask, vals, 0))


def _pack(site_flat, recs, cap: int):
    """The first `cap` sites' records, in stream order: positions by a
    cumulative sum, every other position written to a dump slot."""
    N = site_flat.numel()
    order = torch.cumsum(site_flat.to(torch.int64), 0) - 1
    dst = torch.where(site_flat, order.clamp(max=cap - 1), cap)
    pos = torch.zeros(cap + 1, dtype=torch.int64, device=site_flat.device)
    pos.scatter_(0, dst, torch.arange(N, dtype=torch.int64, device=site_flat.device))
    pos = pos[:cap]
    return [r.reshape(-1)[pos] for r in recs]


def merge_deltas(C, ctx: Sites, wcnt, sa: int, sb: int, new_id: int, max_len: int,
                 n_sites: int, site_cap: int, group=None) -> None:
    """The merge's deltas into C: over the packed sites when they fit
    `site_cap`, else over every position (the same counts); summed over
    `group` when one is given (`n_sites` is then this rank's)."""
    recs = (ctx.y, ctx.r_ok, ctx.x_pre, ctx.l_exists, ctx.lp_site, wcnt, ctx.new_len,
            ctx.y_len, ctx.x_len)
    if n_sites <= site_cap:
        recs = _pack(ctx.site.reshape(-1), recs, site_cap)
        used = torch.arange(site_cap, device=C.device) < n_sites
    else:
        recs = [r.reshape(-1) for r in recs]
        used = ctx.site.reshape(-1)
    _site_deltas(C, used, sa, sb, new_id, max_len, *recs, group=group)


def reach(width: int) -> int:
    """k_steps of the fills over rows of `width` symbols: 2^k >= width, so
    every live neighbour in a row is found."""
    return max(1, int(np.ceil(np.log2(max(2, width)))))


def dense_loop(words, wid, wcnt, C, cfg, word_to_id, id_to_word, max_len: int,
               merge_cap: int, site_cap: int, k_steps: int, stats, group=None) -> List:
    """Every merge, one host read each; returns [((a, b), new_id)] and
    extends word_to_id/id_to_word with the minted tokens.  With a process
    `group`, `words` is this rank's block and C is replicated."""
    v_pad = C.shape[1]
    prefix = cfg.continuing_subword_prefix
    lens = (words >= 0).to(torch.int32)
    merges: List[Tuple[Tuple[int, int], int]] = []
    reads = packed = 0
    floor = max(1, cfg.min_frequency)
    best, a, b = _select(C, v_pad)
    ctx = merge_sites(words, lens, wid, a, b, k_steps)
    pbar = cfg.merges_bar(len(word_to_id))
    while len(word_to_id) < cfg.vocab_size and len(merges) < merge_cap:
        read = [best.to(torch.int64), a, b, ctx.n_sites]
        if group is not None:  # the sites of every rank
            from ..parallel.runtime import all_sum

            read.append(all_sum(ctx.n_sites.view(1).clone(), group)[0])
        best_, sa, sb, n_sites, *total = torch.stack(read).tolist()
        reads += 1
        if best_ < floor:
            break
        if (total[0] if total else n_sites) == 0:
            raise RuntimeError(f"pair ({sa}, {sb}) was selected but has no site")
        tok = merged_token(id_to_word[sa], id_to_word[sb], prefix)
        new_id = word_to_id.setdefault(tok, len(id_to_word))
        if new_id == len(id_to_word):
            id_to_word.append(tok)
        merges.append(((sa, sb), new_id))
        pbar.inc(1)
        merge_deltas(C, ctx, wcnt, sa, sb, new_id, max_len, n_sites, site_cap, group)
        packed += n_sites <= site_cap
        words = torch.where(ctx.site, new_id, words)
        words = torch.where(ctx.kill, -1, words)
        lens = torch.where(ctx.site, ctx.new_len, lens)
        lens = torch.where(ctx.kill, 0, lens)
        best, a, b = _select(C, v_pad)
        ctx = merge_sites(words, lens, wid, a, b, k_steps)
    pbar.finish()
    stats.update(host_reads=reads, packed_rounds=packed)
    return merges


def train_dense(cfg, word_to_id, id_to_word, words, counts, device, stats=None, shard=None):
    """Run the dense loop on `device`; returns [((a, b), new_id)] and
    extends word_to_id/id_to_word, or None (nothing changed) when the
    configuration is out of this path's envelope (v_cap over
    DENSE_VCAP_MAX, or a word too long for NCOL_MAX) and the caller takes
    the per-round path.

    `words`/`counts` are `cfg._tokenize_words`' output; `word_to_id`/
    `id_to_word` already hold the special tokens and the alphabet.
    `shard`: (group, rank, ranks) of a mesh; this rank merges its block
    of the packed rows."""
    stats = {} if stats is None else stats
    device = torch.device(device)
    group, rank, ranks = shard if shard is not None else (None, 0, 1)
    v_cap = max(cfg.vocab_size, len(id_to_word)) + 1
    if v_cap > DENSE_VCAP_MAX:
        return None
    maxw = max((len(w) for w, _ in words), default=1)
    ncol = 512
    while ncol < maxw:
        ncol <<= 1
    if ncol > NCOL_MAX:
        return None
    v_pad = -(-v_cap // 128) * 128

    t = time.perf_counter()
    ids, wid, wcnt = (torch.from_numpy(x).to(device)
                      for x in pack_corpus(words, counts, ncol, ranks))
    C = initial_pair_matrix(ids, wid, wcnt, v_cap, v_pad)
    if group is not None:
        per = ids.shape[0] // ranks
        ids, wid, wcnt = (x[rank * per:(rank + 1) * per] for x in (ids, wid, wcnt))
    max_len = cfg.max_token_length if cfg.max_token_length is not None else 1 << 30
    merge_cap = max(1, cfg.vocab_size - len(id_to_word) + 8)
    # the packed delta branch takes the rounds of up to site_cap sites; the
    # few most frequent merges take the full-width branch
    site_cap = min(SITE_CAP, ids.numel())
    k_steps = reach(maxw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_loop = time.perf_counter()
    merges = dense_loop(ids, wid, wcnt, C, cfg, word_to_id, id_to_word,
                        min(max_len, 1 << 30), merge_cap, site_cap, k_steps, stats, group)
    stats.update(path="dense", pack_s=t_loop - t, loop_s=time.perf_counter() - t_loop,
                 merges=len(merges), shape=list(ids.shape), v_cap=v_cap, v_pad=v_pad,
                 k_steps=k_steps, site_cap=site_cap)
    return merges
