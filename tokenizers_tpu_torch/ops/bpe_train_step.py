"""One BPE training round over a pair registry; port of
`tokenizers_tpu.ops.bpe_train_step`.  Over a process group each rank
runs the round on its block of the words and the round's counts (the
registry deltas, the two dense vectors of the new token's pairs, the
sites) are summed over the group, the JAX package's `psum`s: integer
sums, so every rank holds the same registry.

The unique words are an `int32[W, K]` tensor, one row per word, -1 a dead
symbol.  A round:

  1. **Selection** (`select`): the registry's max count, ties by pair
     (a, b) ascending (`trainer.rs:30-39`).
  2. **Merge application** (`round_step`): the occurrences of the pair
     by fills, left-most first within `aaa` chains (`Word::merge`,
     `word.rs:107-160`).  The fills reach 2^k_steps positions, which the
     caller takes from the row width (a token's symbols are that far
     from the next live one; the JAX package's fixed 9 loses the pairs
     of tokens over 512 symbols).  A selected pair with no site raises.
  3. **Exact count deltas**, as the reference's left-to-right pass: left
     neighbours post-merge, right ones pre-merge.  Per site, with c the
     word's count:
       own pair (a, b): -c                      [registry slot from the host]
       right adjacency (b, y) dies: -c          [registry lookup]
       new right pair (new, y): +c              [dense, gated by length]
       left adjacency (x, a) dies: -c           [lookup, or dense if x = new]
       new left pair (x, new): +c               [dense, gated]
     The sites are gathered at their exact count (`nonzero`), so the
     lookups and delta scatters run on the sites only; the JAX package
     packs them into a capacity it grows and recompiles for.  The lengths
     that gate `max_token_length` are each symbol's chars at its position
     (`lens`, the reference's `Symbol::len`), where the JAX package keeps
     one per id: with a continuing-subword prefix one id can cover
     different chars ('#' + strip('##') = '#').

The registry lives on the device as `reg_a`, `reg_b` and `count` (length
p_cap + 1: the last slot takes the deltas of masked sites and is never
live) and `slot_rows [H, 4]` = (a, b, registry index, 0), linear probing
of at most MAXPROBE slots (the JAX package's 8 raise at full size; see
MAXPROBE); the host keeps its index (`PairRegistry`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .bpe_merge2 import _seg_count, at, neighbour_index
from .merge_table import mul32

# linear probing: the JAX package probes at most 8 slots, and its inserts
# raise "probe length exceeded" at the SentencePiece BPE recipe's 285,425
# pairs; 32 keep that improbable at the registry's load of at most 1/4.
# An insert lands where the JAX package's does whenever that one succeeds.
MAXPROBE = 32
INT_MIN = -0x80000000
INT_MAX = 0x7FFFFFFF
M32 = 0xFFFFFFFF
_K1, _K2, _K3 = 0x9E3779B1, 0x85EBCA77, 0x7FEB352D


def _hash_pair(a: torch.Tensor, b: torch.Tensor, mask: int) -> torch.Tensor:
    """int32 slot hash of pairs (a, b), as uint32 arithmetic in int64."""
    a = a.to(torch.int64) & M32
    b = b.to(torch.int64) & M32
    h = (mul32(a, _K1) + mul32(b, _K2)) & M32
    h = h ^ (h >> 16)
    h = mul32(h, _K3)
    h = h ^ (h >> 15)
    return (h & mask).to(torch.int32)


def hash_pair_int(a: int, b: int, mask: int) -> int:
    """`_hash_pair` of one pair, in Python ints (the host's inserts)."""
    h = ((a & M32) * _K1 + (b & M32) * _K2) & M32
    h ^= h >> 16
    h = (h * _K3) & M32
    h ^= h >> 15
    return h & mask


class PairRegistry:
    """Host registry of distinct pairs and the device lookup hash.

    reg_a/reg_b/count: int32[p_cap] (the first `n` live).  slot_rows:
    int32[H, 4] = (key_a, key_b, registry_index, 0), linear probing with
    probe length <= MAXPROBE enforced at insert (H = 4x capacity)."""

    def __init__(self, pairs: Dict[Tuple[int, int], int], p_cap: int):
        self.p_cap = p_cap
        self.n = 0
        self.reg_a = np.full(p_cap, -1, np.int32)
        self.reg_b = np.full(p_cap, -1, np.int32)
        self.count = np.zeros(p_cap, np.int32)
        self.H = 1
        while self.H < 4 * max(16, p_cap):
            self.H <<= 1
        self.slot_rows = np.full((self.H, 4), -1, np.int32)
        self.index: Dict[Tuple[int, int], int] = {}
        for (a, b), c in pairs.items():
            self.insert(a, b, c)

    def insert(self, a: int, b: int, c: int, touched=None) -> int:
        idx = self.n
        if idx >= self.p_cap:
            raise RuntimeError("registry capacity exceeded")
        self.reg_a[idx] = a
        self.reg_b[idx] = b
        self.count[idx] = c
        self.index[(a, b)] = idx
        mask = self.H - 1
        h = hash_pair_int(a, b, mask)
        rows = self.slot_rows
        for probe in range(MAXPROBE):
            s = (h + probe) & mask
            if rows[s, 2] < 0:
                rows[s] = (a, b, idx, 0)
                if touched is not None:
                    touched.append(s)
                break
        else:
            raise RuntimeError("probe length exceeded; resize the registry")
        self.n += 1
        return idx


def _lookup_rows(slot_rows: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Device linear-probe lookup: registry index of (a, b), -1 if absent;
    every probe of a pair in one gather."""
    mask = slot_rows.shape[0] - 1
    h = _hash_pair(a, b, mask).to(torch.int64)
    probes = torch.arange(MAXPROBE, dtype=torch.int64, device=a.device)
    rows = slot_rows[(h[:, None] + probes) & mask]  # [n, MAXPROBE, 4]
    ok = (rows[..., 0] == a[:, None]) & (rows[..., 1] == b[:, None])
    first = ok.to(torch.int32).argmax(1, keepdim=True)
    return torch.where(ok.any(1), rows[..., 2].gather(1, first).squeeze(1), -1)


def select(reg_a: torch.Tensor, reg_b: torch.Tensor, count: torch.Tensor):
    """(best, a, b) as 0-d tensors: the max live count, then min a, min b."""
    live = reg_a >= 0
    c = torch.where(live, count, INT_MIN)
    best = c.max()
    cand = live & (c == best)
    a_min = torch.where(cand, reg_a, INT_MAX).min()
    cand2 = cand & (reg_a == a_min)
    b_min = torch.where(cand2, reg_b, INT_MAX).min()
    return best, a_min, b_min


def round_step(words, lens, wcount, count, slot_rows, sel_a: int, sel_b: int,
               sel_idx: int, new_id: int, max_len: int, k_steps: int, v_cap: int,
               group=None):
    """Merge (sel_a, sel_b) -> new_id in every row of `words` [W, K] (each
    symbol's length in chars in `lens`) and return (words', lens', dl,
    dr): `count` (length p_cap + 1) updated in place, dl[x] / dr[y] the
    count deltas of the new pairs (x, new) / (new, y), int32[v_cap] each.
    `k_steps`: the fills' reach, 2^k_steps >= K.  With a process `group`
    `words` is this rank's block (it may hold no site, or no row), and
    the count deltas, dl, dr and the number of sites are summed over the
    group before `count` takes them."""
    K = words.shape[1]
    dev = words.device
    p_cap = count.shape[0] - 1
    alive = words >= 0
    jn, fn, jp, fp = neighbour_index(alive, k_steps)
    nid, nlen = at(words, jn, fn), at(lens, jn, fn)
    is_pair = alive & fn & (words == sel_a) & (nid == sel_b)
    cnt = _seg_count(is_pair, alive & ~is_pair)
    site = is_pair & (cnt % 2 == 1) if sel_a == sel_b else is_pair

    # neighbour context by fills: y = the symbol after the absorbed one
    y = at(torch.where(fn, nid, -1), jn, fn)
    r_ok = site & at(fn, jn, fn) & (y >= 0)
    p_id, p_site = at(words, jp, fp), at(site, jp, fp)
    pp_id = at(torch.where(fp, p_id, -1), jp, fp)
    # the previous symbol dies this round iff ITS left neighbour is a site;
    # the left neighbour is then that site, merged
    pv_killed = fp & at(fp, jp, fp) & at(p_site, jp, fp)
    l_exists = site & fp
    x_pre = torch.where(pv_killed, pp_id, p_id)
    lp_site = pv_killed | p_site
    # lengths: the new token at each site, y, and x post-merge
    new_len = lens + nlen
    p_len = at(lens, jp, fp)
    x_len = torch.where(pv_killed, at(p_len, jp, fp) + p_len, p_len)

    # ---- the sites, gathered at their exact count
    pos = site.reshape(-1).nonzero().squeeze(1)
    if pos.numel() == 0 and group is None:
        raise RuntimeError(f"pair ({sel_a}, {sel_b}) was selected but has no site")
    s_y = y.reshape(-1)[pos]
    s_rok = r_ok.reshape(-1)[pos]
    s_x = x_pre.reshape(-1)[pos]
    s_lex = l_exists.reshape(-1)[pos]
    s_lps = lp_site.reshape(-1)[pos]
    s_nl = new_len.reshape(-1)[pos]
    s_yl = at(nlen, jn, fn).reshape(-1)[pos]
    s_xl = x_len.reshape(-1)[pos]
    s_c = wcount[pos // K]

    # ---- deltas: registry slots (own pair, the dying adjacencies) and the
    # two dense vectors of the new token's pairs
    local = count if group is None else torch.zeros_like(count)
    local[sel_idx] -= s_c.sum().to(torch.int32)
    # the dying adjacencies (sel_b, y) and (x, sel_a), looked up together
    n = s_y.shape[0]
    found = _lookup_rows(slot_rows, torch.cat([torch.full_like(s_y, sel_b), s_x]),
                         torch.cat([s_y, torch.full_like(s_x, sel_a)]))
    ridx, lidx = found[:n], found[n:]
    l_plain = s_lex & ~s_lps
    idx = torch.cat([torch.where(s_rok, ridx, p_cap), torch.where(l_plain, lidx, p_cap)])
    idx = torch.where(idx < 0, p_cap, idx).to(torch.int64)  # absent: the dump slot
    local.index_add_(0, idx, torch.cat([torch.where(s_rok, -s_c, 0),
                                        torch.where(l_plain, -s_c, 0)]))

    r_add = s_rok & ((s_yl + s_nl) < max_len)
    l_add = s_lex & ((s_xl + s_nl) < max_len)
    la_plain = l_add & ~s_lps
    l_new = s_lex & s_lps
    la_new = l_add & s_lps  # (new, new) goes through dr
    dense = torch.zeros(2 * (v_cap + 1), dtype=torch.int32, device=dev)  # dl | dr
    r0 = v_cap + 1
    didx = torch.cat([torch.where(la_plain, s_x, v_cap),
                      r0 + torch.where(r_add, s_y, v_cap),
                      r0 + torch.where(l_new, sel_a, v_cap),
                      r0 + torch.where(la_new, new_id, v_cap)]).to(torch.int64)
    dense.index_add_(0, didx, torch.cat([torch.where(la_plain, s_c, 0),
                                         torch.where(r_add, s_c, 0),
                                         torch.where(l_new, -s_c, 0),
                                         torch.where(la_new, s_c, 0)]))

    if group is not None:
        from ..parallel.runtime import all_sum

        red = all_sum(torch.cat([local, dense, pos.new_tensor([pos.numel()]).to(torch.int32)]),
                      group)
        if int(red[-1]) == 0:
            raise RuntimeError(f"pair ({sel_a}, {sel_b}) was selected but has no site")
        count += red[:count.shape[0]]
        dense = red[count.shape[0]:-1]

    # ---- apply the merge
    kill = alive & fp & p_site
    words = torch.where(site, new_id, words)
    words = torch.where(kill, -1, words)
    lens = torch.where(site, new_len, lens)
    lens = torch.where(kill, 0, lens)
    return words, lens, dense[:v_cap], dense[r0:r0 + v_cap]
