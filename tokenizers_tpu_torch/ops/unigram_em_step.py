"""The Unigram trainer's E-step and pruning statistics on the card: lattice
forward-backward marginals and Viterbi frequencies over packed sentence
bytes; port of `tokenizers_tpu.ops.unigram_em_step` (the JAX package runs
them as plain-XLA `lax.scan` programs, with no Pallas kernel, and so this
port runs them as torch ops).

They replace the two per-sentence host loops of the reference trainer
(`models/unigram/trainer.rs:451-491` `run_e_step`, `:320-357` the
Viterbi frequencies of `prune_sentence_pieces`) with one program per
chunk of sentences, uint8[S, L]:

* node grid (`_piece_nodes`): every (char start, piece byte length) pair
  is looked up in a 2-way cuckoo table of the pieces by its two rolling
  hashes (`PieceTable`), plus the reference's unk node where no piece
  of exactly the char's byte length matches (`model.rs:160-199`);
* forward and backward: a loop over byte boundaries, folding the
  candidates in the host lattice's node order (end nodes: length
  decreasing; begin nodes: length increasing) with the reference's
  `log_sum_exp` (`_lse_host`: the first node initialises, a gap over
  50.0 keeps the larger alone);
* marginals: freq * exp(alpha + score + beta - Z), summed per piece id;
* Viterbi: the same forward loop with the first-writer strictly-greater
  rule (`lattice.rs:176`), carrying the token count (for the E-step's
  ntokens) or the chosen (length, id) per boundary, whose path a pointer
  chase from each sentence's end recovers (the pruning frequencies).

Scores are float64, as the JAX package runs them under `enable_x64`:
`exp` and `log` differ from the host's libm by ULPs, so expected counts
and log Z equal the host lattice's to about 1e-12 relative; token counts
and frequencies (sums of integer counts) are exact.  The per-piece sums
are a stable sort by id and a segmented sum in that order
(`segment_sum`), never an atomic scatter: two runs of one model give
bit-equal vectors.  The two loops skip, exactly, the (boundary, length)
steps where no sentence of the chunk has a node (a no-op step): the
chunk's node mask is read once a program.

`DeviceEm` packs the sentences once, in JAX's buckets (`_bucket_len`,
`_ELEM_BUDGET` f64 elements a chunk), and keeps them and the expected
count vector on the card across chunks; an E-step reads its result once.
Sentences over `L_MAX` bytes take the host lattice, as do whole passes
whose pieces build no table (`PieceTable.build` returns None): JAX's two
host routes.

Over a mesh (`DeviceEm(sentences, mesh=...)`, a `DeviceMesh` of the
process group) the chunks take JAX's mesh geometry (a multiple of the
ranks in each, `S` padded to one) and each rank runs its contiguous block
of every chunk; the per-piece vectors are folded in rank order
(`runtime.fold_f64`: gathered, rank 0 first, so every rank holds the same
bits; the JAX package `psum`s them) and z, the token counts and the
chunk's rows are gathered.  The fold's order differs from the unsharded
sum's, so expected counts differ from it by ULPs; frequencies and token
counts (sums of integers) are exact.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .bpe_dedup import H1_MULT, H2_MULT, _M32, _powers, _to_i32
from .merge_table import CuckooMergeTable, _hash, hash_pair, mul32
from .wordpiece_encode import _prefix_hash, decode_chars

NEG = -1e30
_ELEM_BUDGET = 1 << 23  # f64 elements per [S, L] x 16 chunk (JAX's budget)
L_MAX = 512  # sentences longer than this take the host lattice


# --------------------------------------------------------------------------
# piece table (host-built per EM iteration)
# --------------------------------------------------------------------------


class PieceTable:
    """Cuckoo table of the current pieces: (h1, h2) -> (byte_len, id) with
    slot-aligned f64 scores.  `build` returns None for a piece over
    `max_byte_len` bytes or on a true 64-bit hash collision between two
    distinct piece strings (the host lattice takes the pass then)."""

    def __init__(self, vtab: CuckooMergeTable, scores: np.ndarray, max_len: int,
                 n_pieces: int):
        self.vtab = vtab
        self.scores = scores
        self.max_len = max_len
        self.n_pieces = n_pieces

    @staticmethod
    def build(pieces: List[Tuple[str, float]], max_byte_len: int = 64) -> Optional["PieceTable"]:
        enc = [p.encode("utf-8") for p, _ in pieces]
        max_len = max((len(b) for b in enc), default=1)
        if max_len > max_byte_len:
            return None
        n = len(pieces)
        mat = np.zeros((n, max_len), np.uint32)
        lens = np.zeros(n, np.int64)
        for i, bs in enumerate(enc):
            lens[i] = len(bs)
            mat[i, : len(bs)] = np.frombuffer(bs, np.uint8)
        h1 = np.zeros(n, np.uint32)
        h2 = np.zeros(n, np.uint32)
        with np.errstate(over="ignore"):
            for j in range(max_len):
                live = j < lens
                h1 = np.where(live, h1 * np.uint32(H1_MULT) + mat[:, j] + 1, h1)
                h2 = np.where(live, h2 * np.uint32(H2_MULT) + mat[:, j] + 1, h2)
        k1 = h1.astype(np.int32).tolist()
        k2 = h2.astype(np.int32).tolist()

        entries = {}
        key_bytes = {}
        for i, (bs, (_p, score)) in enumerate(zip(enc, pieces)):
            if not bs:
                continue
            key = (k1[i], k2[i])
            if key in entries and key_bytes[key] != bs:
                return None  # true collision: the table cannot tell them apart
            # a duplicate string keeps its LAST occurrence (the host dict does too)
            entries[key] = (len(bs), i, float(score))
            key_bytes[key] = bs

        vtab = CuckooMergeTable({k: (l, i) for k, (l, i, _s) in entries.items()})
        scores = np.zeros((2, vtab.size), np.float64)
        if entries:
            ka = np.array([k[0] for k in entries], np.int64)
            kb = np.array([k[1] for k in entries], np.int64)
            sc = np.array([e[2] for e in entries.values()], np.float64)
            for t in (0, 1):  # each key sits in one of its two slots
                h = _hash(ka, kb, vtab.seed, vtab.size - 1, t)
                there = (vtab.key_a[t][h] == ka) & (vtab.key_b[t][h] == kb)
                scores[t][h[there]] = sc[there]
        # K rounded up so that a shrinking vocab keeps the same shapes
        k_pad = -(-max_len // 4) * 4
        return PieceTable(vtab, scores, k_pad, n)

    def device_args(self, device) -> dict:
        """The table on `device`, in one upload: keys, lengths, ids and the
        scores' bits as int64 [6, 2, size]."""
        vt = self.vtab
        packed = np.stack([vt.key_a, vt.key_b, vt.rank, vt.new_id]).astype(np.int64)
        packed = np.concatenate([packed, self.scores.view(np.int64)[None]])
        t = torch.from_numpy(packed).to(device)
        return dict(
            vkey_a=t[0].to(torch.int32), vkey_b=t[1].to(torch.int32),
            vlen=t[2].to(torch.int32), vid=t[3].to(torch.int32),
            vscore=t[4].view(torch.float64), vseed=int(vt.seed),
            pow1=_powers(H1_MULT, self.max_len + 1).tolist(),
            pow2=_powers(H2_MULT, self.max_len + 1).tolist(),
        )


# --------------------------------------------------------------------------
# node grid
# --------------------------------------------------------------------------


def _piece_nodes(b, inb, lengths, vkey_a, vkey_b, vlen, vid, vscore, vseed, pow1, pow2,
                 unk_id, unk_score, max_len):
    """-> (cost f64[S, L, K], pid int32[S, L, K]): the lattice node grid.
    Entry (s, p, l-1) is the piece beginning at byte p with byte length l
    (pid -1: no node).  As `populate_nodes`: vocab hits at char starts,
    plus an unk node of exactly the char's byte length where no vocab
    piece of that length matches."""
    S, L = b.shape
    dev = b.device
    pos = torch.arange(L, device=dev).expand(S, L)
    _, is_start, charlen = decode_chars(b, inb)
    E1 = _prefix_hash(b, H1_MULT, max_len)
    E2 = _prefix_hash(b, H2_MULT, max_len)
    E1b, E2b = E1[:, :L], E2[:, :L]
    vmask = vkey_a.shape[1] - 1
    s_ok = inb & is_start
    cost = torch.empty((S, L, max_len), dtype=torch.float64, device=dev)
    pid = torch.empty((S, L, max_len), dtype=torch.int32, device=dev)
    for l in range(1, max_len + 1):
        valid = s_ok & (pos + l <= lengths[:, None])
        h1 = _to_i32((E1[:, l:l + L] - mul32(E1b, pow1[l])) & _M32)
        h2 = _to_i32((E2[:, l:l + L] - mul32(E2b, pow2[l])) & _M32)
        g0 = hash_pair(h1, h2, vseed, vmask, 0).long()
        g1 = hash_pair(h1, h2, vseed, vmask, 1).long()
        hit0 = (vkey_a[0][g0] == h1) & (vkey_b[0][g0] == h2)
        hit1 = (vkey_a[1][g1] == h1) & (vkey_b[1][g1] == h2)
        stored_l = torch.where(hit0, vlen[0][g0], vlen[1][g1])
        hit = valid & (hit0 | hit1) & (stored_l == l)
        cost[..., l - 1] = torch.where(hit, torch.where(hit0, vscore[0][g0], vscore[1][g1]), NEG)
        pid[..., l - 1] = torch.where(hit, torch.where(hit0, vid[0][g0], vid[1][g1]), -1)

    lidx = torch.arange(1, max_len + 1, device=dev, dtype=torch.int32)
    single = lidx == charlen[..., None]
    has_single = (single & (pid >= 0)).any(-1)
    unk_ok = s_ok & ~has_single & ((pos + charlen) <= lengths[:, None])
    unk_sel = unk_ok[..., None] & single
    cost = torch.where(unk_sel, float(unk_score), cost)
    pid = torch.where(unk_sel, int(unk_id), pid)
    return cost, pid


def _ends_grid(cost, pid, max_len):
    """The node grid keyed by END boundary: entry (s, p-1, l-1) is the node
    ending at boundary p with length l (the begin grid shifted right by
    l-1; a node cannot begin before byte 0, the -1 fill sees to it)."""
    L = cost.shape[1]
    ce = torch.full_like(cost, NEG)
    pe = torch.full_like(pid, -1)
    for l in range(1, min(max_len, L) + 1):
        ce[:, l - 1:, l - 1] = cost[:, : L - (l - 1), l - 1]
        pe[:, l - 1:, l - 1] = pid[:, : L - (l - 1), l - 1]
    return ce, pe


def _lse_host(x, y):
    """The reference's `log_sum_exp` (non-init branch, `lattice.rs:123`):
    vmax + log(exp(vmin - vmax) + 1), or vmax alone when
    vmax > vmin + 50.  With x = -inf it gives y exactly (the init)."""
    gt = x > y
    vmax = torch.where(gt, x, y)
    vmin = torch.where(gt, y, x)
    big = vmax > vmin + 50.0
    safe = torch.where(big, vmax, vmin)  # keeps exp finite in the dead lane
    return torch.where(big, vmax, vmax + torch.log(torch.exp(safe - vmax) + 1.0))


def segment_sum(ids, vals, n: int):
    """f64[n]: per id in [0, n) the sum of its `vals`, added in the order
    they come (a stable sort by id, then a sequential sum per segment);
    ids == n are dropped.  Deterministic on every device."""
    sid, perm = torch.sort(ids, stable=True)
    offsets = torch.searchsorted(sid, torch.arange(n + 1, device=ids.device, dtype=sid.dtype))
    return torch.segment_reduce(vals[perm], "sum", offsets=offsets, unsafe=True)


def _live_steps(pid):
    """bool numpy [L, K]: whether any sentence of the chunk has a node
    beginning at byte p with length l (one read)."""
    return (pid >= 0).any(0).cpu().numpy()


def _prepare(bytes_u8, lengths, table, unk_id, unk_score, max_len):
    S, L = bytes_u8.shape
    pos = torch.arange(L, device=bytes_u8.device).expand(S, L)
    inb = pos < lengths[:, None]
    b = torch.where(inb, bytes_u8.to(torch.int32), 0)
    return _piece_nodes(b, inb, lengths, **table, unk_id=unk_id, unk_score=unk_score,
                        max_len=max_len)


def _forward(cost, pid, live, viterbi_only: bool):
    """The forward loop over boundaries 1..L.  Each step folds the nodes
    ending there in length-decreasing order.  -> (alpha f64[S, L+1],
    cnt int32[S, L+1]) for the E-step (alpha: the reference's fold, 0.0
    where no node ends; cnt: the Viterbi path's token count), or
    (jlen, jpid) int32[S, L+1] for the pruning pass (the Viterbi node
    ending at each boundary)."""
    S, L, K = cost.shape
    dev = cost.device
    ce, pe = _ends_grid(cost, pid, K)
    ex = pe >= 0
    vit = torch.full((S, L + 1), NEG, dtype=torch.float64, device=dev)
    vit[:, 0] = 0.0
    if viterbi_only:
        jlen = torch.zeros((S, L + 1), dtype=torch.int32, device=dev)
        jpid = torch.full((S, L + 1), -1, dtype=torch.int32, device=dev)
    else:
        alpha = torch.zeros((S, L + 1), dtype=torch.float64, device=dev)
        cnt = torch.zeros((S, L + 1), dtype=torch.int32, device=dev)
    neg_inf = torch.full((S,), -torch.inf, dtype=torch.float64, device=dev)
    for p in range(1, L + 1):
        ls = [l for l in range(min(K, p), 0, -1) if live[p - l, l - 1]]
        if not ls:
            continue  # no node ends here in any sentence: the defaults stand
        vbest = neg_inf
        if viterbi_only:
            vlen = torch.zeros((S,), dtype=torch.int32, device=dev)
            vpid = torch.full((S,), -1, dtype=torch.int32, device=dev)
        else:
            acc = neg_inf
            vcnt = torch.zeros((S,), dtype=torch.int32, device=dev)
        for l in ls:
            e = ex[:, p - 1, l - 1]
            sc = ce[:, p - 1, l - 1]
            vv = vit[:, p - l] + sc
            take = e & (vv > vbest)  # first writer, strictly greater
            vbest = torch.where(take, vv, vbest)
            if viterbi_only:
                vlen = torch.where(take, l, vlen)
                vpid = torch.where(take, pe[:, p - 1, l - 1], vpid)
            else:
                acc = torch.where(e, _lse_host(acc, alpha[:, p - l] + sc), acc)
                vcnt = torch.where(take, cnt[:, p - l] + 1, vcnt)
        found = vbest != -torch.inf
        vit[:, p] = torch.where(found, vbest, NEG)
        if viterbi_only:
            jlen[:, p] = vlen
            jpid[:, p] = vpid
        else:
            alpha[:, p] = torch.where(found, acc, 0.0)
            cnt[:, p] = vcnt
    return (jlen, jpid) if viterbi_only else (alpha, cnt)


def _backward(cost, pid, live):
    """beta f64[S, L + 1 + K]: at each begin boundary p the fold of its
    nodes in length-increasing order of score + beta[p + l] (0.0 where no
    node begins; zeros beyond L)."""
    S, L, K = cost.shape
    dev = cost.device
    beta = torch.zeros((S, L + 1 + K), dtype=torch.float64, device=dev)
    ex = pid >= 0
    neg_inf = torch.full((S,), -torch.inf, dtype=torch.float64, device=dev)
    for p in range(L - 1, -1, -1):
        ls = [l for l in range(1, min(K, L - p) + 1) if live[p, l - 1]]
        if not ls:
            continue
        acc = neg_inf
        for l in ls:
            acc = torch.where(ex[:, p, l - 1],
                              _lse_host(acc, cost[:, p, l - 1] + beta[:, p + l]), acc)
        beta[:, p] = torch.where(acc != -torch.inf, acc, 0.0)
    return beta


# --------------------------------------------------------------------------
# programs
# --------------------------------------------------------------------------


def em_marginal_program(bytes_u8, lengths, freqs, table, unk_id, unk_score, max_len,
                        n_pieces):
    """-> (expected f64[n_pieces], z f64[S] = freq * log Z, ntok int32[S]):
    one E-step chunk, forward-backward marginals and Viterbi token counts
    (reference `run_e_step`, `trainer.rs:451-491`).  `table`:
    `PieceTable.device_args`."""
    S, L = bytes_u8.shape
    K = max_len
    cost, pid = _prepare(bytes_u8, lengths, table, unk_id, unk_score, max_len)
    live = _live_steps(pid)
    alpha, cnt = _forward(cost, pid, live, viterbi_only=False)
    li = lengths.long()[:, None]
    z_at = alpha.gather(1, li)[:, 0]
    ntok = cnt.gather(1, li)[:, 0]
    on = lengths > 0
    z = torch.where(on, freqs * z_at, 0.0)
    ntok = torch.where(on, ntok, 0)

    beta = _backward(cost, pid, live)
    exists = pid >= 0
    a_at = alpha[:, :L]
    contrib = torch.empty_like(cost)
    for l in range(1, K + 1):
        total = a_at + cost[..., l - 1] + beta[:, l:l + L] - z_at[:, None]
        e = exists[..., l - 1]
        contrib[..., l - 1] = torch.where(e, freqs[:, None] * torch.exp(torch.where(e, total, NEG)),
                                          0.0)
    ids = torch.where(exists, pid, n_pieces).reshape(-1).long()
    expected = segment_sum(ids, contrib.reshape(-1), n_pieces)
    return expected, z, ntok


def viterbi_freq_program(bytes_u8, lengths, freqs, table, unk_id, unk_score, max_len,
                         n_pieces, max_length: Optional[int] = None):
    """-> freq f64[n_pieces]: each sentence's Viterbi path pieces credited
    with its count, the pruning statistics of `prune_sentence_pieces`
    (`trainer.rs:320-357`).  The path is chased from each sentence's end
    (`max_length` steps at most: the chunk's longest sentence)."""
    S, L = bytes_u8.shape
    cost, pid = _prepare(bytes_u8, lengths, table, unk_id, unk_score, max_len)
    jlen, jpid = _forward(cost, pid, _live_steps(pid), viterbi_only=True)
    q = lengths.long()[:, None]
    steps = L if max_length is None else max_length
    tok_pid = torch.full((S, max(steps, 1)), n_pieces, dtype=torch.int64, device=q.device)
    for i in range(steps):
        jl = jlen.gather(1, q)
        tok_pid[:, i] = torch.where(jl[:, 0] > 0, jpid.gather(1, q)[:, 0].long(), n_pieces)
        q = q - jl.long()
    w = freqs[:, None].expand_as(tok_pid)
    return segment_sum(tok_pid.reshape(-1), w.reshape(-1), n_pieces)


# --------------------------------------------------------------------------
# the chunk loop (bucketed)
# --------------------------------------------------------------------------


def _bucket_len(n: int) -> int:
    L = 8
    while L < n:
        L <<= 1
    return L


class DeviceEm:
    """Packs the training sentences once, on `device`; per model, builds a
    piece table and runs the chunked E-step or Viterbi-frequency program.
    `stats` counts what took the host: `host_sentences` (over L_MAX
    bytes) and `no_table_passes`."""

    def __init__(self, sentences: List[Tuple[str, int]], device=None, mesh=None):
        from .. import pick_device

        self.device = pick_device(device)
        self.sentences = sentences
        self.group, self.rank, n_dev = None, 0, 1
        if mesh is not None:
            from ..parallel.runtime import mesh_group

            self.group, self.rank, n_dev = mesh_group(mesh)
        self.n_dev = n_dev
        buckets = {}
        self.host_idx: List[int] = []
        for i, (s, _n) in enumerate(sentences):
            bs = s.encode("utf-8")
            if not bs:
                continue
            if len(bs) > L_MAX:
                self.host_idx.append(i)
                continue
            buckets.setdefault(_bucket_len(len(bs)), []).append(i)
        # (this rank's bytes u8[S / n_dev, L], lengths i32, freqs f64, the
        # chunk's sentence indices i64[len(part)], its longest sentence)
        self.chunks = []
        for L, idxs in sorted(buckets.items()):
            # JAX's geometry: a multiple of the ranks (one rank: JAX's too)
            s_cap = max(n_dev, _ELEM_BUDGET // (L * 16))
            s_cap -= s_cap % n_dev
            for lo in range(0, len(idxs), s_cap):
                part = idxs[lo : lo + s_cap]
                S = -(-len(part) // n_dev) * n_dev
                buf = np.zeros((S, L), np.uint8)
                lens = np.zeros(S, np.int32)
                fr = np.zeros(S, np.float64)
                for k, i in enumerate(part):
                    bs = sentences[i][0].encode("utf-8")
                    buf[k, : len(bs)] = np.frombuffer(bs, np.uint8)
                    lens[k] = len(bs)
                    fr[k] = float(sentences[i][1])
                r0, r1 = self.rank * (S // n_dev), (self.rank + 1) * (S // n_dev)
                dev = self.device
                self.chunks.append((torch.from_numpy(buf[r0:r1]).to(dev),
                                    torch.from_numpy(lens[r0:r1]).to(dev),
                                    torch.from_numpy(fr[r0:r1]).to(dev),
                                    torch.tensor(part, dtype=torch.int64, device=dev),
                                    int(lens.max())))
        self.stats = {"host_sentences": len(self.host_idx), "no_table_passes": 0,
                      "chunks": [[c[0].shape[0] * n_dev, c[0].shape[1]] for c in self.chunks]}

    def _reduce(self, vec, *rows):
        """A chunk's per-piece vector folded over the group in rank order,
        and its per-sentence outputs gathered in rank order."""
        from ..parallel.runtime import fold_f64, gather_cat

        return (fold_f64(vec, self.group),) + tuple(gather_cat(r, self.group) for r in rows)

    def _table(self, model):
        pt = PieceTable.build(model.pieces)
        if pt is None:
            self.stats["no_table_passes"] += 1
        return pt

    def _args(self, model, pt):
        return dict(table=pt.device_args(self.device),
                    unk_id=model.unk_id if model.unk_id is not None else 0,
                    unk_score=float(np.float64(model.min_score) - 10.0), max_len=pt.max_len,
                    n_pieces=len(model.pieces))

    def _host_lattice(self, model, i):
        from ..models.unigram_lattice import Lattice

        s, n = self.sentences[i]
        lat = Lattice(s, model.bos_id, model.eos_id)
        model.populate_nodes(lat)
        return lat, float(n)

    def e_step(self, model):
        """-> (expected f64[V], z f64[n sentences], ntok total) as numpy, or
        None when no device table builds.  One read of the card's result;
        sentences over L_MAX bytes are folded in with host lattices."""
        pt = self._table(model)
        if pt is None:
            return None
        kw = self._args(model, pt)
        V, n = len(model.pieces), len(self.sentences)
        expected = torch.zeros(V, dtype=torch.float64, device=self.device)
        z = torch.zeros(n, dtype=torch.float64, device=self.device)
        ntok = torch.zeros(n, dtype=torch.float64, device=self.device)
        for buf, lens, fr, idx, _longest in self.chunks:
            v, zc, nc = em_marginal_program(buf, lens, fr, **kw)
            if self.group is not None:
                v, zc, nc = self._reduce(v, zc, nc)
            expected += v
            z[idx] = zc[:idx.numel()]
            ntok[idx] = nc[:idx.numel()].to(torch.float64)
        out = torch.cat([expected, z, ntok]).cpu().numpy()
        expected, z, ntok = out[:V].copy(), out[V:V + n].copy(), out[V + n:].astype(np.int64)
        if self.host_idx:
            exp_list = [0.0] * V
            for i in self.host_idx:
                lat, f = self._host_lattice(model, i)
                z[i] = lat.populate_marginal(f, exp_list)
                ntok[i] = len(lat.viterbi())
            expected = expected + np.asarray(exp_list)
        return expected, z, int(ntok.sum())

    def viterbi_freq(self, model):
        """-> freq f64[V] (numpy) or None: the pruning statistics."""
        pt = self._table(model)
        if pt is None:
            return None
        kw = self._args(model, pt)
        freq = torch.zeros(len(model.pieces), dtype=torch.float64, device=self.device)
        for buf, lens, fr, _idx, longest in self.chunks:
            f = viterbi_freq_program(buf, lens, fr, **kw, max_length=longest)
            freq += f if self.group is None else self._reduce(f)[0]
        freq = freq.cpu().numpy().copy()
        for i in self.host_idx:
            lat, f = self._host_lattice(model, i)
            for node in lat.viterbi():
                freq[node.id] += f
        return freq
