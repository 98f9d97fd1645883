"""BPE training on the device; port of `tokenizers_tpu.parallel.bpe_train`.

`train_device` trains as the JAX package's device trainers do, choosing
the program by size as it does:

* the dense whole-loop trainer (`ops/bpe_train_dense.py`) when
  v_cap = vocab + 1 <= DENSE_VCAP_MAX and the packed row width
  ncol <= 2^15;
* otherwise the per-round registry trainer (`train_per_round`): per merge
  one device selection over the pair registry, the host mints the token
  (real strings) and upserts the new pairs, and one device round
  (`ops/bpe_train_step.round_step`) applies the merge and its count
  deltas.  The round runs on the rows that hold both symbols of the pair,
  the only rows it can change.

Both give the vocab and merges of the host `BpeTrainer` (the reference
`tokenizers/src/models/bpe/trainer.rs`) unless a merge mints an id that
already exists and so adds to a pair already counted or merged.  The
reference's heap then holds two entries of that pair, each with its own
words, and merges it twice, in parts; the device trainers merge it once,
everywhere (`tests/test_torch_train.py::test_device_differs_only_where_the_host_repeats_a_merge`).

Both run on the trainer's device: the card unless the caller asks for
`device="cpu"`.  Over a mesh (`DistributedBpeTrainer(mesh=...)`, a
`DeviceMesh` of the process group, `parallel/runtime.py`) the words are
split over the ranks, each rank a contiguous block, and the counts each
rank's merge pass finds are summed over the group: the dense trainer
gathers every rank's (index, delta) list and adds them all on every rank,
the per-round trainer sums the round's deltas (`round_step(group=...)`).
Integer sums do not depend on order, so every rank selects the same pair,
mints the same token and grows its registry alike; at the end every
rank's merges are checked against rank 0's.  `stats` records the path, the seconds of the packing and
tables and of the device loop, the merges and the host reads (each
`.tolist()`, `nonzero` and `.cpu()` of the loop, counted where it is
made).
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import pick_device
from ..ops.bpe_train_dense import reach, train_dense
from ..ops.bpe_train_step import PairRegistry, round_step, select
from ..trainers.bpe_trainer import AddedToken, BpeTrainer, merged_token
from ..utils.log import get_logger


def train_device(cfg: BpeTrainer, word_counts: Dict[str, int], model,
                 mesh=None) -> List[AddedToken]:
    """Train `model` (a port `models.bpe.BPE`) on `word_counts` with the
    settings of `cfg`, on `pick_device(cfg.device)`, sharded over `mesh`
    when one is given."""
    device = pick_device(cfg.device)
    stats = cfg.stats
    shard = None
    if mesh is not None:
        from .runtime import mesh_group

        shard = mesh_group(mesh)
    t = time.perf_counter()
    word_to_id, id_to_word, words, counts = cfg.prepare(word_counts)
    stats.update(prepare_s=time.perf_counter() - t, device=str(device),
                 ranks=1 if shard is None else shard[2])

    merges = train_dense(cfg, word_to_id, id_to_word, words, counts, device, stats, shard)
    log = get_logger("trainer")
    if merges is None:
        log.debug("BPE training at vocab %d on %d words: the per-round trainer (past the "
                  "dense one's envelope)", cfg.vocab_size, len(words))
        merges = train_per_round(cfg, word_to_id, id_to_word, words, counts, device, stats,
                                 shard)
    else:
        log.debug("BPE training at vocab %d on %d words: the dense trainer",
                  cfg.vocab_size, len(words))
    if shard is not None:
        check_replicated(merges, shard[0], device)
    cfg.finalize_model(model, word_to_id, id_to_word, merges)
    return list(cfg.special_tokens)


def check_replicated(merges, group, device) -> None:
    """Raise unless every rank of `group` holds rank 0's merges (a digest
    of each rank's list, gathered)."""
    from .runtime import gather_equal

    h = hashlib.sha256(repr(merges).encode()).digest()[:8]
    mine = torch.tensor([int.from_bytes(h, "little", signed=True)], device=device)
    digests = [int(d) for d in gather_equal(mine, group)]
    if len(set(digests)) != 1:
        raise RuntimeError(f"sharded BPE training diverged across ranks: merge digests "
                           f"{digests}")


def initial_pairs(ids_np: np.ndarray, wc_np: np.ndarray, v_cap: int) -> Dict[Tuple[int, int], int]:
    """{(a, b): count} of the adjacent symbols of the [W, K] words, in
    (a, b) order."""
    K = ids_np.shape[1]
    a = ids_np[:, :-1].reshape(-1).astype(np.int64)
    b = ids_np[:, 1:].reshape(-1).astype(np.int64)
    wrep = np.repeat(wc_np, K - 1).astype(np.int64)
    ok = (a >= 0) & (b >= 0)
    keys = a[ok] * v_cap + b[ok]
    uniq, inv = np.unique(keys, return_inverse=True)
    csum = np.bincount(inv, weights=wrep[ok]).astype(np.int64)
    return {(int(k // v_cap), int(k % v_cap)): int(c) for k, c in zip(uniq, csum)}


def registry_size(n_pairs: int) -> int:
    """The registry's first capacity: the power of two at or above twice
    the initial pairs (at least 1,024); a full registry doubles."""
    p_cap = 1024
    while p_cap < 2 * n_pairs:
        p_cap <<= 1
    return p_cap


class DeviceRegistry:
    """The pair registry: its host index (`PairRegistry`) and its device
    arrays `reg_a`, `reg_b`, `count` (one extra slot at the end takes the
    deltas of masked sites and is never live) and `slot_rows`.

    The JAX package sizes the registry once for eight new pairs a merge,
    and raises "registry capacity exceeded" beyond: the SentencePiece BPE
    recipe at 30,000 makes 279,625 new pairs over 29,807 merges (9.4 a
    merge) against its 262,144.  Here a full registry doubles: its
    entries keep their indices, the slot table is rebuilt for the new
    capacity, and the merges are the same.  `reads` counts its reads of
    the device counts."""

    def __init__(self, pairs: Dict[Tuple[int, int], int], p_cap: int, device):
        self.device = device
        self.reg = PairRegistry(pairs, p_cap)
        self.touched: List[int] = []
        self.grown = self.reads = 0
        self._upload(self.reg.count)

    def _dev(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _upload(self, count):
        reg = self.reg
        self.reg_a = self._dev(np.append(reg.reg_a, np.int32(-1)))
        self.reg_b = self._dev(np.append(reg.reg_b, np.int32(-1)))
        self.count = self._dev(np.append(count, np.int32(0)))
        self.slot_rows = self._dev(reg.slot_rows)
        self.touched.clear()

    def _grow(self):
        old = self.reg
        count = np.zeros(2 * old.p_cap, np.int32)
        count[:old.n] = self.count[:old.n].cpu().numpy()
        self.reads += 1
        self.reg = PairRegistry({}, 2 * old.p_cap)
        for i in range(old.n):
            self.reg.insert(int(old.reg_a[i]), int(old.reg_b[i]), 0)
        self._upload(count)
        self.grown += 1

    def upsert(self, a: int, b: int, delta: int) -> Tuple[int, int, int, int]:
        """(index, a, b, delta) of pair (a, b), inserted when new.  A new
        token's pairs are usually new, but when the minted id is an
        existing token's the pair may exist."""
        idx = self.reg.index.get((a, b))
        if idx is None:
            if self.reg.n >= self.reg.p_cap:
                self._grow()
            idx = self.reg.insert(a, b, 0, touched=self.touched)
        return (idx, a, b, delta)

    def apply(self, upd: List[Tuple[int, int, int, int]]) -> None:
        """The updates of one round on the device: new pairs' keys, every
        pair's count delta, the slot rows written since the last call."""
        if upd:
            u = self._dev(np.array(upd, np.int32).T.copy())
            ui = u[0].to(torch.int64)
            self.reg_a[ui] = u[1]
            self.reg_b[ui] = u[2]
            self.count.index_add_(0, ui, u[3])
        if self.touched:
            us = np.array(self.touched, np.int64)
            self.slot_rows[self._dev(us)] = self._dev(self.reg.slot_rows[us])
            self.touched.clear()


def train_per_round(cfg: BpeTrainer, word_to_id: Dict[str, int], id_to_word: List[str],
                    words, counts, device, stats=None,
                    shard=None) -> List[Tuple[Tuple[int, int], int]]:
    """The per-round registry trainer; returns [((a, b), new_id)] and
    extends word_to_id/id_to_word with the minted tokens.  `words`/`counts`
    are `cfg._tokenize_words`' output, the maps hold the special tokens
    and the alphabet.  `shard`: (group, rank, ranks) of a mesh; the words
    are padded to Wp = ceil(W / ranks) * ranks rows and this rank merges
    its block of Wp / ranks, the round's counts summed over the group."""
    stats = {} if stats is None else stats
    t = time.perf_counter()
    device = torch.device(device)
    group, rank, ranks = shard if shard is not None else (None, 0, 1)
    v_cap = max(cfg.vocab_size, len(id_to_word)) + 1
    max_token_length = cfg.max_token_length if cfg.max_token_length is not None else 1 << 30
    prefix = cfg.continuing_subword_prefix

    W = len(words)
    K = max(2, max((len(w) for w, _ in words), default=1))
    Wp = -(-max(W, 1) // ranks) * ranks
    ids_np = np.full((Wp, K), -1, np.int32)
    wc_np = np.zeros(Wp, np.int32)
    for i, (w, _lens) in enumerate(words):
        if w:
            ids_np[i, :len(w)] = w
            wc_np[i] = counts[i]
    pairs = initial_pairs(ids_np, wc_np, v_cap)
    dreg = DeviceRegistry(pairs, registry_size(len(pairs)), device)
    lo, hi = rank * (Wp // ranks), (rank + 1) * (Wp // ranks)
    d_words = torch.from_numpy(ids_np[lo:hi]).to(device)
    d_wc = torch.from_numpy(wc_np[lo:hi]).to(device)
    d_lens = (d_words >= 0).to(torch.int32)
    k_steps = reach(K)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_loop = time.perf_counter()

    merges: List[Tuple[Tuple[int, int], int]] = []
    reads = rows_total = 0
    upsert_s = 0.0
    pbar = cfg.merges_bar(len(word_to_id))
    while len(word_to_id) < cfg.vocab_size:
        best, sa, sb = torch.stack(select(dreg.reg_a, dreg.reg_b, dreg.count)).tolist()
        reads += 1
        if best < 1 or cfg.min_frequency > best:
            break

        new_token = merged_token(id_to_word[sa], id_to_word[sb], prefix)
        new_id = word_to_id.get(new_token, len(id_to_word))
        if new_token not in word_to_id:
            id_to_word.append(new_token)
            word_to_id[new_token] = new_id
        merges.append(((sa, sb), new_id))
        pbar.inc(1)

        # the round changes only the rows holding both symbols
        rows = ((d_words == sa).any(1) & (d_words == sb).any(1)).nonzero().squeeze(1)
        reads += 1
        sub, sub_lens, dl, dr = round_step(
            d_words[rows], d_lens[rows], d_wc[rows], dreg.count, dreg.slot_rows, sa, sb,
            dreg.reg.index[(sa, sb)], new_id, max_token_length, k_steps, v_cap, group)
        reads += 1 + (group is not None)  # the sites' `nonzero`; the summed site count
        d_words[rows] = sub
        d_lens[rows] = sub_lens
        dldr = torch.cat([dl, dr]).cpu().numpy()
        reads += 1
        rows_total += rows.numel()

        t_up = time.perf_counter()
        dl, dr = dldr[:v_cap], dldr[v_cap:]
        upd = [dreg.upsert(int(x), new_id, int(dl[x])) for x in np.nonzero(dl)[0]]
        upd += [dreg.upsert(new_id, int(y), int(dr[y])) for y in np.nonzero(dr)[0]]
        dreg.apply(upd)
        upsert_s += time.perf_counter() - t_up

    pbar.finish()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats.update(path="per_round", pack_s=t_loop - t, loop_s=time.perf_counter() - t_loop,
                 merges=len(merges), host_reads=reads + dreg.reads, host_upsert_s=upsert_s,
                 words_shape=[W, K], p_cap=dreg.reg.p_cap, registry_grown=dreg.grown,
                 registry_pairs=dreg.reg.n, v_cap=v_cap, rank_rows=hi - lo,
                 mean_rows_per_round=rows_total / max(1, len(merges)))
    return merges


class DistributedBpeTrainer:
    """`BpeTrainer`'s configuration surface; `train` runs on `device`
    (the card unless the caller asks for `device="cpu"`), sharded over
    `mesh` (a `DeviceMesh`; every rank calls `train` with the same
    words) when one is given."""

    def __init__(self, mesh=None, device=None, **kwargs):
        self.base = BpeTrainer(device=device, **kwargs)
        self.mesh = mesh

    @property
    def words(self):
        return self.base.words

    @property
    def stats(self):
        return self.base.stats

    def feed(self, iterator, process, count_chunks=None):
        self.base.feed(iterator, process, count_chunks)

    def train(self, model) -> List[AddedToken]:
        return self.do_train(self.base.words, model)

    def do_train(self, word_counts: Dict[str, int], model) -> List[AddedToken]:
        return train_device(self.base, word_counts, model, self.mesh)
