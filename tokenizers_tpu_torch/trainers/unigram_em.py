"""Unigram trainer: suffix-array seeding, EM and pruning; port of
`tokenizers_tpu.trainers.unigram_em` (reference
`models/unigram/trainer.rs`).

* `make_seed_sentence_pieces` (:196): the corpus flattened with '\\0'
  separators; the candidates are the suffix tree's internal nodes
  (`native.suffix_substrings`), scored freq * char length, every single
  char kept; ordered (count desc, char desc) then (score desc, string
  desc); cut at `seed_size`; normalised to log probabilities.
* The EM loop (:529-611): `n_sub_iterations` x (E-step marginals, M-step
  with the Bayesian digamma), pruning by the approximate likelihood loss
  with `nbest(2)` alternatives (:277-432, the reference's
  `alternatives.len()` quirk in `logsum_alt` kept), shrinking to
  vocab_size * 1.1, then `finalize` (:113) with the required chars and
  unk.

The corpus-wide loops, the E-step and the pruning's Viterbi frequencies,
run on the trainer's device (`ops/unigram_em_step.DeviceEm`, sharded
over the trainer's `mesh` when it has one), except on
JAX's two host routes: sentences over 512 bytes, and passes whose pieces
build no device table; both are counted in `stats`.  `host=True` runs
every pass on the host lattices: the oracle the device route is held
against.  The pruning's per-piece `nbest(2)`, the M-step and seeding run
on the host, as in JAX.  All float math is f64.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.unigram_lattice import Lattice

SentencePiece = Tuple[str, float]


class TrainingError(Exception):
    pass


def digamma(x: float) -> float:
    result = 0.0
    while x < 7.0:
        result -= 1.0 / x
        x += 1.0
    x -= 0.5
    xx = 1.0 / x
    xx2 = xx * xx
    xx4 = xx2 * xx2
    result += (
        math.log(x)
        + (1.0 / 24.0) * xx2
        - (7.0 / 960.0) * xx4
        + (31.0 / 8064.0) * xx4 * xx2
        - (127.0 / 30720.0) * xx4 * xx4
    )
    return result


def to_log_prob(pieces: List[SentencePiece]) -> List[SentencePiece]:
    total = sum(score for _, score in pieces)
    logsum = math.log(total)
    return [(piece, math.log(score) - logsum) for piece, score in pieces]


def _make_unigram(pieces: List[SentencePiece]):
    from ..models.unigram import Unigram

    return Unigram(pieces, unk_id=0, byte_fallback=False)


class _TrainerOps:
    """The reference trainer's inner operations over (cfg, sentences); the
    E-step and the pruning's Viterbi frequencies on `device` (a
    `DeviceEm`) unless `host`."""

    def __init__(self, cfg, sentences: List[Tuple[str, int]], device=None, host: bool = False,
                 mesh=None):
        self.cfg = cfg
        self.sentences = sentences
        self.stats = cfg.stats
        self.stats.update(host_sentences=0, no_table_passes=0, e_step_s=[], viterbi_s=[],
                          prune_host_s=0.0, m_step_s=0.0)
        self.dev = None
        if not host:
            from ..ops.unigram_em_step import DeviceEm

            t = time.perf_counter()
            self.dev = DeviceEm(sentences, device, mesh)
            self.stats.update(pack_s=time.perf_counter() - t, chunks=self.dev.stats["chunks"],
                              host_sentences=self.dev.stats["host_sentences"])

    # ------------------------------------------------------------- seeding

    def is_valid_sentencepiece(self, char_len: int) -> bool:
        return 0 < char_len <= self.cfg.max_piece_length

    def make_seed_sentence_pieces(self) -> List[SentencePiece]:
        from ..native import suffix_substrings

        flat_chars: List[int] = []
        all_chars: Dict[str, int] = {}
        for string, n in self.sentences:
            if not string:
                continue
            flat_chars.extend(ord(c) for c in string)
            flat_chars.append(0)  # sentence boundary '\0'
            for c in string:
                if c != "\0":
                    all_chars[c] = all_chars.get(c, 0) + n

        chars = np.array(flat_chars, dtype=np.int32)
        nodes = suffix_substrings(chars)
        flat = chars.tolist()

        substr_index: List[Tuple[int, Tuple[int, ...]]] = []
        for off, length, freq in nodes:
            if length <= 1:
                continue
            sub = tuple(flat[off : off + length])
            if 0 in sub:
                continue
            if not self.is_valid_sentencepiece(length):
                continue
            substr_index.append((freq * length, sub))

        seed: List[SentencePiece] = []
        sall = sorted(((cnt, c) for c, cnt in all_chars.items()), reverse=True)
        for cnt, c in sall:
            seed.append((c, float(cnt)))
        substr_index.sort(reverse=True)
        for score, sub in substr_index:
            seed.append(("".join(map(chr, sub)), float(score)))
            if len(seed) >= self.cfg.seed_size:
                break
        return to_log_prob(seed)

    def required_chars(self) -> List[str]:
        out = set()
        for s, _ in self.sentences:
            out.update(s)
        out.update(self.cfg.initial_alphabet)
        return sorted(out)

    # ------------------------------------------------------------------ EM

    def _lattice(self, model, string: str) -> Lattice:
        lattice = Lattice(string, model.bos_id, model.eos_id)
        model.populate_nodes(lattice)
        return lattice

    def run_e_step(self, model) -> Tuple[float, int, List[float]]:
        t = time.perf_counter()
        all_freq = sum(n for _, n in self.sentences)
        out = self.dev.e_step(model) if self.dev is not None else None
        if out is not None:
            exp_arr, z, ntokens = out
            if np.isnan(z).any() or np.isnan(exp_arr).any():
                raise TrainingError("likelihood is NAN. Input sentence may be too long.")
            objs = -float(z.sum()) / all_freq
            expected = exp_arr.tolist()
        else:
            expected = [0.0] * len(model.pieces)
            objs = 0.0
            ntokens = 0
            for string, freq in self.sentences:
                lattice = self._lattice(model, string)
                z = lattice.populate_marginal(float(freq), expected)
                if math.isnan(z):
                    raise TrainingError("likelihood is NAN. Input sentence may be too long.")
                ntokens += len(lattice.viterbi())
                objs -= z / all_freq
        self.stats["e_step_s"].append(time.perf_counter() - t)
        return objs, ntokens, expected

    def run_m_step(self, pieces: List[SentencePiece],
                   expected: List[float]) -> List[SentencePiece]:
        assert len(pieces) == len(expected)
        t = time.perf_counter()
        new_pieces: List[SentencePiece] = []
        total = 0.0
        threshold = 0.5
        for i, (freq, (piece, _score)) in enumerate(zip(expected, pieces)):
            if i == 0:  # always keep unk
                new_pieces.append((piece, float("nan")))
                continue
            if freq < threshold:
                continue
            new_pieces.append((piece, freq))
            total += freq
        logsum = digamma(total)
        # applied to every entry, unk's NaN included (digamma(NaN) = NaN), as
        # the reference does
        out = [(p, digamma(c) - logsum) for p, c in new_pieces]
        self.stats["m_step_s"] += time.perf_counter() - t
        return out

    # -------------------------------------------------------------- pruning

    def prune_sentence_pieces(self, model, pieces: List[SentencePiece]) -> List[SentencePiece]:
        cfg = self.cfg
        t = time.perf_counter()
        always_keep = [True] * len(pieces)
        alternatives: List[List[int]] = [[] for _ in pieces]
        bos_id = len(pieces) + 1
        eos_id = len(pieces) + 2

        for pid, (token, _score) in enumerate(pieces):
            if pid == 0:
                always_keep[pid] = False
                continue
            lattice = Lattice(token, bos_id, eos_id)
            model.populate_nodes(lattice)
            nbests = lattice.nbest(2)
            if len(nbests) == 1:
                always_keep[pid] = True
            elif len(nbests[0]) >= 2:
                always_keep[pid] = False
            elif len(nbests[0]) == 1:
                always_keep[pid] = True
                for node in nbests[1]:
                    alternatives[pid].append(node.id)
        self.stats["prune_host_s"] += time.perf_counter() - t

        t = time.perf_counter()
        freq_arr = self.dev.viterbi_freq(model) if self.dev is not None else None
        inverted: Optional[List[List[int]]] = None
        if freq_arr is not None:
            vsum = float(sum(count for _, count in self.sentences))
            freq = freq_arr.tolist()
        else:
            vsum = 0.0
            freq = [0.0] * len(pieces)
            inverted = [[] for _ in pieces]
            for i, (sentence, count) in enumerate(self.sentences):
                lattice = Lattice(sentence, bos_id, eos_id)
                model.populate_nodes(lattice)
                vsum += float(count)
                for node in lattice.viterbi():
                    freq[node.id] += float(count)
                    inverted[node.id].append(i)
        self.stats["viterbi_s"].append(time.perf_counter() - t)

        t = time.perf_counter()
        total = sum(freq)
        logsum = math.log(total)
        candidates: List[Tuple[int, float]] = []
        new_pieces: List[SentencePiece] = [pieces[0]]
        for pid, (token, score) in enumerate(pieces):
            if pid == 0:
                continue
            if freq[pid] == 0.0 and not always_keep[pid]:
                continue
            elif not alternatives[pid]:
                new_pieces.append((token, score))
            else:
                # each Viterbi occurrence of a piece appends its sentence to
                # `inverted` and adds the same count to `freq`, so the two sums
                # are equal: the device route uses freq directly
                # (reference `trainer.rs:320-357,380-395`)
                if inverted is None:
                    f = freq[pid]
                else:
                    f = 0.0
                    for n in inverted[pid]:
                        f += float(self.sentences[n][1])
                if f == 0.0 or math.isnan(f):
                    continue
                f /= vsum
                logprob_sp = math.log(freq[pid]) - logsum
                # the reference uses alternatives.len(): the number of PIECES,
                # not of this piece's alternatives (kept, `trainer.rs:402`)
                logsum_alt = math.log(total + freq[pid] * (len(alternatives) - 1))
                logprob_alt = 0.0
                for n in alternatives[pid]:
                    logprob_alt += math.log(freq[n] + freq[pid]) - logsum_alt
                loss = f * (logprob_sp - logprob_alt)
                candidates.append((pid, loss))

        desired = cfg.vocab_size * 11 // 10
        pruned_size = max(desired, int(len(pieces) * cfg.shrinking_factor))
        candidates.sort(key=lambda x: x[1], reverse=True)
        for pid, _loss in candidates:
            if len(new_pieces) == pruned_size:
                break
            new_pieces.append(pieces[pid])
        self.stats["prune_host_s"] += time.perf_counter() - t
        return new_pieces

    # ------------------------------------------------------------- finalize

    def finalize(self, model, required_chars: List[str]):
        cfg = self.cfg
        min_score_penalty = 0.0
        min_score_penalty_delta = 0.0001

        pieces: List[SentencePiece] = []
        inserted = {"<UNK>"}
        existing = {tok: score for tok, score in model.pieces}
        for c in required_chars:
            if c in existing:
                inserted.add(c)
                pieces.append((c, existing[c]))
            else:
                score = model.min_score + min_score_penalty
                inserted.add(c)
                pieces.append((c, score))
                min_score_penalty += min_score_penalty_delta

        unk_id: Optional[int] = None
        need_add_unk = False
        if cfg.unk_token is not None:
            unk_id = next((i for i, t in enumerate(cfg.special_tokens)
                           if t.content == cfg.unk_token), None)
            if unk_id is None:
                unk_id, need_add_unk = 0, True

        vocab_size_without_special = (
            cfg.vocab_size - len(cfg.special_tokens) - 1
            if need_add_unk
            else cfg.vocab_size - len(cfg.special_tokens)
        )
        for token, score in model.pieces:
            if token in inserted:
                continue
            inserted.add(token)
            pieces.append((token, 0.0 if math.isnan(score) else score))
            if len(pieces) == vocab_size_without_special:
                break
        pieces.sort(key=lambda x: x[1], reverse=True)

        special = [(t.content, 0.0) for t in cfg.special_tokens]
        if need_add_unk:
            special.insert(0, (cfg.unk_token, 0.0))

        from ..models.unigram import Unigram

        return Unigram(special + pieces, unk_id=unk_id, byte_fallback=False)


def do_train(cfg, word_counts: Dict[str, int], model, device=None, host: bool = False,
             mesh=None):
    """Train `model` (a port `models.unigram.Unigram`, re-initialised in
    place) on the word counts; -> the special tokens to add.  The E-step
    and the pruning statistics run on `device` (the card unless the
    caller asks for the CPU), sharded over `mesh` when one is given, or
    with `host` on the host lattices."""
    t0 = time.perf_counter()
    sentences = list(word_counts.items())
    ops = _TrainerOps(cfg, sentences, device, host, mesh)
    st = ops.stats

    t = time.perf_counter()
    pieces: List[SentencePiece] = [("<UNK>", float("nan"))]
    pieces.extend(ops.make_seed_sentence_pieces())
    st.update(seed_s=time.perf_counter() - t, seed_pieces=len(pieces) - 1)
    desired_vocab_size = cfg.vocab_size * 11 // 10

    required_chars = ops.required_chars()
    if len(required_chars) > cfg.vocab_size:
        raise TrainingError("The vocabulary is not large enough to contain all chars")

    new_model = _make_unigram(pieces)
    rounds = 0
    while True:
        rounds += 1
        for _ in range(cfg.n_sub_iterations):
            _obj, _ntok, expected = ops.run_e_step(new_model)
            pieces = ops.run_m_step(pieces, expected)
            new_model = _make_unigram(pieces)
        if len(pieces) <= desired_vocab_size:
            break
        pieces = ops.prune_sentence_pieces(new_model, pieces)
        new_model = _make_unigram(pieces)

    final = ops.finalize(new_model, required_chars)
    model.__init__(final.pieces, final.unk_id, final.byte_fallback)
    if ops.dev is not None:
        st["no_table_passes"] = ops.dev.stats["no_table_passes"]
    st.update(em_rounds=rounds, e_steps=len(st["e_step_s"]), path="host" if host else "device",
              train_s=time.perf_counter() - t0)
    return list(cfg.special_tokens)
