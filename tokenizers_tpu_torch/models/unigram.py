"""Unigram (SentencePiece) model of the host path; copy of the encode of
`tokenizers_tpu.models.unigram` (reference `models/unigram/model.rs`).

`encode` is the optimized forward DP over byte positions
(`encode_optimized`, `model.rs:240-329`) in f64: at each char start every
piece that matches extends the best path (a later candidate replaces only
on a strictly greater score), a char with no single-char piece falls back
to `unk_id` at `min_score - 10`, and the backtrack fuses consecutive unk
pieces into one token (`fuse_unk`, always true for a deserialized model).
`tokenize_spans` maps the pieces to ids, an unknown one to its
`<0xXX>` byte tokens where `byte_fallback` holds and all of them exist
(each spanning the whole piece), else to `unk_id`.  A piece listed twice
takes its last id.  Words under 256 bytes are cached (10,000 entries,
inserted only while below capacity).

The scores must be the wheel's: the loader parses them with
`utils.serde_float.serde_f64`.  The device engine (`ops/unigram_engine.py`)
sends the inputs it does not take here, and the words it flags
(`_encode_word_host`).  `populate_nodes` fills a lattice
(`unigram_lattice.Lattice`: Viterbi, n-best, marginals) for the EM
trainer (`trainers/unigram_em.py`), whose models may hold a NaN score
(unk's after an M-step): `min_score` skips it, as the reference's does.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

from ..utils.cache import Cache
from ..pretokenized import Token
from . import Model
from .bpe import MAX_CACHEABLE_LENGTH

K_UNK_PENALTY = 10.0


class Unigram(Model):
    def __init__(self, vocab: Optional[List[Tuple[str, float]]] = None,
                 unk_id: Optional[int] = None, byte_fallback: bool = False):
        """`vocab`: the (piece, score) list, kept as `pieces`; the model's
        `vocab` is the piece-to-id dict, as the other models'."""
        if vocab is None:  # the reference's default model
            vocab, unk_id = [("<unk>", 0.0)], 0
        if unk_id is not None:
            if not vocab:
                raise ValueError("The vocabulary is empty but at least <unk> is needed")
            if unk_id >= len(vocab):
                raise ValueError("The `unk_id` is larger than vocabulary size")
        self.pieces: List[Tuple[str, float]] = [(t, float(s)) for t, s in vocab]
        self.unk_id = unk_id
        self.byte_fallback = bool(byte_fallback)
        self.fuse_unk = True
        self.vocab: Dict[str, int] = {}
        for i, (tok, _s) in enumerate(self.pieces):
            self.vocab[tok] = i  # the last duplicate wins
        self.vocab_r: Dict[int, str] = {i: t for i, (t, _s) in enumerate(self.pieces)}
        self.min_score = math.inf
        for _t, score in self.pieces:
            if score < self.min_score:  # NaN never is
                self.min_score = score
        self.bos_id = len(self.pieces) + 1
        self.eos_id = len(self.pieces) + 2
        self._piece_scores: Dict[bytes, Tuple[int, float]] = {}
        self._max_piece_len = 1
        for tok, score in self.pieces:
            b = tok.encode("utf-8")
            self._piece_scores[b] = (self.vocab[tok], score)
            self._max_piece_len = max(self._max_piece_len, len(b))
        self.cache = Cache()

    def encode(self, sentence: str) -> List[str]:
        """The pieces of `sentence` (unk pieces fused)."""
        if not sentence:
            return []
        hit = self.cache.get(sentence)
        if hit is not None:
            return list(hit)
        result = self._encode_optimized(sentence)
        if len(sentence.encode("utf-8")) < MAX_CACHEABLE_LENGTH:
            self.cache.set(sentence, list(result))
        return result

    def _encode_optimized(self, sentence: str) -> List[str]:
        sb = sentence.encode("utf-8")
        size = len(sb)
        unk_score = self.min_score - K_UNK_PENALTY
        node_id = [0] * (size + 1)
        node_score = [0.0] * (size + 1)
        node_start: List[Optional[int]] = [None] * (size + 1)
        piece_scores, max_len = self._piece_scores, self._max_piece_len
        starts_at = 0
        while starts_at < size:
            score_here = node_score[starts_at]
            b0 = sb[starts_at]
            mblen = 1 if b0 < 0x80 else 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
            has_single_node = False
            for n in range(1, min(max_len, size - starts_at) + 1):
                entry = piece_scores.get(sb[starts_at : starts_at + n])
                if entry is None:
                    continue
                pid, pscore = entry
                key_pos = starts_at + n
                candidate = pscore + score_here
                if node_start[key_pos] is None or candidate > node_score[key_pos]:
                    node_score[key_pos] = candidate
                    node_start[key_pos] = starts_at
                    node_id[key_pos] = pid
                if n == mblen:
                    has_single_node = True
            if not has_single_node:
                if self.unk_id is None:
                    raise ValueError("Encountered an unknown token but `unk_id` is missing")
                key_pos = starts_at + mblen
                candidate = unk_score + score_here
                if node_start[key_pos] is None or candidate > node_score[key_pos]:
                    node_score[key_pos] = candidate
                    node_start[key_pos] = starts_at
                    node_id[key_pos] = self.unk_id
            starts_at += mblen

        ends_at = size
        results: List[str] = []
        unk_parts: List[str] = []
        while ends_at > 0:
            s = node_start[ends_at]
            piece = sb[s:ends_at].decode("utf-8")
            if self.unk_id is not None and node_id[ends_at] == self.unk_id:
                unk_parts.append(piece)
            else:
                if unk_parts:
                    results.append("".join(reversed(unk_parts)))
                    unk_parts = []
                results.append(piece)
            ends_at = s
        if unk_parts:
            results.append("".join(reversed(unk_parts)))
        results.reverse()
        return results

    def tokenize_spans(self, word: str) -> List[Tuple[int, int, int, str]]:
        """(id, start, end, token string) of each token of `word`, spans in
        its UTF-8 bytes (`model.rs:410-455`)."""
        out: List[Tuple[int, int, int, str]] = []
        offset = 0
        for string in self.encode(word):
            ln = len(string.encode("utf-8"))
            tid = self.vocab.get(string)
            if tid is None:
                if self.byte_fallback:
                    byte_ids = [self.vocab.get("<0x%02X>" % b) for b in string.encode("utf-8")]
                    if all(b is not None for b in byte_ids):
                        out.extend((b, offset, offset + ln, self.vocab_r[b]) for b in byte_ids)
                        offset += ln
                        continue
                if self.unk_id is None:
                    raise ValueError("Encountered an unknown token but `unk_id` is missing")
                tid = self.unk_id
            out.append((tid, offset, offset + ln, string))
            offset += ln
        return out

    def tokenize(self, sentence: str) -> List[Token]:  # JAX's parameter name
        return super().tokenize(sentence)

    def clear_cache(self) -> None:
        self.cache.clear()

    def populate_nodes(self, lattice) -> None:
        """Insert every vocab piece that starts at a char start, shortest
        first, and an unk node of the char's length where no piece of
        exactly that length does (reference `model.rs:160-199`)."""
        unk_score = self.min_score - K_UNK_PENALTY
        sb = lattice.sentence_bytes
        size = len(sb)
        piece_scores, max_len = self._piece_scores, self._max_piece_len
        begin_pos = 0
        while begin_pos < size:
            b0 = sb[begin_pos]
            mblen = 1 if b0 < 0x80 else 2 if b0 < 0xE0 else 3 if b0 < 0xF0 else 4
            has_single_node = False
            for n in range(1, min(max_len, size - begin_pos) + 1):
                entry = piece_scores.get(sb[begin_pos : begin_pos + n])
                if entry is None:
                    continue
                lattice.insert(begin_pos, n, entry[1], entry[0])
                if n == mblen:
                    has_single_node = True
            if not has_single_node and self.unk_id is not None:
                lattice.insert(begin_pos, mblen, unk_score, self.unk_id)
            begin_pos += mblen

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token(self, id: int) -> Optional[str]:
        return self.pieces[id][0] if 0 <= id < len(self.pieces) else None

    def get_trainer(self, device=None):
        from ..trainers.unigram_trainer import UnigramTrainer

        return UnigramTrainer(device=device)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    def get_vocab_size(self) -> int:
        return len(self.pieces)

    def save(self, folder: str, prefix: Optional[str] = None) -> List[str]:
        """Write `[prefix-]unigram.json` (the model's tokenizer.json entry,
        indented); the path."""
        path = os.path.join(folder, f"{prefix}-unigram.json" if prefix else "unigram.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"type": "Unigram", "unk_id": self.unk_id,
                       "vocab": [[t, s] for t, s in self.pieces],
                       "byte_fallback": self.byte_fallback}, f, ensure_ascii=False, indent=2)
        return [path]
