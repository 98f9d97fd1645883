"""Byte-Pair Encoding model of the host path: lowest-(rank, position)-first
pair merging per word, with a bounded word cache.

Copy of the merge of `tokenizers_tpu.models.bpe` (`_Word`, the heap loop
and `_merge_word`, reference `models/bpe/model.rs:382-460`) for the
options the port's loader admits: vocab, merges, an unk token (with
fuse_unk; without one an unknown char is dropped), `ignore_merges`, which
looks a whole word up in the vocab before merging it, and for the
char-level pipelines `continuing_subword_prefix` (on every char but a
word's first), `end_of_word_suffix` (on its last) and `byte_fallback`
(an unknown char as its bytes' `<0xXX>` tokens when all exist), and BPE
dropout: each merge popped from the heap is skipped with probability
`dropout`, drawn from the model's `random.Random` (`rng`, a fresh one by
default) in the JAX package's order (`tokenizers_tpu/models/bpe.py:83`);
under dropout a word is merged anew each time (no word cache, no
`ignore_merges` lookup), as there.
`tokenize_spans` gives each token's span in the word: in chars when
`byte_spans` is False (a word of the byte-level pipelines has one char
for each byte of the text), else in UTF-8 bytes of the word (the
char-level pipelines, whose spans map through the normalizer's byte
alignments).  The host path encodes the inputs the device does not
take: inputs with added tokens, long inputs with no safe seam, and rows
the device program flags `row_bad`.
"""

from __future__ import annotations

import heapq
import json
import os
import random
from typing import Dict, List, Optional, Tuple

from ..errors import ModelError
from ..pretokenized import Token
from ..utils.cache import DEFAULT_CACHE_CAPACITY, Cache
from ..utils.log import get_logger
from . import Model

MAX_CACHEABLE_LENGTH = 256


class _Word:
    """Symbol list + merge loop; each symbol's length in chars of the word,
    0 once merged into its left neighbour."""

    __slots__ = ("ids", "lens", "prev", "next")

    def __init__(self):
        self.ids: List[int] = []
        self.lens: List[int] = []
        self.prev: List[int] = []
        self.next: List[int] = []

    def add(self, id: int, n_chars: int) -> None:
        n = len(self.ids)
        if n > 0:
            self.next[n - 1] = n
        self.ids.append(id)
        self.lens.append(n_chars)
        self.prev.append(n - 1)
        self.next.append(-1)

    def merge_all(self, merges: Dict[Tuple[int, int], Tuple[int, int]],
                  dropout: Optional[float] = None, rng: Optional[random.Random] = None) -> None:
        ids, lens, prev, nxt = self.ids, self.lens, self.prev, self.next
        heap: List[Tuple[int, int, int]] = []  # (rank, pos, new_id)
        for i in range(len(ids) - 1):
            m = merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        drop = dropout is not None and dropout > 0.0
        skip: List[Tuple[int, int, int]] = []
        while heap:
            top = heapq.heappop(heap)
            if drop and rng.random() < dropout:
                skip.append(top)
                continue
            for item in skip:
                heapq.heappush(heap, item)
            skip.clear()
            rank, pos, new_id = top
            if lens[pos] == 0 or nxt[pos] == -1:
                continue
            next_pos = nxt[pos]
            # revalidate against the current symbols
            cur = merges.get((ids[pos], ids[next_pos]))
            if cur is None or cur[1] != new_id:
                continue
            ids[pos] = new_id
            lens[pos] += lens[next_pos]
            right_next = nxt[next_pos]
            nxt[pos] = right_next
            lens[next_pos] = 0
            if right_next > -1:
                prev[right_next] = pos
            if prev[pos] >= 0:
                p = prev[pos]
                m = merges.get((ids[p], ids[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if right_next > -1:
                m = merges.get((ids[pos], ids[right_next]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))

    def tokens(self) -> Tuple[List[int], List[int]]:
        """(ids, lengths in chars) of the tokens, in order."""
        return [i for i, n in zip(self.ids, self.lens) if n], [n for n in self.lens if n]


class BPE(Model):
    """JAX's parameters in JAX's order, then the port's own: `byte_spans`
    (spans in UTF-8 bytes of the word, for the char-level pipelines) and
    `rng` (the dropout's `random.Random`)."""

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 merges: Optional[List[Tuple[str, str]]] = None,
                 cache_capacity: int = DEFAULT_CACHE_CAPACITY,
                 dropout: Optional[float] = None, unk_token: Optional[str] = None,
                 continuing_subword_prefix: Optional[str] = None,
                 end_of_word_suffix: Optional[str] = None, fuse_unk: bool = False,
                 byte_fallback: bool = False, ignore_merges: bool = False,
                 byte_spans: bool = False, rng: Optional[random.Random] = None):
        merges = merges or []
        if dropout is not None and not 0.0 <= dropout <= 1.0:
            raise ValueError("dropout must be between 0 and 1")
        self.dropout = dropout
        self.rng = rng if rng is not None else random.Random()
        self.vocab: Dict[str, int] = dict(vocab or {})
        self.vocab_r: Dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.unk_token = unk_token
        self.fuse_unk = fuse_unk
        self.ignore_merges = ignore_merges
        self.continuing_subword_prefix = continuing_subword_prefix
        self.end_of_word_suffix = end_of_word_suffix
        self.byte_fallback = byte_fallback
        self.byte_spans = byte_spans
        self.cache = Cache(cache_capacity)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.merges_list: List[Tuple[str, str]] = [tuple(m) for m in merges]
        n_prefix = len((continuing_subword_prefix or "").encode("utf-8"))
        for i, (a, b) in enumerate(merges):
            # the merged token drops the right member's prefix (model.rs:174-192)
            new = a + b.encode("utf-8")[n_prefix:].decode("utf-8")
            for t in (a, b, new):
                if t not in self.vocab:
                    raise ModelError(f"Merge token out of vocabulary: {t!r}")
            self.merges[(self.vocab[a], self.vocab[b])] = (i, self.vocab[new])

    def _merge_word(self, w: str, byte_spans: bool) -> Tuple[List[int], List[int]]:
        word = _Word()
        unk: Optional[Tuple[int, int]] = None  # (unk_id, length)
        prefix, suffix = self.continuing_subword_prefix, self.end_of_word_suffix
        for i, c in enumerate(w):
            n = len(c.encode("utf-8")) if byte_spans else 1
            s = prefix + c if prefix and i else c
            if suffix and i == len(w) - 1:
                s += suffix
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    word.add(*unk)
                    unk = None
                word.add(tid, n)
                continue
            if self.byte_fallback:
                codes = [self.vocab.get("<0x%02X>" % b) for b in s.encode("utf-8")]
                if all(t is not None for t in codes):
                    # the reference does not flush a pending unk here
                    # (model.rs:419-433), and neither does this copy
                    for t in codes:
                        word.add(t, 1)
                    continue
            if self.unk_token is None:
                continue
            unk_id = self.vocab.get(self.unk_token)
            if unk_id is None:
                raise ModelError(f"Unk token `{self.unk_token}` is out of vocabulary")
            if unk is not None and self.fuse_unk:
                unk = (unk[0], unk[1] + n)
            else:
                if unk is not None:
                    word.add(*unk)
                unk = (unk_id, n)
        if unk is not None:
            word.add(*unk)
        word.merge_all(self.merges, self.dropout, self.rng)
        return word.tokens()

    def _tokens(self, word: str, byte_spans: Optional[bool] = None) -> Tuple[List[int], List[int]]:
        """(ids, lengths) of one pre-tokenized word, in chars or, with
        `byte_spans` (default: the model's), in UTF-8 bytes; the word
        cache holds the model's unit."""
        if byte_spans is None:
            byte_spans = self.byte_spans
        if self.dropout:
            return self._merge_word(word, byte_spans)
        if self.ignore_merges:
            tid = self.vocab.get(word)
            if tid is not None:
                return [tid], [len(word.encode("utf-8")) if byte_spans else len(word)]
        cached = byte_spans == self.byte_spans
        hit = self.cache.get(word) if cached else None
        if hit is not None:
            return hit
        toks = self._merge_word(word, byte_spans)
        if cached and len(word) < MAX_CACHEABLE_LENGTH:
            self.cache.set(word, toks)
        return toks

    def tokenize_ids(self, word: str) -> List[int]:
        """The ids of one pre-tokenized word."""
        return self._tokens(word)[0] if word else []

    def clear_cache(self) -> None:
        self.cache.clear()

    def get_trainer(self, device=None):
        from ..trainers.bpe_trainer import BpeTrainer

        return BpeTrainer(device=device)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token(self, id: int) -> Optional[str]:
        return self.vocab_r.get(id)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    def ranked_merges(self) -> List[Tuple[str, str]]:
        """The merges by rank, as strings (a pair listed twice keeps its
        last rank, as the model's merge map does)."""
        ranked = sorted((rank, pair) for pair, (rank, _new) in self.merges.items())
        return [(self.vocab_r[a], self.vocab_r[b]) for _rank, (a, b) in ranked]

    @staticmethod
    def read_file(vocab_path: str, merges_path: str):
        """(vocab, merges) of a `vocab.json` and a `merges.txt` (a first line
        `#version...` and empty lines skipped; reference
        `models/bpe/model.rs:254-290`)."""
        with open(vocab_path, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.rstrip("\n")
                if (i == 0 and line.startswith("#version")) or not line:
                    continue
                parts = line.split(" ")
                if len(parts) != 2:
                    raise ModelError(f"Invalid merges line: {line!r}")
                merges.append((parts[0], parts[1]))
        return vocab, merges

    @classmethod
    def from_file(cls, vocab_path: str, merges_path: str, **kwargs) -> "BPE":
        vocab, merges = cls.read_file(vocab_path, merges_path)
        return cls(vocab, merges, **kwargs)

    def save(self, folder: str, prefix: Optional[str] = None) -> List[str]:
        """Write `[prefix-]vocab.json` (tokens by id) and `[prefix-]merges.txt`
        (`#version: 0.2`, then one merge a line by rank); the paths."""
        vocab_path = os.path.join(folder, f"{prefix}-vocab.json" if prefix else "vocab.json")
        merges_path = os.path.join(folder, f"{prefix}-merges.txt" if prefix else "merges.txt")
        holes = [i for i in range(len(self.vocab_r)) if i not in self.vocab_r]
        if holes:  # reference models/mod.rs:54
            get_logger("models").warning(
                "The OrderedVocab you are attempting to save contains holes for indices %s, "
                "your vocabulary could be corrupted !", holes[:16])
        with open(vocab_path, "w", encoding="utf-8") as f:
            json.dump({self.vocab_r[i]: i for i in sorted(self.vocab_r)}, f, ensure_ascii=False)
        with open(merges_path, "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in self.ranked_merges():
                f.write(f"{a} {b}\n")
        return [vocab_path, merges_path]

    def tokenize(self, sequence: str) -> List[Token]:
        """JAX's `Token`s, offsets in the word's UTF-8 bytes whatever the
        model's span unit (a byte-fallback token spans one byte of a
        char)."""
        vr = self.vocab_r
        return [Token(t, vr[t], (s, e)) for t, s, e in self.tokenize_spans(sequence, True)]

    def tokenize_spans(self, word: str, byte_spans: Optional[bool] = None
                       ) -> List[Tuple[int, int, int]]:
        """(id, start, end) of each token of one pre-tokenized word, the
        span in chars of the word (in its UTF-8 bytes with `byte_spans`,
        by default the model's)."""
        if not word:
            return []
        ids, lens = self._tokens(word, byte_spans)
        out, pos = [], 0
        for tid, n in zip(ids, lens):
            out.append((tid, pos, pos + n))
            pos += n
        return out
