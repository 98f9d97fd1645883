"""BpeTrainer: the configuration, word counting and host merge loop of
BPE training; copy of `tokenizers_tpu.trainers.bpe_trainer` (reference
`models/bpe/trainer.rs`): special tokens first, then the alphabet
(`limit_alphabet` drops the rarest chars, the rest sorted by code point;
`initial_alphabet` always kept), each word as its in-alphabet chars, and
merges in (count desc, pair asc) order with incremental pair counts and
`max_token_length`.

`train` runs on the device (`parallel.bpe_train.train_device`: the dense
whole-loop program or the per-round registry program, by size) on the
trainer's `device`, the card unless the caller asks for `device="cpu"`.
`do_train` runs the Python heap loop, the oracle both device
programs are held against.

With `continuing_subword_prefix` or `end_of_word_suffix` set, the derived
alphabet ids ("##t") are minted in the first-occurrence order of the
words, where the reference mints them in a per-process hash order (so
its merge list is then not deterministic); the vocab is the same set.
"""

from __future__ import annotations

import heapq
import time
from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from ..added_vocabulary import AddedToken
from ..utils.progress import progress_bar

FEED_CHUNK = 2000  # sequences a feed chunk (the JAX package's)


def merged_token(part_a: str, part_b: str, prefix: Optional[str]) -> str:
    """The string of the token (a, b) merges into: b loses the
    continuing-subword prefix, as in the reference's trainer."""
    if prefix and part_b.startswith(prefix):
        part_b = part_b[len(prefix):]
    return part_a + part_b


def count_words(process: Callable[[str], List[str]], sequences: List[str]) -> Counter:
    local: Counter = Counter()
    for sequence in sequences:
        local.update(process(sequence))
    return local


def special_tokens_of(tokens) -> List[AddedToken]:
    return [t if isinstance(t, AddedToken) else AddedToken(t, special=True)
            for t in (tokens or [])]


class BpeTrainer:
    def __init__(
        self,
        vocab_size: int = 30000,
        min_frequency: int = 0,
        show_progress: bool = True,
        special_tokens: Optional[List] = None,
        limit_alphabet: Optional[int] = None,
        initial_alphabet: Optional[Set[str]] = None,
        continuing_subword_prefix: Optional[str] = None,
        end_of_word_suffix: Optional[str] = None,
        max_token_length: Optional[int] = None,
        device=None,
    ):
        self.vocab_size = vocab_size
        self.min_frequency = min_frequency
        self.show_progress = show_progress  # the "Compute merges" bar on a terminal
        self.special_tokens = special_tokens_of(special_tokens)
        self.limit_alphabet = limit_alphabet
        self.initial_alphabet = set(initial_alphabet or [])
        self.continuing_subword_prefix = continuing_subword_prefix
        self.end_of_word_suffix = end_of_word_suffix
        self.max_token_length = max_token_length
        self.device = device
        self.words: Dict[str, int] = {}
        # what the last feed and train did: seconds, path, host reads, ...
        self.stats: Dict[str, object] = {}

    # ------------------------------------------------------------------ feed

    def feed(self, iterator: Iterable[str], process: Callable[[str], List[str]],
             count_chunks: Optional[Callable[[List[List[str]]], List[Counter]]] = None) -> None:
        """Count the words `process` gives for each sequence.  Words keep
        their first-occurrence order, as the reference's map-reduce feed
        leaves them (`trainer.rs:609-638`).  From 4,000 sequences on, and
        given `count_chunks` (the Tokenizer passes its host pool's map,
        `Tokenizer._count_chunks`, as the JAX package's feed maps on its
        pool), the sequences go to `count_chunks` in chunks of 2,000, which
        gives each chunk's counts; these are added in chunk order, so the
        words and their order are the serial count's."""
        t = time.perf_counter()
        seqs = list(iterator)
        if len(seqs) >= 2 * FEED_CHUNK and count_chunks is not None:
            counted = count_chunks([seqs[i:i + FEED_CHUNK]
                                    for i in range(0, len(seqs), FEED_CHUNK)])
        else:
            counted = [count_words(process, seqs)]
        words = self.words
        for local in counted:
            for w, c in local.items():
                words[w] = words.get(w, 0) + c
        self.stats["feed_s"] = self.stats.get("feed_s", 0.0) + time.perf_counter() - t
        self.stats["words"] = len(words)

    # ----------------------------------------------------------------- train

    def train(self, model) -> List[AddedToken]:
        """Train `model` on the fed words on the trainer's device."""
        from ..parallel.bpe_train import train_device

        return train_device(self, self.words, model)

    def prepare(self, word_counts: Dict[str, int]):
        """(word_to_id, id_to_word, words, counts): special tokens and the
        alphabet minted, each word as (symbol ids, symbol lengths)."""
        word_to_id: Dict[str, int] = {}
        id_to_word: List[str] = []
        for token in self.special_tokens:
            if token.content not in word_to_id:
                id_to_word.append(token.content)
                word_to_id[token.content] = len(id_to_word) - 1
        self._compute_alphabet(word_counts, word_to_id, id_to_word)
        words, counts = self._tokenize_words(word_counts, word_to_id, id_to_word)
        return word_to_id, id_to_word, words, counts

    def do_train(self, word_counts: Dict[str, int], model) -> List[AddedToken]:
        """The heap merge loop (reference `trainer.rs:420-593`)."""
        word_to_id, id_to_word, words, counts = self.prepare(word_counts)
        max_token_length = (
            self.max_token_length if self.max_token_length is not None else 1 << 62
        )
        pair_counts: Dict[Tuple[int, int], int] = {}
        where_to_update: Dict[Tuple[int, int], Set[int]] = {}
        for i, (word, _lens) in enumerate(words):
            for a, b in zip(word, word[1:]):
                pair = (a, b)
                pair_counts[pair] = pair_counts.get(pair, 0) + counts[i]
                where_to_update.setdefault(pair, set()).add(i)

        # heap entries: (-count, pair, seq, pos_set)
        heap: List[Tuple[int, Tuple[int, int], int, Set[int]]] = []
        seq = 0
        for pair, pos in where_to_update.items():
            count = pair_counts[pair]
            if count > 0:
                heap.append((-count, pair, seq, pos))
                seq += 1
        where_to_update = {}
        heapq.heapify(heap)

        merges: List[Tuple[Tuple[int, int], int]] = []
        pbar = self.merges_bar(len(word_to_id))
        while len(word_to_id) < self.vocab_size and heap:
            neg_count, pair, _, pos = heapq.heappop(heap)
            count = -neg_count
            current = pair_counts.get(pair, 0)
            if count != current:
                heapq.heappush(heap, (-current, pair, seq, pos))
                seq += 1
                continue
            if count < 1 or self.min_frequency > count:
                break

            new_token = merged_token(id_to_word[pair[0]], id_to_word[pair[1]],
                                     self.continuing_subword_prefix)
            new_token_id = word_to_id.get(new_token, len(id_to_word))
            if new_token not in word_to_id:
                id_to_word.append(new_token)
                word_to_id[new_token] = new_token_id
            merges.append((pair, new_token_id))
            pbar.inc(1)

            # apply the merge at every position, collect pair-count deltas
            for i in sorted(pos):
                ids_i, lens_i = words[i]
                changes = _merge_word_inplace(
                    ids_i, lens_i, pair[0], pair[1], new_token_id, max_token_length
                )
                for chg_pair, change in changes:
                    pair_counts[chg_pair] = pair_counts.get(chg_pair, 0) + change * counts[i]
                    if change > 0:
                        where_to_update.setdefault(chg_pair, set()).add(i)

            for chg_pair, chg_pos in where_to_update.items():
                c = pair_counts[chg_pair]
                if c > 0:
                    heapq.heappush(heap, (-c, chg_pair, seq, chg_pos))
                    seq += 1
            where_to_update = {}

        pbar.finish()
        self.finalize_model(model, word_to_id, id_to_word, merges)
        return list(self.special_tokens)

    def merges_bar(self, n_tokens: int):
        """The "Compute merges" bar of a merge loop starting at `n_tokens`
        tokens (`utils.progress`; drawn with `show_progress` on a
        terminal)."""
        return progress_bar(self.show_progress, max(0, self.vocab_size - n_tokens),
                            "Compute merges")

    def finalize_model(self, model, word_to_id, id_to_word, merges) -> None:
        """Give `model` (a port `models.bpe.BPE`) the trained vocab and
        merges; its unk token, `fuse_unk` and `byte_fallback` stay, and it
        takes the trainer's prefix and suffix (`trainer.rs:595-606`)."""
        from ..utils.cache import Cache

        model.vocab = dict(word_to_id)
        model.vocab_r = {v: k for k, v in model.vocab.items()}
        model.merges = {pair: (i, new_id) for i, (pair, new_id) in enumerate(merges)}
        model.merges_list = [(id_to_word[p[0]], id_to_word[p[1]]) for p, _ in merges]
        model.continuing_subword_prefix = self.continuing_subword_prefix
        model.end_of_word_suffix = self.end_of_word_suffix
        model.cache = Cache(model.cache.capacity)

    # ---------------------------------------------------------------- helpers

    def _compute_alphabet(
        self, wc: Dict[str, int], word_to_id: Dict[str, int], id_to_word: List[str]
    ) -> None:
        alphabet: Dict[str, int] = {}
        for word, count in wc.items():
            for c in word:
                alphabet[c] = alphabet.get(c, 0) + count
        for c in self.initial_alphabet:
            alphabet[c] = 1 << 62

        kept = list(alphabet.items())
        to_remove = (
            max(0, len(alphabet) - self.limit_alphabet)
            if self.limit_alphabet is not None
            else 0
        )
        if to_remove > 0:
            kept.sort(key=lambda kv: kv[1])
            kept = kept[to_remove:]
        kept.sort(key=lambda kv: ord(kv[0]))
        for c, _ in kept:
            if c not in word_to_id:
                id_to_word.append(c)
                word_to_id[c] = len(id_to_word) - 1

    def _tokenize_words(
        self, wc: Dict[str, int], word_to_id: Dict[str, int], id_to_word: List[str]
    ) -> Tuple[List[Tuple[List[int], List[int]]], List[int]]:
        words: List[Tuple[List[int], List[int]]] = []
        counts: List[int] = []
        if not self.continuing_subword_prefix and not self.end_of_word_suffix:
            # a word's symbols are its in-alphabet chars
            g = word_to_id.get
            for word, count in wc.items():
                counts.append(count)
                current = [i for i in map(g, word) if i is not None]
                words.append((current, [1] * len(current)))
            return words, counts
        for word, count in wc.items():
            current: List[int] = []
            counts.append(count)
            n = len(word)
            for k, c in enumerate(word):
                s = c
                if s in word_to_id:
                    if k != 0 and self.continuing_subword_prefix:
                        s = self.continuing_subword_prefix + s
                    if k == n - 1 and self.end_of_word_suffix:
                        s = s + self.end_of_word_suffix
                    if s not in word_to_id:
                        id_to_word.append(s)
                        word_to_id[s] = len(id_to_word) - 1
                    current.append(word_to_id[s])
            # every symbol starts one char long (trainer.rs:361); the lengths
            # gate max_token_length
            words.append((current, [1] * len(current)))
        return words, counts


def _merge_word_inplace(
    word: List[int],
    lens: List[int],
    c1: int,
    c2: int,
    replacement: int,
    max_length: int,
) -> List[Tuple[Tuple[int, int], int]]:
    """Merge every occurrence of (c1, c2) in `word`, left to right, and
    return the pair-count deltas: left neighbours in the merged state,
    right ones in the unmerged state, new pairs only while their length
    stays under `max_length` (reference `models/bpe/word.rs:107-160`)."""
    changes: List[Tuple[Tuple[int, int], int]] = []
    i = 0
    while i < len(word):
        if word[i] == c1 and i + 1 < len(word) and word[i + 1] == c2:
            new_len = lens[i] + lens[i + 1]
            if i > 0:
                changes.append(((word[i - 1], c1), -1))
                if lens[i - 1] + new_len < max_length:
                    changes.append(((word[i - 1], replacement), 1))
            word[i] = replacement
            lens[i] = new_len
            del word[i + 1]
            del lens[i + 1]
            if i < len(word) - 1:
                changes.append(((c2, word[i + 1]), -1))
                if lens[i + 1] + new_len < max_length:
                    changes.append(((replacement, word[i + 1]), 1))
        i += 1
    return changes
