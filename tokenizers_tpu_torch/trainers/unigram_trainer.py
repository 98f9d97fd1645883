"""UnigramTrainer: SentencePiece-style EM training; copy of
`tokenizers_tpu.trainers.unigram_trainer` (reference
`models/unigram/trainer.rs`) with a `device` beside its `mesh`.  The
configuration and the word counts live here; `trainers/unigram_em.py`
trains.  `train` runs the E-step and the pruning statistics on the
trainer's `device` (the card unless the caller asks for `device="cpu"`),
sharded over `mesh` (a `DeviceMesh`; every rank trains on the same words)
when one is given; `do_train_host` runs them on the host lattices (the
oracle)."""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional, Set

from .bpe_trainer import AddedToken, special_tokens_of


class UnigramTrainer:
    def __init__(
        self,
        vocab_size: int = 8000,
        show_progress: bool = True,
        special_tokens: Optional[List] = None,
        initial_alphabet: Optional[Set[str]] = None,
        shrinking_factor: float = 0.75,
        unk_token: Optional[str] = None,
        max_piece_length: int = 16,
        n_sub_iterations: int = 2,
        seed_size: int = 1_000_000,
        mesh=None,
        device=None,
    ):
        self.vocab_size = vocab_size
        self.show_progress = show_progress  # accepted for the reference's surface; no bar
        self.special_tokens = special_tokens_of(special_tokens)
        self.initial_alphabet = set(initial_alphabet or [])
        self.shrinking_factor = shrinking_factor
        self.unk_token = unk_token
        self.max_piece_length = max_piece_length
        self.n_sub_iterations = n_sub_iterations
        self.seed_size = seed_size
        self.device = device
        self.mesh = mesh
        self.words: Dict[str, int] = {}
        # what the last feed and train did: seconds of each part, host routes, ...
        self.stats: Dict[str, object] = {}

    def feed(self, iterator: Iterable[str], process: Callable[[str], List[str]],
             count_chunks=None) -> None:
        """Count the words `process` gives for each sequence, serially in
        this process (as the JAX package's feed: `count_chunks`, the
        Tokenizer's pool map, is not used), in first-occurrence order."""
        t = time.perf_counter()
        local: Counter = Counter()
        for sequence in iterator:
            local.update(process(sequence))
        words = self.words
        for w, c in local.items():
            words[w] = words.get(w, 0) + c
        self.stats["feed_s"] = self.stats.get("feed_s", 0.0) + time.perf_counter() - t
        self.stats["words"] = len(words)

    def train(self, model) -> List[AddedToken]:
        """Train `model` (a port Unigram) on the fed words, the E-step and
        the pruning statistics on the trainer's device."""
        from .unigram_em import do_train

        return do_train(self, self.words, model, device=self.device, mesh=self.mesh)

    def do_train_host(self, word_counts: Dict[str, int], model) -> List[AddedToken]:
        """`train` with every pass on the host lattices."""
        from .unigram_em import do_train

        return do_train(self, word_counts, model, host=True)
