"""WordLevelTrainer: count the words, drop those under `min_frequency`,
and take them by count desc, then by word, after the special tokens, up to
`vocab_size`; copy of `tokenizers_tpu.trainers.wordlevel_trainer`
(reference `models/wordlevel/trainer.rs`).  Host only: no device work."""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional

from .bpe_trainer import AddedToken, special_tokens_of


class WordLevelTrainer:
    def __init__(
        self,
        vocab_size: int = 30000,
        min_frequency: int = 0,
        show_progress: bool = True,
        special_tokens: Optional[List] = None,
    ):
        self.vocab_size = vocab_size
        self.min_frequency = min_frequency
        self.show_progress = show_progress
        self.special_tokens = special_tokens_of(special_tokens)
        self.words: Dict[str, int] = {}
        self.stats: Dict[str, object] = {}

    def feed(self, iterator: Iterable[str], process: Callable[[str], List[str]],
             count_chunks=None) -> None:
        """Count the words serially, as the JAX package's feed
        (`count_chunks`, the Tokenizer's pool map, is not used)."""
        t = time.perf_counter()
        words = self.words
        for sequence in iterator:
            for word in process(sequence):
                words[word] = words.get(word, 0) + 1
        self.stats["feed_s"] = self.stats.get("feed_s", 0.0) + time.perf_counter() - t
        self.stats["words"] = len(words)

    def train(self, model) -> List[AddedToken]:
        """Give `model` (a port `models.wordlevel.WordLevel`) the vocab."""
        t = time.perf_counter()
        ordered = sorted(self.words.items(), key=lambda kv: (-kv[1], kv[0]))
        vocab: Dict[str, int] = {}
        for token in self.special_tokens:
            if token.content not in vocab:
                vocab[token.content] = len(vocab)
        for word, count in ordered:
            if count < self.min_frequency:
                continue
            if len(vocab) >= self.vocab_size:
                break
            if word not in vocab:
                vocab[word] = len(vocab)
        model.vocab = vocab
        model.vocab_r = {v: k for k, v in vocab.items()}
        self.stats.update(path="host", train_s=time.perf_counter() - t)
        return list(self.special_tokens)
