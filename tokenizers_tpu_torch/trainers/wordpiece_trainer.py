"""WordPieceTrainer: BPE training with the `##` continuing-subword prefix,
whose vocab becomes a WordPiece model's; copy of
`tokenizers_tpu.trainers.wordpiece_trainer` (reference
`models/wordpiece/trainer.rs`).  It trains on the device as `BpeTrainer`
does."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Set

from .bpe_trainer import AddedToken, BpeTrainer


class WordPieceTrainer:
    def __init__(
        self,
        vocab_size: int = 30000,
        min_frequency: int = 0,
        show_progress: bool = True,
        special_tokens: Optional[List] = None,
        limit_alphabet: Optional[int] = None,
        initial_alphabet: Optional[Set[str]] = None,
        continuing_subword_prefix: str = "##",
        end_of_word_suffix: Optional[str] = None,
        device=None,
    ):
        self.bpe_trainer = BpeTrainer(
            vocab_size=vocab_size,
            min_frequency=min_frequency,
            show_progress=show_progress,
            special_tokens=special_tokens,
            limit_alphabet=limit_alphabet,
            initial_alphabet=initial_alphabet,
            continuing_subword_prefix=continuing_subword_prefix,
            end_of_word_suffix=end_of_word_suffix,
            device=device,
        )

    @property
    def vocab_size(self):
        return self.bpe_trainer.vocab_size

    @property
    def special_tokens(self):
        return self.bpe_trainer.special_tokens

    @property
    def words(self):
        return self.bpe_trainer.words

    @property
    def stats(self):
        return self.bpe_trainer.stats

    def feed(self, iterator: Iterable[str], process: Callable[[str], List[str]],
             count_chunks=None) -> None:
        self.bpe_trainer.feed(iterator, process, count_chunks)

    def train(self, model) -> List[AddedToken]:
        """Train a BPE on the device and give `model` (a port
        `models.wordpiece.WordPiece`) its vocab and prefix."""
        from ..models.bpe import BPE

        t = self.bpe_trainer
        bpe = BPE({}, [], continuing_subword_prefix=t.continuing_subword_prefix,
                  end_of_word_suffix=t.end_of_word_suffix)
        special_tokens = t.train(bpe)
        model.vocab = dict(bpe.vocab)
        model.vocab_r = {v: k for k, v in model.vocab.items()}
        if t.continuing_subword_prefix is not None:
            model.continuing_subword_prefix = t.continuing_subword_prefix
        return special_tokens
