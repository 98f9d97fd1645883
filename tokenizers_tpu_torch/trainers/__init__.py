"""Trainers: BPE (on the device), WordPiece (BPE with the `##` prefix, on
the device), WordLevel (host) and Unigram (EM: the E-step and the pruning
statistics on the device)."""

from .bpe_trainer import AddedToken, BpeTrainer
from .unigram_trainer import UnigramTrainer
from .wordlevel_trainer import WordLevelTrainer
from .wordpiece_trainer import WordPieceTrainer

__all__ = ["AddedToken", "BpeTrainer", "UnigramTrainer", "WordLevelTrainer", "WordPieceTrainer"]
