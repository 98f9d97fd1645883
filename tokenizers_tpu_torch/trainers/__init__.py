"""Trainers: BPE (on the device), WordPiece (BPE with the `##` prefix, on
the device) and WordLevel (host).  Unigram training waits for a later
slice of the port."""

from .bpe_trainer import AddedToken, BpeTrainer
from .wordlevel_trainer import WordLevelTrainer
from .wordpiece_trainer import WordPieceTrainer

__all__ = ["AddedToken", "BpeTrainer", "WordLevelTrainer", "WordPieceTrainer"]
