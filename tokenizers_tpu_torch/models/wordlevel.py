"""WordLevel model of the host path; copy of
`tokenizers_tpu.models.wordlevel` (reference
`models/wordlevel/mod.rs:162-186`): each pre-tokenized word is one token,
its vocab id, or the unk token's when it is not in the vocab."""

from __future__ import annotations

from typing import Dict, List, Tuple


class WordLevel:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "<unk>"):
        self.vocab: Dict[str, int] = dict(vocab)
        self.vocab_r: Dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.unk_token = unk_token

    def tokenize_spans(self, word: str) -> List[Tuple[int, int, int]]:
        """[(id, 0, byte length of the word)], or [] for an empty word."""
        if not word:
            return []
        tid = self.vocab.get(word)
        if tid is None:
            tid = self.vocab.get(self.unk_token)
            if tid is None:
                raise ValueError(f"Missing unk token from the vocabulary: {self.unk_token!r}")
        return [(tid, 0, len(word.encode("utf-8")))]

    def tokenize(self, word: str) -> List[int]:
        return [t for t, _s, _e in self.tokenize_spans(word)]

    def get_trainer(self, device=None):
        """A WordLevelTrainer (host only: `device` is not used)."""
        from ..trainers.wordlevel_trainer import WordLevelTrainer

        return WordLevelTrainer()
