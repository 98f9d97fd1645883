"""WordLevel model of the host path; copy of
`tokenizers_tpu.models.wordlevel` (reference
`models/wordlevel/mod.rs:162-186`): each pre-tokenized word is one token,
its vocab id, or the unk token's when it is not in the vocab."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from . import Model


class WordLevel(Model):
    def __init__(self, vocab: Optional[Dict[str, int]] = None, unk_token: str = "<unk>"):
        self.vocab: Dict[str, int] = dict(vocab or {})
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

    def get_trainer(self, device=None):
        """A WordLevelTrainer (host only: `device` is not used)."""
        from ..trainers.wordlevel_trainer import WordLevelTrainer

        return WordLevelTrainer()

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def id_to_token(self, id: int) -> Optional[str]:
        return self.vocab_r.get(id)

    def get_vocab(self) -> Dict[str, int]:
        return dict(self.vocab)

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    @staticmethod
    def read_file(vocab_path: str) -> Dict[str, int]:
        """The vocab of a `vocab.json`."""
        with open(vocab_path, "r", encoding="utf-8") as f:
            return json.load(f)

    @classmethod
    def from_file(cls, vocab_path: str, **kwargs) -> "WordLevel":
        return cls(cls.read_file(vocab_path), **kwargs)

    def save(self, folder: str, prefix: Optional[str] = None) -> List[str]:
        """Write `[prefix-]vocab.json`, the tokens by id; the path."""
        path = os.path.join(folder, f"{prefix}-vocab.json" if prefix else "vocab.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({self.vocab_r[i]: i for i in sorted(self.vocab_r)}, f, ensure_ascii=False)
        return [path]
