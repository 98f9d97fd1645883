"""WordPiece model of the host path; copy of
`tokenizers_tpu.models.wordpiece` (reference
`models/wordpiece/mod.rs:224-283`): greedy longest match from each
char position, the continuation prefix (`##`) on every token but a
word's first, and the whole word as `[UNK]` when some position has no
match or the word has more than `max_input_chars_per_word` chars."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from . import Model


class WordPiece(Model):
    def __init__(self, vocab: Optional[Dict[str, int]] = None, unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##",
                 max_input_chars_per_word: int = 100):
        self.vocab: Dict[str, int] = dict(vocab or {})
        self.vocab_r: Dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.unk_token = unk_token
        self.continuing_subword_prefix = continuing_subword_prefix
        self.max_input_chars_per_word = max_input_chars_per_word

    def _unk(self, n: int) -> List[Tuple[int, int, int]]:
        unk_id = self.vocab.get(self.unk_token)
        if unk_id is None:
            raise ValueError(f"Missing [UNK] token from the vocabulary: {self.unk_token!r}")
        return [(unk_id, 0, n)]

    def tokenize_spans(self, word: str) -> List[Tuple[int, int, int]]:
        """(id, start, end) of each token of one pre-tokenized word, the
        span in chars of the word."""
        n = len(word)
        if n == 0:
            return []
        if n > self.max_input_chars_per_word:
            return self._unk(n)
        out = []
        start = 0
        while start < n:
            end = n
            while end > start:
                sub = word[start:end]
                tid = self.vocab.get(self.continuing_subword_prefix + sub if start else sub)
                if tid is not None:
                    break
                end -= 1
            if end == start:
                return self._unk(n)
            out.append((tid, start, end))
            start = end
        return out


    def get_trainer(self, device=None):
        from ..trainers.wordpiece_trainer import WordPieceTrainer

        return WordPieceTrainer(device=device)

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
        """The vocab of a `vocab.txt`: one token a line, its id the line's
        index."""
        vocab: Dict[str, int] = {}
        with open(vocab_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return vocab

    @classmethod
    def from_file(cls, vocab_path: str, **kwargs) -> "WordPiece":
        return cls(cls.read_file(vocab_path), **kwargs)

    @classmethod
    def from_bpe(cls, bpe) -> "WordPiece":
        """A WordPiece over `bpe`'s vocab, its unk token and prefix (or
        `[UNK]` and `##`)."""
        return cls(bpe.get_vocab(), unk_token=bpe.unk_token or "[UNK]",
                   continuing_subword_prefix=bpe.continuing_subword_prefix or "##")

    def save(self, folder: str, prefix: Optional[str] = None) -> List[str]:
        """Write `[prefix-]vocab.txt`, the tokens by id; the path."""
        path = os.path.join(folder, f"{prefix}-vocab.txt" if prefix else "vocab.txt")
        with open(path, "w", encoding="utf-8") as f:
            for i in sorted(self.vocab_r):
                f.write(self.vocab_r[i] + "\n")
        return [path]
