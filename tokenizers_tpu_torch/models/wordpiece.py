"""WordPiece model of the host path; copy of
`tokenizers_tpu.models.wordpiece` (reference
`models/wordpiece/mod.rs:224-283`): greedy longest match from each
char position, the continuation prefix (`##`) on every token but a
word's first, and the whole word as `[UNK]` when some position has no
match or the word has more than `max_input_chars_per_word` chars."""

from __future__ import annotations

from typing import Dict, List, Tuple


class WordPiece:
    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##",
                 max_input_chars_per_word: int = 100):
        self.vocab: Dict[str, int] = dict(vocab)
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

    def tokenize(self, word: str) -> List[int]:
        """The ids of one pre-tokenized word."""
        return [t for t, _s, _e in self.tokenize_spans(word)]

    def get_trainer(self, device=None):
        from ..trainers.wordpiece_trainer import WordPieceTrainer

        return WordPieceTrainer(device=device)

