"""Models of the host path: BPE, WordPiece, WordLevel and Unigram.

`Model` is the JAX package's base interface.  Each model defines
`tokenize_spans(word)`, the fast host path's call: (id, start, end) or
(id, start, end, value) of each token of one pre-tokenized word, the
span in chars for WordPiece and for a BPE without `byte_spans`, else in
UTF-8 bytes; and `tokenize_ids(word)`, the ids alone.  `tokenize`
builds the JAX package's `Token`s from the spans (a BPE asks for them
in bytes): id, value and offsets in the word's UTF-8 bytes.  The
engines and the fast host path never build a `Token`; the general host
pipeline and the public API do."""

from __future__ import annotations

from typing import Dict, List, Optional

from ..pretokenized import Token


class Model:
    """Base interface (reference `tokenizers/src/tokenizer/mod.rs:70-90`)."""

    def tokenize(self, sequence: str) -> List[Token]:
        """The `Token`s of one pre-tokenized word, offsets in its UTF-8
        bytes (a WordPiece's spans are in chars)."""
        from ..normalized import char_to_byte_offsets
        from .wordpiece import WordPiece

        spans = self.tokenize_spans(sequence)
        if not spans:
            return []
        vr = self.vocab_r
        cb = (char_to_byte_offsets(sequence)
              if isinstance(self, WordPiece) and not sequence.isascii() else None)
        out = []
        for t in spans:
            s, e = (t[1], t[2]) if cb is None else (cb[t[1]], cb[t[2]])
            out.append(Token(t[0], t[3] if len(t) > 3 else vr[t[0]], (s, e)))
        return out

    def tokenize_spans(self, word: str) -> list:
        raise NotImplementedError

    def tokenize_ids(self, word: str) -> List[int]:
        return [t[0] for t in self.tokenize_spans(word)]

    def token_to_id(self, token: str) -> Optional[int]:
        raise NotImplementedError

    def id_to_token(self, id: int) -> Optional[str]:
        raise NotImplementedError

    def get_vocab(self) -> Dict[str, int]:
        raise NotImplementedError

    def get_vocab_size(self) -> int:
        return len(self.get_vocab())

    def save(self, folder: str, prefix: Optional[str] = None) -> List[str]:
        raise NotImplementedError

    def get_trainer(self):
        raise NotImplementedError


from .bpe import BPE  # noqa: E402
from .wordpiece import WordPiece  # noqa: E402
from .wordlevel import WordLevel  # noqa: E402
from .unigram import Unigram  # noqa: E402

__all__ = ["Model", "BPE", "WordPiece", "WordLevel", "Unigram"]
