"""SentencePieceUnigramTokenizer: Unigram over Metaspace pieces, with Nmt,
NFKC and the `" {2,}"` space collapse; port of
`tokenizers_tpu.implementations.sentencepiece_unigram` (reference
`implementations/sentencepiece_unigram.py`).  Trained without
`unk_token`, it has no unk id: it runs the general host pipeline, and
an encode meeting a char outside its pieces raises, as in the JAX
package."""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple, Union

from ..added_vocabulary import AddedToken
from ..models.unigram import Unigram
from ..normalizers import NFKC, Nmt, Replace
from ..normalizers import Sequence as NormSequence
from ..pre_tokenizers.metaspace import Metaspace
from ..tokenizer import Tokenizer
from ..trainers.unigram_trainer import UnigramTrainer
from .base_tokenizer import BaseTokenizer


class SentencePieceUnigramTokenizer(BaseTokenizer):
    def __init__(self, vocab: Optional[List[Tuple[str, float]]] = None,
                 replacement: str = "▁", add_prefix_space: bool = True, device=None):
        tokenizer = Tokenizer(Unigram(vocab) if vocab is not None else Unigram(), device=device)
        tokenizer.normalizer = NormSequence([Nmt(), NFKC(), Replace(" {2,}", " ", regex=True)])
        scheme = "always" if add_prefix_space else "never"
        tokenizer.pre_tokenizer = Metaspace(replacement, scheme)
        tokenizer.decoder = Metaspace(replacement, scheme)
        super().__init__(tokenizer, {"model": "SentencePieceUnigram",
                                     "replacement": replacement,
                                     "add_prefix_space": add_prefix_space})

    def _trainer(self, vocab_size, show_progress, special_tokens, initial_alphabet, unk_token):
        return UnigramTrainer(vocab_size=vocab_size, special_tokens=special_tokens or [],
                              show_progress=show_progress,
                              initial_alphabet=set(initial_alphabet or []), unk_token=unk_token,
                              device=self.device)

    def train(self, files: Union[str, List[str]], vocab_size: int = 8000,
              show_progress: bool = True,
              special_tokens: Optional[List[Union[str, AddedToken]]] = None,
              initial_alphabet: Optional[List[str]] = None, unk_token: Optional[str] = None):
        trainer = self._trainer(vocab_size, show_progress, special_tokens, initial_alphabet,
                                unk_token)
        self._tokenizer.train([files] if isinstance(files, str) else files, trainer=trainer)

    def train_from_iterator(self, iterator: Iterator[str], vocab_size: int = 8000,
                            show_progress: bool = True,
                            special_tokens: Optional[List[Union[str, AddedToken]]] = None,
                            initial_alphabet: Optional[List[str]] = None,
                            unk_token: Optional[str] = None, length: Optional[int] = None):
        trainer = self._trainer(vocab_size, show_progress, special_tokens, initial_alphabet,
                                unk_token)
        self._tokenizer.train_from_iterator(iterator, trainer=trainer, length=length)
