"""SentencePieceBPETokenizer: BPE over Metaspace pieces, NFKC; port of
`tokenizers_tpu.implementations.sentencepiece_bpe` (reference
`implementations/sentencepiece_bpe.py`)."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

from ..added_vocabulary import AddedToken
from ..models.bpe import BPE
from ..normalizers import NFKC
from ..pre_tokenizers.metaspace import Metaspace
from ..tokenizer import Tokenizer
from ..trainers.bpe_trainer import BpeTrainer
from .base_tokenizer import BaseTokenizer


class SentencePieceBPETokenizer(BaseTokenizer):
    def __init__(self, vocab: Optional[Union[str, Dict[str, int]]] = None,
                 merges: Optional[Union[str, List[Tuple[str, str]]]] = None,
                 unk_token: Union[str, AddedToken] = "<unk>", replacement: str = "▁",
                 add_prefix_space: bool = True, dropout: Optional[float] = None,
                 fuse_unk: Optional[bool] = False, device=None):
        if isinstance(vocab, str) and isinstance(merges, str):
            vocab, merges = BPE.read_file(vocab, merges)
        if vocab is not None and merges is not None:
            model = BPE(vocab, merges, dropout=dropout, unk_token=str(unk_token),
                        fuse_unk=fuse_unk)
        else:
            model = BPE(dropout=dropout, unk_token=str(unk_token), fuse_unk=fuse_unk)
        tokenizer = Tokenizer(model, device=device)
        if tokenizer.token_to_id(str(unk_token)) is not None:
            tokenizer.add_special_tokens([str(unk_token)])
        tokenizer.normalizer = NFKC()
        scheme = "always" if add_prefix_space else "never"
        tokenizer.pre_tokenizer = Metaspace(replacement, scheme)
        tokenizer.decoder = Metaspace(replacement, scheme)
        super().__init__(tokenizer, {
            "model": "SentencePieceBPE", "unk_token": unk_token, "replacement": replacement,
            "add_prefix_space": add_prefix_space, "dropout": dropout})

    @staticmethod
    def from_file(vocab_filename: str, merges_filename: str, **kwargs):
        vocab, merges = BPE.read_file(vocab_filename, merges_filename)
        return SentencePieceBPETokenizer(vocab, merges, **kwargs)

    def _trainer(self, vocab_size, min_frequency, special_tokens, limit_alphabet,
                 initial_alphabet, show_progress):
        return BpeTrainer(vocab_size=vocab_size, min_frequency=min_frequency,
                          special_tokens=special_tokens, limit_alphabet=limit_alphabet,
                          initial_alphabet=set(initial_alphabet), show_progress=show_progress,
                          device=self.device)

    def train(self, files: Union[str, List[str]], vocab_size: int = 30000,
              min_frequency: int = 2, special_tokens: List[Union[str, AddedToken]] = ["<unk>"],
              limit_alphabet: int = 1000, initial_alphabet: List[str] = [],
              show_progress: bool = True):
        trainer = self._trainer(vocab_size, min_frequency, special_tokens, limit_alphabet,
                                initial_alphabet, show_progress)
        self._tokenizer.train([files] if isinstance(files, str) else files, trainer=trainer)

    def train_from_iterator(self, iterator: Iterator[str], vocab_size: int = 30000,
                            min_frequency: int = 2,
                            special_tokens: List[Union[str, AddedToken]] = ["<unk>"],
                            limit_alphabet: int = 1000, initial_alphabet: List[str] = [],
                            show_progress: bool = True, length: Optional[int] = None):
        trainer = self._trainer(vocab_size, min_frequency, special_tokens, limit_alphabet,
                                initial_alphabet, show_progress)
        self._tokenizer.train_from_iterator(iterator, trainer=trainer, length=length)
