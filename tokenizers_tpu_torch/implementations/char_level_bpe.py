"""CharBPETokenizer: Sennrich-style char BPE with a `</w>` suffix; port of
`tokenizers_tpu.implementations.char_level_bpe` (reference
`implementations/char_level_bpe.py`)."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

from ..added_vocabulary import AddedToken
from ..decoders import BPEDecoder
from ..models.bpe import BPE
from ..normalizers import Lowercase
from ..normalizers import Sequence as NormSequence
from ..normalizers.bert import BertNormalizer
from ..pre_tokenizers.bert import BertPreTokenizer
from ..pre_tokenizers.whitespace import WhitespaceSplit
from ..tokenizer import Tokenizer
from ..trainers.bpe_trainer import BpeTrainer
from .base_tokenizer import BaseTokenizer
from .util import unicode_normalizer_from_str


class CharBPETokenizer(BaseTokenizer):
    def __init__(self, vocab: Optional[Union[str, Dict[str, int]]] = None,
                 merges: Optional[Union[str, List[Tuple[str, str]]]] = None,
                 unk_token: Union[str, AddedToken] = "<unk>", suffix: str = "</w>",
                 dropout: Optional[float] = None, lowercase: bool = False,
                 unicode_normalizer: Optional[str] = None, bert_normalizer: bool = True,
                 split_on_whitespace_only: bool = False, device=None):
        if isinstance(vocab, str) and isinstance(merges, str):
            vocab, merges = BPE.read_file(vocab, merges)
        if vocab is not None and merges is not None:
            model = BPE(vocab, merges, dropout=dropout, unk_token=str(unk_token),
                        end_of_word_suffix=suffix)
        else:
            model = BPE(unk_token=str(unk_token), dropout=dropout, end_of_word_suffix=suffix)
        tokenizer = Tokenizer(model, device=device)
        if tokenizer.token_to_id(str(unk_token)) is not None:
            tokenizer.add_special_tokens([str(unk_token)])
        norms = []
        if unicode_normalizer:
            norms.append(unicode_normalizer_from_str(unicode_normalizer))
        if bert_normalizer:
            norms.append(BertNormalizer(lowercase=False))
        if lowercase:
            norms.append(Lowercase())
        if norms:
            tokenizer.normalizer = norms[0] if len(norms) == 1 else NormSequence(norms)
        tokenizer.pre_tokenizer = WhitespaceSplit() if split_on_whitespace_only \
            else BertPreTokenizer()
        tokenizer.decoder = BPEDecoder(suffix=suffix)
        super().__init__(tokenizer, {
            "model": "BPE", "unk_token": unk_token, "suffix": suffix, "dropout": dropout,
            "lowercase": lowercase, "unicode_normalizer": unicode_normalizer,
            "bert_normalizer": bert_normalizer,
            "split_on_whitespace_only": split_on_whitespace_only})

    @staticmethod
    def from_file(vocab_filename: str, merges_filename: str, **kwargs):
        vocab, merges = BPE.read_file(vocab_filename, merges_filename)
        return CharBPETokenizer(vocab, merges, **kwargs)

    def _trainer(self, vocab_size, min_frequency, special_tokens, limit_alphabet,
                 initial_alphabet, suffix, show_progress):
        return BpeTrainer(vocab_size=vocab_size, min_frequency=min_frequency,
                          special_tokens=special_tokens, limit_alphabet=limit_alphabet,
                          initial_alphabet=set(initial_alphabet), end_of_word_suffix=suffix,
                          show_progress=show_progress, device=self.device)

    def train(self, files: Union[str, List[str]], vocab_size: int = 30000,
              min_frequency: int = 2, special_tokens: List[Union[str, AddedToken]] = ["<unk>"],
              limit_alphabet: int = 1000, initial_alphabet: List[str] = [],
              suffix: Optional[str] = "</w>", show_progress: bool = True):
        trainer = self._trainer(vocab_size, min_frequency, special_tokens, limit_alphabet,
                                initial_alphabet, suffix, show_progress)
        self._tokenizer.train([files] if isinstance(files, str) else files, trainer=trainer)

    def train_from_iterator(self, iterator: Iterator[str], vocab_size: int = 30000,
                            min_frequency: int = 2,
                            special_tokens: List[Union[str, AddedToken]] = ["<unk>"],
                            limit_alphabet: int = 1000, initial_alphabet: List[str] = [],
                            suffix: Optional[str] = "</w>", show_progress: bool = True,
                            length: Optional[int] = None):
        trainer = self._trainer(vocab_size, min_frequency, special_tokens, limit_alphabet,
                                initial_alphabet, suffix, show_progress)
        self._tokenizer.train_from_iterator(iterator, trainer=trainer, length=length)
