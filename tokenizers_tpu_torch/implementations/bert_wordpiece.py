"""BertWordPieceTokenizer: BERT's WordPiece with BertProcessing; port of
`tokenizers_tpu.implementations.bert_wordpiece` (reference
`implementations/bert_wordpiece.py:12`).  `[CLS]`/`[SEP]` are wired by
BertProcessing only when a vocab is given at construction, as in the
reference."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Union

from ..added_vocabulary import AddedToken
from ..decoders import WordPiece as WordPieceDecoder
from ..models.wordpiece import WordPiece
from ..normalizers.bert import BertNormalizer
from ..pre_tokenizers.bert import BertPreTokenizer
from ..processors import BertProcessing
from ..tokenizer import Tokenizer
from ..trainers.wordpiece_trainer import WordPieceTrainer
from .base_tokenizer import BaseTokenizer


class BertWordPieceTokenizer(BaseTokenizer):
    def __init__(self, vocab: Optional[Union[str, Dict[str, int]]] = None,
                 unk_token: Union[str, AddedToken] = "[UNK]",
                 sep_token: Union[str, AddedToken] = "[SEP]",
                 cls_token: Union[str, AddedToken] = "[CLS]",
                 pad_token: Union[str, AddedToken] = "[PAD]",
                 mask_token: Union[str, AddedToken] = "[MASK]", clean_text: bool = True,
                 handle_chinese_chars: bool = True, strip_accents: Optional[bool] = None,
                 lowercase: bool = True, wordpieces_prefix: str = "##", device=None):
        if isinstance(vocab, str):
            vocab = WordPiece.read_file(vocab)
        model = WordPiece(vocab or {}, unk_token=str(unk_token),
                          continuing_subword_prefix=wordpieces_prefix)
        tokenizer = Tokenizer(model, device=device)
        for tok in (unk_token, sep_token, cls_token, pad_token, mask_token):
            if tokenizer.token_to_id(str(tok)) is not None:
                tokenizer.add_special_tokens([str(tok)])
        tokenizer.normalizer = BertNormalizer(clean_text=clean_text,
                                              handle_chinese_chars=handle_chinese_chars,
                                              strip_accents=strip_accents, lowercase=lowercase)
        tokenizer.pre_tokenizer = BertPreTokenizer()
        if vocab:
            sep_id = tokenizer.token_to_id(str(sep_token))
            cls_id = tokenizer.token_to_id(str(cls_token))
            if sep_id is None:
                raise TypeError("sep_token not found in the vocabulary")
            if cls_id is None:
                raise TypeError("cls_token not found in the vocabulary")
            tokenizer.post_processor = BertProcessing((str(sep_token), sep_id),
                                                      (str(cls_token), cls_id))
        tokenizer.decoder = WordPieceDecoder(prefix=wordpieces_prefix)
        super().__init__(tokenizer, {
            "model": "BertWordPiece", "unk_token": unk_token, "sep_token": sep_token,
            "cls_token": cls_token, "pad_token": pad_token, "mask_token": mask_token,
            "clean_text": clean_text, "handle_chinese_chars": handle_chinese_chars,
            "strip_accents": strip_accents, "lowercase": lowercase,
            "wordpieces_prefix": wordpieces_prefix})

    @staticmethod
    def from_file(vocab: str, **kwargs) -> "BertWordPieceTokenizer":
        return BertWordPieceTokenizer(WordPiece.read_file(vocab), **kwargs)

    def _trainer(self, vocab_size, min_frequency, limit_alphabet, initial_alphabet,
                 special_tokens, show_progress, wordpieces_prefix):
        return WordPieceTrainer(vocab_size=vocab_size, min_frequency=min_frequency,
                                limit_alphabet=limit_alphabet,
                                initial_alphabet=set(initial_alphabet),
                                special_tokens=special_tokens, show_progress=show_progress,
                                continuing_subword_prefix=wordpieces_prefix, device=self.device)

    def train(self, files: Union[str, List[str]], vocab_size: int = 30000,
              min_frequency: int = 2, limit_alphabet: int = 1000,
              initial_alphabet: List[str] = [],
              special_tokens: List[Union[str, AddedToken]] = ["[PAD]", "[UNK]", "[CLS]",
                                                              "[SEP]", "[MASK]"],
              show_progress: bool = True, wordpieces_prefix: str = "##"):
        trainer = self._trainer(vocab_size, min_frequency, limit_alphabet, initial_alphabet,
                                special_tokens, show_progress, wordpieces_prefix)
        self._tokenizer.train([files] if isinstance(files, str) else files, trainer=trainer)

    def train_from_iterator(self, iterator: Iterator[str], vocab_size: int = 30000,
                            min_frequency: int = 2, limit_alphabet: int = 1000,
                            initial_alphabet: List[str] = [],
                            special_tokens: List[Union[str, AddedToken]] = [
                                "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
                            show_progress: bool = True, wordpieces_prefix: str = "##",
                            length: Optional[int] = None):
        trainer = self._trainer(vocab_size, min_frequency, limit_alphabet, initial_alphabet,
                                special_tokens, show_progress, wordpieces_prefix)
        self._tokenizer.train_from_iterator(iterator, trainer=trainer, length=length)
