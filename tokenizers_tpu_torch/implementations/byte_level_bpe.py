"""ByteLevelBPETokenizer: GPT-2's byte-level BPE; port of
`tokenizers_tpu.implementations.byte_level_bpe` (reference
`implementations/byte_level_bpe.py`).  With its defaults it is the
pipeline of the port's byte-level engine (B3, B2 and B1 on the card);
with `lowercase`, `unicode_normalizer` (a normalizer before the
byte-level model) or `dropout` it runs the general host pipeline, as in
the JAX package."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

from ..added_vocabulary import AddedToken
from ..decoders import ByteLevel as ByteLevelDecoder
from ..models.bpe import BPE
from ..normalizers import Lowercase
from ..normalizers import Sequence as NormSequence
from ..pre_tokenizers.byte_level import ByteLevel
from ..processors import ByteLevel as ByteLevelProcessor
from ..tokenizer import Tokenizer
from ..trainers.bpe_trainer import BpeTrainer
from .base_tokenizer import BaseTokenizer
from .util import unicode_normalizer_from_str


class ByteLevelBPETokenizer(BaseTokenizer):
    def __init__(self, vocab: Optional[Union[str, Dict[str, int]]] = None,
                 merges: Optional[Union[str, List[Tuple[str, str]]]] = None,
                 add_prefix_space: bool = False, lowercase: bool = False,
                 dropout: Optional[float] = None, unicode_normalizer: Optional[str] = None,
                 continuing_subword_prefix: Optional[str] = None,
                 end_of_word_suffix: Optional[str] = None, trim_offsets: bool = False,
                 device=None):
        if isinstance(vocab, str) and isinstance(merges, str):
            vocab, merges = BPE.read_file(vocab, merges)
        if vocab is not None and merges is not None:
            model = BPE(vocab, merges, dropout=dropout,
                        continuing_subword_prefix=continuing_subword_prefix or "",
                        end_of_word_suffix=end_of_word_suffix or "")
        else:
            model = BPE()
        tokenizer = Tokenizer(model, device=device)
        norms = [unicode_normalizer_from_str(unicode_normalizer)] if unicode_normalizer else []
        norms += [Lowercase()] if lowercase else []
        if norms:
            tokenizer.normalizer = norms[0] if len(norms) == 1 else NormSequence(norms)
        tokenizer.pre_tokenizer = ByteLevel(add_prefix_space=add_prefix_space)
        tokenizer.decoder = ByteLevelDecoder()
        tokenizer.post_processor = ByteLevelProcessor(trim_offsets=trim_offsets)
        super().__init__(tokenizer, {
            "model": "ByteLevelBPE", "add_prefix_space": add_prefix_space,
            "lowercase": lowercase, "dropout": dropout, "unicode_normalizer": unicode_normalizer,
            "continuing_subword_prefix": continuing_subword_prefix,
            "end_of_word_suffix": end_of_word_suffix, "trim_offsets": trim_offsets})

    @staticmethod
    def from_file(vocab_filename: str, merges_filename: str, **kwargs):
        vocab, merges = BPE.read_file(vocab_filename, merges_filename)
        return ByteLevelBPETokenizer(vocab, merges, **kwargs)

    def _trainer(self, vocab_size, min_frequency, show_progress, special_tokens):
        return BpeTrainer(vocab_size=vocab_size, min_frequency=min_frequency,
                          show_progress=show_progress, special_tokens=special_tokens,
                          initial_alphabet=ByteLevel.alphabet(), device=self.device)

    def train(self, files: Union[str, List[str]], vocab_size: int = 30000,
              min_frequency: int = 2, show_progress: bool = True,
              special_tokens: List[Union[str, AddedToken]] = []):
        trainer = self._trainer(vocab_size, min_frequency, show_progress, special_tokens)
        self._tokenizer.train([files] if isinstance(files, str) else files, trainer=trainer)

    def train_from_iterator(self, iterator: Iterator[str], vocab_size: int = 30000,
                            min_frequency: int = 2, show_progress: bool = True,
                            special_tokens: List[Union[str, AddedToken]] = [],
                            length: Optional[int] = None):
        trainer = self._trainer(vocab_size, min_frequency, show_progress, special_tokens)
        self._tokenizer.train_from_iterator(iterator, trainer=trainer, length=length)
