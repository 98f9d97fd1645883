"""The five recipes (reference `bindings/python/py_src/tokenizers/
implementations/`; port of `tokenizers_tpu.implementations`): each wires a
(normalizer, pre-tokenizer, model, post-processor, decoder) of the port
and trains through the port's trainers on the tokenizer's device; every
option of the JAX package's recipes is taken."""

from .base_tokenizer import BaseTokenizer
from .bert_wordpiece import BertWordPieceTokenizer
from .byte_level_bpe import ByteLevelBPETokenizer
from .char_level_bpe import CharBPETokenizer
from .sentencepiece_bpe import SentencePieceBPETokenizer
from .sentencepiece_unigram import SentencePieceUnigramTokenizer

__all__ = ["BaseTokenizer", "BertWordPieceTokenizer", "ByteLevelBPETokenizer",
           "CharBPETokenizer", "SentencePieceBPETokenizer", "SentencePieceUnigramTokenizer"]
