"""BaseTokenizer: the recipes' facade over `Tokenizer`; port of
`tokenizers_tpu.implementations.base_tokenizer` (reference
`implementations/base_tokenizer.py`)."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Union

from ..added_vocabulary import AddedToken
from ..tokenizer import Tokenizer


class BaseTokenizer:
    def __init__(self, tokenizer: Tokenizer, parameters: Optional[dict] = None):
        self._tokenizer = tokenizer
        self._parameters = dict(parameters or {})

    def __repr__(self):
        params = ", ".join(f"{k}={v}" for k, v in self._parameters.items())
        return f"Tokenizer(vocabulary_size={self.get_vocab_size()}, {params})"

    @property
    def device(self):
        return self._tokenizer.device

    @property
    def model(self):
        return self._tokenizer.model

    @model.setter
    def model(self, m):
        self._tokenizer.model = m

    @property
    def normalizer(self):
        return self._tokenizer.normalizer

    @normalizer.setter
    def normalizer(self, n):
        self._tokenizer.normalizer = n

    @property
    def pre_tokenizer(self):
        return self._tokenizer.pre_tokenizer

    @pre_tokenizer.setter
    def pre_tokenizer(self, p):
        self._tokenizer.pre_tokenizer = p

    @property
    def post_processor(self):
        return self._tokenizer.post_processor

    @post_processor.setter
    def post_processor(self, p):
        self._tokenizer.post_processor = p

    @property
    def decoder(self):
        return self._tokenizer.decoder

    @decoder.setter
    def decoder(self, d):
        self._tokenizer.decoder = d

    def num_special_tokens_to_add(self, is_pair: bool) -> int:
        return self._tokenizer.num_special_tokens_to_add(is_pair)

    def get_vocab(self, with_added_tokens: bool = True) -> Dict[str, int]:
        return self._tokenizer.get_vocab(with_added_tokens)

    def get_added_tokens_decoder(self) -> Dict[int, AddedToken]:
        return self._tokenizer.get_added_tokens_decoder()

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        return self._tokenizer.get_vocab_size(with_added_tokens)

    def enable_padding(self, **kwargs):
        return self._tokenizer.enable_padding(**kwargs)

    def no_padding(self):
        return self._tokenizer.no_padding()

    def enable_truncation(self, max_length: int, **kwargs):
        return self._tokenizer.enable_truncation(max_length, **kwargs)

    def no_truncation(self):
        return self._tokenizer.no_truncation()

    def add_tokens(self, tokens: Sequence[Union[str, AddedToken]]) -> int:
        return self._tokenizer.add_tokens(tokens)

    def add_special_tokens(self, special_tokens: Sequence[Union[str, AddedToken]]) -> int:
        return self._tokenizer.add_special_tokens(special_tokens)

    def normalize(self, sequence: str) -> str:
        return self._tokenizer.normalize(sequence)

    def encode(self, sequence, pair=None, is_pretokenized: bool = False,
               add_special_tokens: bool = True):
        return self._tokenizer.encode(sequence, pair, is_pretokenized, add_special_tokens)

    def encode_batch(self, inputs, is_pretokenized: bool = False,
                     add_special_tokens: bool = True):
        return self._tokenizer.encode_batch(inputs, is_pretokenized, add_special_tokens)

    def encode_batch_fast(self, inputs, is_pretokenized: bool = False,
                          add_special_tokens: bool = True):
        return self._tokenizer.encode_batch_fast(inputs, is_pretokenized, add_special_tokens)

    async def async_encode(self, sequence, pair=None, is_pretokenized: bool = False,
                           add_special_tokens: bool = True):
        return await self._tokenizer.async_encode(sequence, pair, is_pretokenized,
                                                  add_special_tokens)

    async def async_encode_batch(self, inputs, is_pretokenized: bool = False,
                                 add_special_tokens: bool = True):
        return await self._tokenizer.async_encode_batch(inputs, is_pretokenized,
                                                        add_special_tokens)

    async def async_encode_batch_fast(self, inputs, is_pretokenized: bool = False,
                                      add_special_tokens: bool = True):
        return await self._tokenizer.async_encode_batch_fast(inputs, is_pretokenized,
                                                             add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tokenizer.decode(ids, skip_special_tokens)

    def decode_batch(self, sequences, skip_special_tokens: bool = True) -> List[str]:
        return self._tokenizer.decode_batch(sequences, skip_special_tokens)

    async def async_decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return await self._tokenizer.async_decode(ids, skip_special_tokens)

    async def async_decode_batch(self, sequences, skip_special_tokens: bool = True):
        return await self._tokenizer.async_decode_batch(sequences, skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tokenizer.token_to_id(token)

    def id_to_token(self, id: int) -> Optional[str]:
        return self._tokenizer.id_to_token(id)

    def save_model(self, directory: str, prefix: Optional[str] = None):
        return self._tokenizer.model.save(directory, prefix)

    def save(self, path: str, pretty: bool = True):
        return self._tokenizer.save(path, pretty)

    def to_str(self, pretty: bool = False) -> str:
        return self._tokenizer.to_str(pretty)

    def post_process(self, encoding, pair=None, add_special_tokens: bool = True):
        return self._tokenizer.post_process(encoding, pair, add_special_tokens)

    def train(self, files: Sequence[str], trainer=None):
        return self._tokenizer.train(files, trainer)

    def train_from_iterator(self, iterator: Iterator[str], trainer=None, length=None):
        return self._tokenizer.train_from_iterator(iterator, trainer, length)
