"""Tokenizer of the port: the pipeline holder (normalizer, pre-tokenizer,
model, post-processor, decoder, added vocabulary, truncation and
padding), its `tokenizer.json` loader and writer, and the batch encode on
the card.

The loader reads every `tokenizer.json` the JAX package reads, as its
`serialization.py` reads it (`normalizers.from_json`,
`pre_tokenizers.from_json`, `serialization.model_from_dict`,
`processor_from_dict`), a
`Precompiled` normalizer (a SentencePiece charsmap) included.  Floats are parsed
as the wheel's serde_json parses them (`utils.serde_float.serde_f64`):
Unigram's Viterbi ties turn on the last ulp of its scores.  Every
pipeline takes any post-processor of `processors/`, any decoder of
`decoders/`, truncation, padding and added tokens with any options
(`added_vocabulary.py`).

The device engine is the one the JAX package's `build_device_engine`
picks for the pipeline, or none (`ops/engine.py`).  The host runs what
the engine does not take, on one of two paths (`_check`, once after each
change of a component): the fast host path (`_host_items`), the port's
per-family pipelines of gpt2, llama3, bert, WordLevel, char-level BPE and
Unigram that the engines send their flagged rows to (`fast_route` says
which pipelines); and the general host pipeline (`_general_one`), the JAX
package's `_encode_single_sequence` over a `PreTokenizedString`, for every
other one (a normalizer before a byte-level model, Punctuation, Digits,
UnicodeScripts, any Split regex, BPE dropout, ...).

`encode_batch_fast` (ids) and `encode_batch` (ids with char offsets,
token strings and word ids; `encode_batch_byte_offsets` for byte
offsets) run the device engine (`ops/engine.py`) on the tokenizer's
device for a batch of strings, and the host pipeline for what the device
does not take: inputs holding an added token, pairs and pre-tokenized
input (as the JAX package routes any input that is not a `str`); a batch
of 8 or more inputs on the host runs on the host pool
(`utils/parallelism.py`, TOKENIZERS_PARALLELISM; `_host_map`).  Every
encoding then goes through `post_process` (truncate, add the special
tokens, pad), and the batch is padded.  The device is `cuda` unless the
caller asks for `device="cpu"`, where every kernel runs its plain
PyTorch version.

`to_str`, `save` (`serialization.py`), `from_str`, `from_file`,
`from_buffer`, `from_pretrained` (a path, a directory, the hub cache's
snapshots, else a download) and pickling (through the JSON) round-trip a
tokenizer.

`train` and `train_from_iterator` train the model with a trainer of
`trainers/` on the words of `train_words`, then add the trainer's special
tokens and drop the device engine; the trainer's feed counts 4,000
sequences or more on the host pool.  `decode`, `decode_batch` (on the
host pool from 64 sequences) and `decode_stream` turn ids back into text
on the host, as the reference does (`tokenizer/mod.rs:1017-1127`,
`:1329-1345`).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from functools import partial
from typing import Dict, Iterable, List, Optional, Sequence as Seq, Union

from . import pick_device
from .added_vocabulary import AddedToken, AddedVocabulary
from .decoders import CustomDecoder
from .decoders import from_json as decoder_from_json
from .encoding import Encoding
from .models.bpe import BPE
from .models.unigram import Unigram
from .models.wordlevel import WordLevel
from .models.wordpiece import WordPiece
from .normalized import NormalizedString, char_to_byte_offsets
from .normalizers import (NFC, NFD, NFKC, NFKD, CustomNormalizer, Lowercase, Nmt, Prepend,
                          Replace, Strip, StripAccents)
from .normalizers import Sequence as NormalizerSequence
from .normalizers import from_json as normalizer_from_json
from .normalizers.bert import BertNormalizer
from .pre_tokenizers import Sequence
from .pre_tokenizers.base import CustomPreTokenizer
from .pre_tokenizers import from_json as pre_tokenizer_from_json
from .pre_tokenizers.bert import BertPreTokenizer
from .pre_tokenizers.byte_level import ByteLevel
from .pre_tokenizers.metaspace import Metaspace
from .pre_tokenizers.whitespace import Whitespace, WhitespaceSplit
from .processors import default_process
from .serialization import model_from_dict, processor_from_dict
from .utils.parallelism import MIN_ITEMS
from .utils.padding import BATCH_LONGEST, PaddingParams, pad_encodings
from .utils.serde_float import serde_f64
from .utils.truncation import TruncationParams, truncate_encodings

# ------------------------------------------------------------------ inputs

InputSequence = Union[str, Seq[str]]


def _as_sequence(x):
    """numpy unicode/object arrays and numpy strings as plain Python
    (reference `bindings/python/src/tokenizer.rs:282-345`)."""
    import numpy as np

    if isinstance(x, np.str_):
        return str(x)
    if isinstance(x, np.ndarray):
        if x.dtype.kind in ("U", "S", "O"):
            return [_as_sequence(v) for v in x.tolist()]
        raise TypeError("numpy array inputs must have unicode (U), bytes (S) or object (O) "
                        f"dtype, got {x.dtype}")
    return x


def _parse_text_input(sequence) -> str:
    sequence = _as_sequence(sequence)
    if isinstance(sequence, bytes):
        sequence = sequence.decode("utf-8")
    if not isinstance(sequence, str):
        raise TypeError("TextInputSequence must be str")
    return sequence


def _parse_pretokenized_input(sequence) -> List[str]:
    sequence = _as_sequence(sequence)
    if isinstance(sequence, str) or not isinstance(sequence, (list, tuple)):
        raise TypeError("PreTokenizedInputSequence must be Union[List[str], Tuple[str]]")
    out = []
    for item in sequence:
        item = _as_sequence(item)
        if isinstance(item, bytes):
            item = item.decode("utf-8")
        if not isinstance(item, str):
            raise TypeError("PreTokenizedInputSequence must be Union[List[str], Tuple[str]]")
        out.append(item)
    return out


def _parse_encode_input(input, is_pretokenized: bool):
    """A batch item as (sequence, pair or None), as the reference binding
    reads it (`bindings/python/src/tokenizer.rs:195-276`): a 2-element
    tuple or list of sequences is a pair."""
    input = _as_sequence(input)
    if is_pretokenized:
        if (isinstance(input, (tuple, list)) and len(input) == 2
                and all(isinstance(_as_sequence(x), (list, tuple)) for x in input)):
            return _parse_pretokenized_input(input[0]), _parse_pretokenized_input(input[1])
        return _parse_pretokenized_input(input), None
    if isinstance(input, (tuple, list)):
        if len(input) == 2:
            return _parse_text_input(input[0]), _parse_text_input(input[1])
        raise TypeError("TextEncodeInput must be Union[TextInputSequence, "
                        "Tuple[InputSequence, InputSequence]]")
    return _parse_text_input(input), None


# ------------------------------------------------------------------ loader

def _load_components(d: dict):
    """(normalizer, pre-tokenizer, model, post-processor) of a tokenizer.json
    dict: every pipeline the JAX package loads."""
    return (normalizer_from_json(d.get("normalizer")),
            pre_tokenizer_from_json(d.get("pre_tokenizer")), model_from_dict(d["model"]),
            processor_from_dict(d.get("post_processor")))


_FAST_NORMALIZERS = (NormalizerSequence, Lowercase, NFD, NFKD, NFC, NFKC, StripAccents, Strip,
                     Replace, Prepend, BertNormalizer, Nmt)


def _fast_normalizer(nz, unigram: bool) -> bool:
    """Whether the fast host path's aligned pipelines take `nz`: one of
    their normalizers or a Sequence of them, Nmt and a regex Replace only
    before a Unigram model."""
    parts = nz.normalizers if isinstance(nz, NormalizerSequence) else [nz]
    return all(type(n) in _FAST_NORMALIZERS and not isinstance(n, NormalizerSequence) and (
        unigram or not (isinstance(n, Nmt) or (isinstance(n, Replace) and n.regex)))
        for n in parts)


def _encode_parsed(tok: "Tokenizer", add_special_tokens: bool, offsets: Optional[str],
                   is_pretokenized: bool, item) -> Encoding:
    return tok._encode(item[0], item[1], add_special_tokens, offsets, is_pretokenized)


def _decode_ids(tok: "Tokenizer", skip_special_tokens: bool, ids) -> str:
    return tok.decode(ids, skip_special_tokens)


def _count_train_words(tok: "Tokenizer", sequences: List[str]) -> Counter:
    local: Counter = Counter()
    for sequence in sequences:
        local.update(tok.train_words(sequence))
    return local


def _with_state(fn, encode_special_tokens: bool, args: tuple, tok: "Tokenizer", item):
    """`fn(tok, *args, item)`, in a worker of the host pool on its copy of
    `tok`, with the state its JSON leaves out."""
    tok.added_vocabulary.encode_special_tokens = encode_special_tokens
    return fn(tok, *args, item)


def _exact_copy(s: str, device: str) -> "Tokenizer":
    """A worker's copy of a tokenizer from its `to_str`: json's own float
    parse inverts the `repr` that `to_str` writes, so every score is the
    tokenizer's own (`from_str`, and so pickling, parse as the wheel does,
    lossy in the last ulp)."""
    return Tokenizer._from_dict(json.loads(s), device)


def _holds_custom(component) -> bool:
    """Whether a component is, or holds, a user's object."""
    if isinstance(component, (CustomNormalizer, CustomPreTokenizer, CustomDecoder)):
        return True
    inner = (getattr(component, "normalizers", None) or getattr(component, "pretokenizers", None)
             or getattr(component, "decoders", None) or ())
    return any(_holds_custom(c) for c in inner)


def fast_route(nz, pt, m) -> bool:
    """Whether the fast host path (`Tokenizer._host_items`) serves the
    pipeline: byte-level BPE (no normalizer; the ByteLevel pre-tokenizer
    with its regex, or the llama-3 Sequence with no prefix space), bert
    (BertNormalizer, BertPreTokenizer, WordPiece), or WordLevel,
    char-level BPE or Unigram with the normalizers `_fast_normalizer`
    takes and no pre-tokenizer, Whitespace, WhitespaceSplit,
    BertPreTokenizer or Metaspace (`▁`, split); WordLevel with the first
    three, Unigram with Metaspace "always" and an unk id.  Every other
    pipeline runs the general one (`Tokenizer._general_one`)."""
    if isinstance(m, BPE) and (m.dropout or m.ignore_merges and not isinstance(
            pt, (ByteLevel, Sequence))):
        return False
    if isinstance(m, WordPiece):
        return isinstance(nz, BertNormalizer) and type(pt) is BertPreTokenizer
    if isinstance(m, BPE) and (type(pt) is ByteLevel and pt.use_regex or isinstance(
            pt, Sequence) and pt.is_llama3()):
        return nz is None and not (m.continuing_subword_prefix or m.end_of_word_suffix
                                   or m.byte_fallback)
    if nz is not None and not _fast_normalizer(nz, isinstance(m, Unigram)):
        return False
    metaspace = type(pt) is Metaspace and pt.replacement == "▁" and pt.split
    if isinstance(m, WordLevel):
        return type(pt) in (Whitespace, WhitespaceSplit, BertPreTokenizer)
    if isinstance(m, Unigram):
        return m.unk_id is not None and metaspace and pt.prepend_scheme == "always"
    return isinstance(m, BPE) and (pt is None or metaspace or type(pt) in (
        Whitespace, WhitespaceSplit, BertPreTokenizer))


def _hub_cache() -> str:
    return os.environ.get("HF_HUB_CACHE", os.path.join(
        os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface")), "hub"))


def _ns_slice(ns: NormalizedString, start: int, end: int) -> NormalizedString:
    """The normalized bytes [start, end) of `ns`, with their alignments (not
    re-based: they stay in `ns`'s original)."""
    return NormalizedString._raw(ns.original,
                                 ns.normalized.encode("utf-8")[start:end].decode("utf-8"),
                                 ns.alignments[start:end], 0)


class Tokenizer:
    def __init__(self, model: Union[BPE, WordPiece, WordLevel, Unigram], pre_tokenizer=None,
                 added_tokens: Iterable = (), post_processor=None, decoder=None,
                 device=None, normalizer=None):
        """The JAX package's `Tokenizer(model)` with settable components, or
        the whole pipeline at once; `added_tokens`: tokenizer.json entries
        (their ids kept)."""
        self._model = model
        self._normalizer = normalizer
        self._pre_tokenizer = pre_tokenizer
        self._post_processor = post_processor
        self._decoder = decoder
        self.device = pick_device(device)
        self.added_vocabulary = AddedVocabulary()
        self._truncation: Optional[TruncationParams] = None
        self._padding: Optional[PaddingParams] = None
        self._shared = None  # the host pool's copy (`_host_map`)
        self._engine = None
        self._engine_built = False
        self._checked = False
        self._fast = True
        self._add_entries(added_tokens)

    # ------------------------------------------------------------ components

    def _changed(self) -> None:
        """A component changed: check the pipeline again and rebuild the
        device engine at the next encode (JAX keys its engine on the
        model's id only, Queue C)."""
        self._checked = False
        self._engine = None
        self._engine_built = False
        self._shared = None

    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, m) -> None:
        self._model = m
        self._changed()

    @property
    def normalizer(self):
        return self._normalizer

    @normalizer.setter
    def normalizer(self, n) -> None:
        self._normalizer = n
        self._changed()

    @property
    def pre_tokenizer(self):
        return self._pre_tokenizer

    @pre_tokenizer.setter
    def pre_tokenizer(self, p) -> None:
        self._pre_tokenizer = p
        self._changed()

    @property
    def post_processor(self):
        return self._post_processor

    @post_processor.setter
    def post_processor(self, p) -> None:
        self._post_processor = p
        self._changed()

    @property
    def decoder(self):
        return self._decoder

    @decoder.setter
    def decoder(self, d) -> None:
        self._decoder = d
        self._shared = None

    @property
    def truncation(self) -> Optional[TruncationParams]:
        return self._truncation

    @truncation.setter
    def truncation(self, t: Optional[TruncationParams]) -> None:
        self._truncation = t
        self._shared = None

    @property
    def padding(self) -> Optional[PaddingParams]:
        return self._padding

    @padding.setter
    def padding(self, p: Optional[PaddingParams]) -> None:
        self._padding = p
        self._shared = None

    @property
    def aligned(self) -> bool:
        """WordLevel, char-level BPE and Unigram: offsets through the
        normalizer's alignments."""
        m, pt = self._model, self._pre_tokenizer
        return isinstance(m, (WordLevel, Unigram)) or (
            isinstance(m, BPE) and not isinstance(pt, (ByteLevel, Sequence)))

    @property
    def added(self) -> Dict[str, int]:
        """content -> id of every added token."""
        return dict(self.added_vocabulary.added_tokens_map)

    def _check(self) -> None:
        """Route the pipeline (once after each change): the fast host path
        where `fast_route` takes it, else the general one; a BPE model's
        spans are in the word's bytes where they map through alignments
        and in the general pipeline, in its chars else."""
        if self._checked:
            return
        self._fast = fast_route(self._normalizer, self._pre_tokenizer, self._model)
        m = self._model
        byte_spans = self.aligned or not self._fast
        if isinstance(m, BPE) and m.byte_spans != byte_spans:
            m.byte_spans = byte_spans
            m.cache = type(m.cache)(m.cache.capacity)
        self._checked = True

    # ------------------------------------------------------------------ io

    @classmethod
    def from_str(cls, s: str, device=None) -> "Tokenizer":
        return cls._from_dict(json.loads(s, parse_float=serde_f64), device)

    @classmethod
    def _from_dict(cls, d: dict, device=None) -> "Tokenizer":
        from .serialization import padding_from_dict, truncation_from_dict

        normalizer, pt, model, pp = _load_components(d)
        tok = cls(model, pt, d.get("added_tokens") or [], post_processor=pp,
                  decoder=decoder_from_json(d.get("decoder")), device=device,
                  normalizer=normalizer)
        tok.truncation = truncation_from_dict(d.get("truncation"))
        tok.padding = padding_from_dict(d.get("padding"))
        tok._check()
        return tok

    @classmethod
    def from_file(cls, path: str, device=None) -> "Tokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_str(f.read(), device=device)

    @classmethod
    def from_buffer(cls, buffer: bytes, device=None) -> "Tokenizer":
        return cls.from_str(buffer.decode("utf-8"), device=device)

    @classmethod
    def from_pretrained(cls, identifier: str, revision: str = "main",
                        token: Optional[str] = None, device=None) -> "Tokenizer":
        """A `tokenizer.json` from a path, a directory holding one, the hub
        cache's snapshots, else downloaded from the hub into that cache
        (reference `utils/from_pretrained.rs:26-68`); with
        `HF_HUB_OFFLINE=1` a missing file raises instead."""
        candidates = [identifier, os.path.join(identifier, "tokenizer.json")]
        model_dir = os.path.join(_hub_cache(), "models--" + identifier.replace("/", "--"))
        snapshots = os.path.join(model_dir, "snapshots")
        if os.path.isdir(snapshots):
            candidates += [os.path.join(snapshots, snap, "tokenizer.json")
                           for snap in sorted(os.listdir(snapshots))]
        for cand in candidates:
            if os.path.isfile(cand):
                return cls.from_file(cand, device=device)
        if os.environ.get("HF_HUB_OFFLINE") not in (None, "", "0"):
            raise FileNotFoundError(f"Could not find a local tokenizer.json for {identifier!r} "
                                    "and HF_HUB_OFFLINE is set")
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"https://huggingface.co/{identifier}/resolve/{revision}/tokenizer.json",
            headers={"User-Agent": "tokenizers-tpu-torch/0.1.0",
                     **({"Authorization": f"Bearer {token}"} if token else {})})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                data = r.read()
        except (urllib.error.URLError, OSError) as e:
            raise FileNotFoundError(f"Could not find a local tokenizer.json for {identifier!r} "
                                    f"and the hub download failed: {e}") from e
        snap_dir = os.path.join(snapshots, revision)
        os.makedirs(snap_dir, exist_ok=True)
        path = os.path.join(snap_dir, "tokenizer.json")
        with open(path, "wb") as f:
            f.write(data)
        return cls.from_file(path, device=device)

    def to_str(self, pretty: bool = False) -> str:
        from .serialization import tokenizer_to_dict

        d = tokenizer_to_dict(self)
        if pretty:
            return json.dumps(d, ensure_ascii=False, indent=2)
        return json.dumps(d, ensure_ascii=False, separators=(",", ":"))

    def save(self, path: str, pretty: bool = True) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_str(pretty))

    # pickling through the JSON, as the reference binding does
    # (`bindings/python/src/tokenizer.rs:598-621`); the device engine is
    # rebuilt at the next encode
    def __getstate__(self):
        return {"tokenizer_json": self.to_str(), "device": str(self.device)}

    def __setstate__(self, state):
        fresh = Tokenizer.from_str(state["tokenizer_json"], device=state["device"])
        self.__dict__.update(fresh.__dict__)

    def __reduce__(self):
        return (Tokenizer.from_str, (self.to_str(), str(self.device)))

    # -------------------------------------------------------------- settings

    def enable_truncation(self, max_length: int, stride: int = 0,
                          strategy: str = "longest_first", direction: str = "right") -> None:
        self.truncation = TruncationParams(max_length, strategy, stride, direction)

    def no_truncation(self) -> None:
        self.truncation = None

    def get_truncation(self) -> Optional[TruncationParams]:
        return self.truncation

    def enable_padding(self, direction: str = "right", pad_id: int = 0, pad_type_id: int = 0,
                       pad_token: str = "[PAD]", length: Optional[int] = None,
                       pad_to_multiple_of: Optional[int] = None) -> None:
        self.padding = PaddingParams(BATCH_LONGEST if length is None else length, direction,
                                     pad_to_multiple_of, pad_id, pad_type_id, pad_token)

    def no_padding(self) -> None:
        self.padding = None

    def get_padding(self) -> Optional[PaddingParams]:
        return self.padding

    def set_encode_special_tokens(self, value: bool) -> None:
        self.added_vocabulary.encode_special_tokens = value

    def get_encode_special_tokens(self) -> bool:
        return self.added_vocabulary.encode_special_tokens

    # ----------------------------------------------------------------- vocab

    def get_vocab(self, with_added_tokens: bool = True) -> Dict[str, int]:
        vocab = self._model.get_vocab()
        if with_added_tokens:
            vocab.update(self.added_vocabulary.get_vocab())
        return vocab

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        n = self._model.get_vocab_size()
        if with_added_tokens:
            n += sum(self._model.token_to_id(c) is None for c in self.added_vocabulary.get_vocab())
        return n

    def get_added_tokens_decoder(self) -> Dict[int, AddedToken]:
        return self.added_vocabulary.get_added_tokens_decoder()

    def token_to_id(self, token: str) -> Optional[int]:
        return self.added_vocabulary.token_to_id(token, self._model)

    def id_to_token(self, id: int) -> Optional[str]:
        """The added token of `id`, else the model's token (None if neither
        has it)."""
        return self.added_vocabulary.id_to_token(id, self._model)

    def _add(self, tokens: List[AddedToken]) -> int:
        self._engine = None
        self._engine_built = False
        self._shared = None
        return self.added_vocabulary.add_tokens(tokens, self._model, self._normalizer)

    def add_tokens(self, tokens: Seq[Union[str, AddedToken]]) -> int:
        """Add tokens (a string is a non-special token matched on the
        normalized text); returns how many were new."""
        return self._add([t if isinstance(t, AddedToken) else AddedToken(t, normalized=True)
                          for t in tokens])

    def add_special_tokens(self, tokens: Seq[Union[str, AddedToken]]) -> int:
        """Add special tokens (a string is matched on the raw text; an
        `AddedToken` is made special, `AddedToken.as_special`); returns how
        many were new."""
        return self._add([t.as_special() if isinstance(t, AddedToken)
                          else AddedToken(t, special=True) for t in tokens])

    def _add_entries(self, entries: Iterable) -> None:
        """Add tokenizer.json entries in id order, each keeping the id it
        records where `add_tokens` would assign another
        (`tokenizers_tpu/serialization.py:650-668`)."""
        for e in sorted(entries, key=lambda e: e["id"]):
            special = e.get("special", False)
            token = AddedToken(e["content"], single_word=e.get("single_word", False),
                               lstrip=e.get("lstrip", False), rstrip=e.get("rstrip", False),
                               normalized=e.get("normalized", not special), special=special)
            self._add([token])
            if self.token_to_id(token.content) != e["id"]:
                self.added_vocabulary.force_id(token, e["id"], self._model, self._normalizer)

    def num_special_tokens_to_add(self, is_pair: bool) -> int:
        return self._post_processor.added_tokens(is_pair) if self._post_processor else 0

    def normalize(self, sequence: str) -> str:
        """The normalizer alone (the reference binding's `normalize`)."""
        ns = NormalizedString(sequence)
        if self._normalizer is not None:
            self._normalizer.normalize(ns)
        return ns.get()

    # ---------------------------------------------------------------- encode

    def encode_batch_fast(self, inputs, is_pretokenized: bool = False,
                          add_special_tokens: bool = True) -> List[Encoding]:
        """Ids of each input (no offsets, token strings or word ids)."""
        return self._encode_batch(inputs, is_pretokenized, add_special_tokens, None)

    def encode_batch(self, inputs, is_pretokenized: bool = False,
                     add_special_tokens: bool = True) -> List[Encoding]:
        """Ids with char offsets, token strings and word ids, as the
        reference's Python binding gives them."""
        return self._encode_batch(inputs, is_pretokenized, add_special_tokens, "char")

    def encode_batch_char_offsets(self, inputs, is_pretokenized: bool = False,
                                  add_special_tokens: bool = True) -> List[Encoding]:
        return self._encode_batch(inputs, is_pretokenized, add_special_tokens, "char")

    def encode_batch_byte_offsets(self, inputs, is_pretokenized: bool = False,
                                  add_special_tokens: bool = True) -> List[Encoding]:
        """As `encode_batch`, with byte offsets (the reference's Rust
        default), each widened to whole chars."""
        return self._encode_batch(inputs, is_pretokenized, add_special_tokens, "byte")

    def _encode_batch(self, inputs, is_pretokenized: bool, add_special_tokens: bool,
                      offsets: Optional[str]) -> List[Encoding]:
        inputs = list(_as_sequence(inputs))
        engine = self._get_device_engine()
        if engine is not None and offsets is not None and not engine.supports_offsets:
            engine = None
        if engine is not None and not is_pretokenized and all(isinstance(s, str) for s in inputs):
            if offsets is None:
                encodings = engine.encode_batch(inputs, add_special_tokens)
            else:
                encodings = engine.encode_batch_offsets(inputs, add_special_tokens, offsets)
        else:
            parsed = [_parse_encode_input(x, is_pretokenized) for x in inputs]
            encodings = self._host_map(_encode_parsed, parsed, MIN_ITEMS, add_special_tokens,
                                       offsets, is_pretokenized)
        if self.padding is not None:
            pad_encodings(encodings, self.padding)
        return encodings

    def _encode(self, sequence, pair, add_special_tokens: bool, offsets: Optional[str],
                is_pretokenized: bool = False) -> Encoding:
        """The host pipeline of one input and its pair, post-processed."""
        self._check()
        parse = _parse_pretokenized_input if is_pretokenized else _parse_text_input
        encoding = self._encode_single(parse(sequence), 0, offsets)
        pair_encoding = None if pair is None else self._encode_single(parse(pair), 1, offsets)
        return self.post_process(encoding, pair_encoding, add_special_tokens)

    def _encode_one_input(self, sequence, pair, is_pretokenized, add_special_tokens, offsets):
        if pair is None and not is_pretokenized and isinstance(_as_sequence(sequence), str):
            return self._encode_batch([sequence], False, add_special_tokens, offsets)[0]
        return self._encode(sequence, pair, add_special_tokens, offsets, is_pretokenized)

    def encode(self, sequence, pair=None, is_pretokenized: bool = False,
               add_special_tokens: bool = True) -> Encoding:
        """Char offsets, as the reference's Python binding gives them."""
        return self._encode_one_input(sequence, pair, is_pretokenized, add_special_tokens,
                                      "char")

    def encode_char_offsets(self, sequence, pair=None, is_pretokenized: bool = False,
                            add_special_tokens: bool = True) -> Encoding:
        return self._encode_one_input(sequence, pair, is_pretokenized, add_special_tokens,
                                      "char")

    def encode_byte_offsets(self, sequence, pair=None, is_pretokenized: bool = False,
                            add_special_tokens: bool = True) -> Encoding:
        return self._encode_one_input(sequence, pair, is_pretokenized, add_special_tokens,
                                      "byte")

    def encode_fast(self, sequence, pair=None, is_pretokenized: bool = False,
                    add_special_tokens: bool = True) -> Encoding:
        """Ids only (reference `tokenizer/mod.rs:785`)."""
        return self._encode_one_input(sequence, pair, is_pretokenized, add_special_tokens, None)

    def encode_batch_arrays(self, inputs: Iterable[str]):
        """Per packed chunk (ids, ntok, row_bad, (input, piece) of each row),
        the ids left on the device (`DeviceEngineBase.encode_batch_arrays`):
        no post-processing, truncation or padding."""
        engine = self._get_device_engine()
        if engine is None:
            raise RuntimeError("this tokenizer has no device engine")
        inputs = list(inputs)
        if not all(isinstance(s, str) for s in inputs):
            raise TypeError("encode_batch_arrays takes a sequence of str")
        return engine.encode_batch_arrays(inputs)

    # async variants (the reference binding's, `tokenizer.rs:1135-1432`):
    # the blocking work runs in asyncio's default thread pool

    async def async_encode(self, sequence, pair=None, is_pretokenized: bool = False,
                           add_special_tokens: bool = True) -> Encoding:
        import asyncio

        return await asyncio.to_thread(self.encode, sequence, pair, is_pretokenized,
                                       add_special_tokens)

    async def async_encode_batch(self, inputs, is_pretokenized: bool = False,
                                 add_special_tokens: bool = True) -> List[Encoding]:
        import asyncio

        return await asyncio.to_thread(self.encode_batch, inputs, is_pretokenized,
                                       add_special_tokens)

    async def async_encode_batch_fast(self, inputs, is_pretokenized: bool = False,
                                      add_special_tokens: bool = True) -> List[Encoding]:
        import asyncio

        return await asyncio.to_thread(self.encode_batch_fast, inputs, is_pretokenized,
                                       add_special_tokens)

    async def async_decode(self, ids: Seq[int], skip_special_tokens: bool = True) -> str:
        import asyncio

        return await asyncio.to_thread(self.decode, ids, skip_special_tokens)

    async def async_decode_batch(self, sequences, skip_special_tokens: bool = True) -> List[str]:
        import asyncio

        return await asyncio.to_thread(self.decode_batch, sequences, skip_special_tokens)

    # ----------------------------------------------------------------- train

    def train(self, files: Iterable[str], trainer=None) -> "Tokenizer":
        """Train the model on the lines of `files` (each with its ending)."""
        from .utils.iter import file_lines_with_ending

        return self.train_from_iterator(file_lines_with_ending(files), trainer)

    def train_from_iterator(self, iterator: Iterable[str], trainer=None,
                            length: Optional[int] = None) -> "Tokenizer":
        """Feed the trainer the words of each sequence (`train_words`), train
        the model, add the trainer's special tokens, and drop the device
        engine so that the next encode builds its tables from the trained
        model.  Without a trainer the model's default one runs on this
        tokenizer's device.  `length` is accepted for the reference's
        surface (the BPE trainers' bar counts merges)."""
        self._check()
        if trainer is None:
            trainer = self._model.get_trainer(device=self.device)
        trainer.feed(iterator, self.train_words, self._count_chunks)
        special_tokens = trainer.train(self._model)
        self.add_special_tokens(special_tokens)
        self._changed()
        return self

    def train_words(self, sequence: str) -> List[str]:
        """The words a trainer counts in `sequence`, as the reference's
        `Tokenizer::train` gives them: the added tokens split out (each a
        word of its own, as matched), and on each piece between them the
        normalizer and the pre-tokenizer (Metaspace prepends as its scheme
        says); in the general pipeline the text of each split of
        `PreTokenizedString.get_splits` (the JAX package's feed)."""
        self._check()
        av, nz, pt = self.added_vocabulary, self._normalizer, self._pre_tokenizer
        if not self._fast:
            p = av.extract_and_normalize(nz, sequence)
            if pt is not None:
                pt.pre_tokenize(p)
            return [s for s, _o, _t in p.get_splits("original", "byte")]
        words: List[str] = []

        def pre_tokenize(text: str, first: bool):
            if not text:
                return
            if isinstance(pt, Metaspace):
                words.extend(pt.words(text, first))
            elif pt is None:
                words.append(text)
            else:
                words.extend(pt.words(text))

        for tid, cs, ce in av.split(sequence, False):
            if tid is not None:
                words.append(sequence[cs:ce])
                continue
            text = sequence[cs:ce] if nz is None else nz.normalize_str(sequence[cs:ce])
            for ntid, a, b in av.split(text, True):
                if ntid is not None:
                    words.append(text[a:b])
                else:
                    pre_tokenize(text[a:b], cs == 0 and a == 0)
        return words

    # ---------------------------------------------------------------- decode

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        """The text of `ids`: each id's token (unknown ids dropped; special
        added tokens dropped with `skip_special_tokens`) through the
        decoder, or joined by spaces without one."""
        tokens = []
        av = self.added_vocabulary
        for i in ids:
            token = self.id_to_token(int(i))
            if token is None or (skip_special_tokens and av.is_special_token(token)):
                continue
            tokens.append(token)
        if self.decoder is not None:
            return self.decoder.decode(tokens)
        return " ".join(tokens)

    def decode_batch(self, sequences: Iterable[Iterable[int]],
                     skip_special_tokens: bool = True) -> List[str]:
        """`decode` of each sequence; from 64 sequences on, on the host
        pool (reference `tokenizer/mod.rs:1345`)."""
        return self._host_map(_decode_ids, [list(ids) for ids in sequences], 64,
                              skip_special_tokens)

    def _pool_safe(self) -> bool:
        """Whether the host pool's workers give this tokenizer's results: a
        tokenizer reaches them through its JSON, which a custom component
        has not, and under BPE dropout each worker would draw from a copy
        of one generator (such a batch stays serial, so that it equals the
        serial run)."""
        return not (isinstance(self._model, BPE) and self._model.dropout) and not any(
            _holds_custom(c) for c in (self._normalizer, self._pre_tokenizer, self.decoder))

    def _host_map(self, fn, items: list, min_items: int, *args) -> list:
        """`fn(self, *args, x)` for each item: on the host pool
        (`utils.parallelism.maybe_par_map`, which keeps it serial below
        `min_items` items or with TOKENIZERS_PARALLELISM off) where
        `_pool_safe`, else serially.  The workers hold an exact copy of
        this tokenizer (`_exact_copy`), made once for each state: it is
        dropped at each change made through the Tokenizer (a component,
        added tokens, truncation, padding, training), as the device
        engine is."""
        if not self._pool_safe():
            return [fn(self, *args, x) for x in items]
        from .utils.parallelism import Shared, maybe_par_map

        if self._shared is None:
            self._shared = Shared(self, lambda: (_exact_copy, (self.to_str(), str(self.device))))
        est = self.added_vocabulary.encode_special_tokens  # left out of the JSON
        return maybe_par_map(partial(_with_state, fn, est, args), items, min_items, self._shared)

    def _count_chunks(self, chunks: List[List[str]]) -> List[Counter]:
        """The words of each chunk (`train_words`) counted on the host pool:
        the BPE trainers' feed map (`BpeTrainer.feed`)."""
        return self._host_map(_count_train_words, chunks, 2)

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)

    def _get_device_engine(self):
        """The device engine, built once after each change; None when the
        vocab lacks a byte of the byte-level alphabet or two whole-word
        entries collide (everything then runs on the host)."""
        if not self._engine_built:
            from .ops.engine import build_device_engine

            self._check()
            self._engine = build_device_engine(self, self.device)
            self._engine_built = True
        return self._engine

    # ---------------------------------------------------------- host pipeline

    def encode_host(self, text: str, add_special_tokens: bool = True,
                    offsets: Optional[str] = None) -> Encoding:
        """The host pipeline of one string, post-processed: with `offsets`
        ("char" or "byte") each token's offsets, string and word index
        too; without, ids only."""
        self._check()
        return self.post_process(self._encode_one(text, offsets), None, add_special_tokens)

    def _encode_single(self, sequence, type_id: int, offsets: Optional[str]) -> Encoding:
        """One sequence: a string, or pre-tokenized words (each encoded on
        its own, its tokens of word index its position, offsets within
        the word; `tokenizer/mod.rs:711-745`)."""
        if isinstance(sequence, str):
            return self._encode_one(sequence, offsets, type_id)
        merged = Encoding()
        for i, word in enumerate(sequence):
            merged.merge_with(self._encode_one(word, offsets, type_id, word_idx=i), False)
        return merged

    def _encode_one(self, text: str, offsets: Optional[str], type_id: int = 0,
                    word_idx: Optional[int] = None) -> Encoding:
        """The host pipeline of one string, before post-processing: added
        tokens split out (`_host_items`), the normalizer, the
        pre-tokenizer's split and the model on each piece between them.
        Spans are taken in the text's chars (bert) or bytes and mapped to
        chars or whole-char bytes as the device's spans are
        (`engine_base.map_offsets`).  Ids only (offsets None): tokens "",
        offsets (0, 0), no word ids, type ids 0, as the JAX package's
        `into_encoding(..., "none")` gives them.  A pipeline the fast path
        does not serve runs the general one (`_general_one`)."""
        if not self._fast:
            return self._general_one(text, offsets, type_id, word_idx)
        if offsets is None:
            ids: List[int] = []
            for item in self._host_items(text, False):
                ids.extend(item[1])
            return Encoding(ids=ids)
        from .ops.engine_base import map_offsets

        ids, tokens, words, starts, ends = [], [], [], [], []
        n_words = 0
        vr = self._model.vocab_r
        for kind, body in self._host_items(text, True):
            if kind == "added":
                tid, token, st, en = body
                ids.append(tid)
                tokens.append(token)
                words.append(n_words)
                starts.append(st)
                ends.append(en)
                n_words += 1
                continue
            for word in body:
                for t in word:
                    ids.append(t[0])
                    tokens.append(t[3] if len(t) > 3 else vr[t[0]])
                    words.append(n_words)
                    starts.append(t[1])
                    ends.append(t[2])
                n_words += 1
        n = len(ids)
        chars = isinstance(self._model, WordPiece)  # the unit of the spans
        return Encoding(ids=ids, type_ids=[type_id] * n, tokens=tokens,
                        words=words if word_idx is None else [word_idx] * n,
                        offsets=map_offsets(text, starts, ends, offsets,
                                            "char" if chars else "byte"))

    def _general_one(self, text: str, offsets: Optional[str], type_id: int = 0,
                     word_idx: Optional[int] = None) -> Encoding:
        """The general host pipeline of one string (the JAX package's
        `_encode_single_sequence`, `tokenizer.py:337-359`): the added
        tokens extracted and the normalizer run (`extract_and_normalize`),
        the pre-tokenizer's split, the model on each split
        (`Model.tokenize`), then the encoding with offsets in the text's
        chars or bytes, or ids alone."""
        p = self.added_vocabulary.extract_and_normalize(self._normalizer, text)
        if self._pre_tokenizer is not None:
            self._pre_tokenizer.pre_tokenize(p)
        m = self._model
        p.tokenize(lambda ns: m.tokenize(ns.get()))
        if offsets is None:
            return Encoding(ids=[t.id for split in p.splits for t in split.tokens])
        return p.into_encoding(word_idx, type_id, offsets)

    def _host_items(self, text: str, spans: bool):
        """Per split of `text`, in order: ("added", (id, token, start, end))
        for an added token (its text as matched, lstrip and rstrip spaces
        included, the normalized text for one matched there), else
        ("ids", ids) of a text piece, or with `spans` ("words", words),
        each word a list of (id, start, end[, token]).  Spans are absolute,
        in the text's chars (bert) or bytes."""
        av, nz = self.added_vocabulary, self._normalizer
        chars = isinstance(self._model, WordPiece)
        if not spans or chars or text.isascii():
            def unit(c: int) -> int:  # chars, or bytes of ASCII (no span needed: any)
                return c
        else:
            cb = char_to_byte_offsets(text)

            def unit(c: int) -> int:
                return cb[c]

        for tid, cs, ce in av.split(text, False):
            if tid is not None:
                yield "added", (tid, text[cs:ce], unit(cs), unit(ce)) if spans else [tid]
                continue
            piece, first = text[cs:ce], cs == 0
            if not av.has_normalized():
                yield from self._piece_items(piece, first, unit(cs), spans)
            elif nz is None:
                for ntid, a, b in av.split(piece, True):
                    if ntid is not None:
                        yield "added", ((ntid, piece[a:b], unit(cs + a), unit(cs + b))
                                        if spans else [ntid])
                    else:
                        yield from self._piece_items(piece[a:b], first and a == 0,
                                                     unit(cs + a), spans)
            elif chars:
                yield from self._bert_normalized_items(piece, cs, av, spans)
            else:
                yield from self._aligned_normalized_items(piece, first, unit(cs), av, spans)

    def _piece_items(self, piece: str, first: bool, base: int, spans: bool):
        """`_host_items` of a text piece (raw text) at `base`."""
        if not spans:
            if self.aligned:
                yield "ids", [t[0] for word in self._aligned_word_spans(piece, first)
                              for t in word]
                return
            if self._normalizer is not None:
                piece = self._normalizer.normalize_chars(piece)[0]
            tok = self._model.tokenize_ids
            yield "ids", [i for word in self._pre_tokenizer.words(piece)
                          for i in tok(word)]
            return
        yield "words", [[(t[0], t[1] + base, t[2] + base) + tuple(t[3:]) for t in word]
                        for word in self._word_spans(piece, first)]

    def _bert_normalized_items(self, piece: str, cs: int, av, spans: bool):
        """The bert pipeline's piece (at char `cs`) with tokens matched on
        its normalized text: spans through the normalizer's source chars."""
        norm, src = self._normalizer.normalize_chars(piece)
        for ntid, a, b in av.split(norm, True):
            if ntid is not None:
                span = (cs + src[a], cs + src[b - 1] + 1)
                yield "added", (ntid, norm[a:b], *span) if spans else [ntid]
                continue
            words = [[(tid, cs + st, cs + en) for tid, st, en in word]
                     for word in self._char_words(norm[a:b], src[a:b])]
            yield ("words", words) if spans else ("ids", [t[0] for w in words for t in w])

    def _aligned_normalized_items(self, piece: str, first: bool, base: int, av, spans: bool):
        """An aligned pipeline's piece (at byte `base`) with tokens matched
        on its normalized text: spans through the alignments."""
        ns = NormalizedString(piece)
        self._normalizer.normalize(ns)
        norm = ns.get()
        nb = char_to_byte_offsets(norm)
        al = ns.alignments
        for ntid, a, b in av.split(norm, True):
            b0, b1 = nb[a], nb[b]
            if ntid is not None:
                span = (base + al[b0][0], base + al[b1 - 1][1])
                yield "added", (ntid, norm[a:b], *span) if spans else [ntid]
                continue
            words = [[(t[0], t[1] + base, t[2] + base) + tuple(t[3:]) for t in word]
                     for word in self._aligned_ns_words(_ns_slice(ns, b0, b1), first and a == 0)]
            yield ("words", words) if spans else ("ids", [t[0] for w in words for t in w])

    def _aligned_word_spans(self, piece: str, first: bool):
        """`_word_spans` of the WordLevel, char-level BPE and Unigram
        pipelines: the normalizer on a NormalizedString, then
        `_aligned_ns_words`."""
        ns = NormalizedString(piece)
        if self._normalizer is not None:
            self._normalizer.normalize(ns)
        yield from self._aligned_ns_words(ns, first)

    def _aligned_ns_words(self, ns: NormalizedString, first: bool):
        """The words of the normalized `ns` (Metaspace's replacement and
        prepend applied; `first`: it starts the text): each token's byte
        span in its word mapped to the original bytes through the
        alignments.  A Unigram token also carries its string (an unk
        token's is the text it covers)."""
        pt, text = self._pre_tokenizer, ns.get()
        if isinstance(pt, Metaspace):
            pt.apply(ns, first)
            text = ns.get()
            spans = pt.word_spans(text)
        elif pt is None:
            spans = [(0, len(text))] if text else []
        else:
            spans = [(ws, we) for _w, ws, we in pt.pre_tokenize_spans(text)]
        cb, al = char_to_byte_offsets(text), ns.alignments
        for ws, we in spans:
            yield [(t[0], al[cb[ws] + t[1]][0], al[cb[ws] + t[2] - 1][1]) + t[3:]
                   for t in self._model.tokenize_spans(text[ws:we])]

    def _char_words(self, norm: str, src: List[int]):
        """The bert pipeline's words of normalized text `norm`, each token's
        span in the chars that `src` maps `norm`'s chars to."""
        for word, ws, _we in self._pre_tokenizer.pre_tokenize_spans(norm):
            yield [(tid, src[ws + ts], src[ws + te - 1] + 1)
                   for tid, ts, te in self._model.tokenize_spans(word)]

    def _word_spans(self, piece: str, first: bool):
        """Per word of a piece of text between added tokens, (id, start,
        end) of each token.  Spans are in the piece's chars for the bert
        pipeline (through the normalizer's source chars), else in its
        bytes (each word's in the prepared bytes, the prefix space
        undone; through the alignments for WordLevel and char-level
        BPE)."""
        if self.aligned:
            yield from self._aligned_word_spans(piece, first)
            return
        if self._normalizer is not None:
            yield from self._char_words(*self._normalizer.normalize_chars(piece))
            return
        pre, shift = self._pre_tokenizer.pre_tokenize_spans(piece)
        for word, ws, _we in pre:
            yield [(tid, max(ws + ts - shift, 0), max(ws + te - shift, 0))
                   for tid, ts, te in self._model.tokenize_spans(word)]

    def post_process(self, encoding: Encoding, pair_encoding: Optional[Encoding] = None,
                     add_special_tokens: bool = True) -> Encoding:
        """Truncate, then the post-processor (or `default_process`), then
        pad (reference `tokenizer/mod.rs:1206`)."""
        if self.truncation is not None:
            params = self.truncation
            n_added = self.num_special_tokens_to_add(pair_encoding is not None)
            if add_special_tokens and n_added > 0:
                params = TruncationParams(max(0, params.max_length - n_added), params.strategy,
                                          params.stride, params.direction)
            encoding, pair_encoding = truncate_encodings(encoding, pair_encoding, params)
        if self._post_processor is not None:
            final = self._post_processor.process(encoding, pair_encoding, add_special_tokens)
        else:
            encodings = [encoding] if pair_encoding is None else [encoding, pair_encoding]
            (final,) = default_process(encodings, add_special_tokens)
        if self.padding is not None:
            pad_encodings([final], self.padding)
        return final


class DecodeStream:
    """Incremental decoding (reference `tokenizer/mod.rs:1017-1127`): each
    `step` gives the text its ids add, or None while the text ends in a
    partial character (U+FFFD) or adds nothing; the ids already shown
    are dropped but for those the next step's text needs as its
    prefix."""

    __slots__ = ("tokenizer", "skip_special_tokens", "ids", "prefix", "prefix_index")

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True):
        self.tokenizer = tokenizer
        self.skip_special_tokens = skip_special_tokens
        self.ids: List[int] = []
        self.prefix = ""
        self.prefix_index = 0

    def step(self, id: int) -> Optional[str]:
        decode = self.tokenizer.decode
        if not self.prefix and self.ids:
            new_prefix = decode(self.ids, self.skip_special_tokens)
            if not new_prefix.endswith("\ufffd"):
                self.prefix = new_prefix
                self.prefix_index = len(self.ids)
        self.ids.append(id)
        string = decode(self.ids, self.skip_special_tokens)
        if len(string.encode("utf-8")) > len(self.prefix.encode("utf-8")) \
                and not string.endswith("\ufffd"):
            if not string.startswith(self.prefix):
                raise ValueError(f"Invalid prefix encountered while decoding stream. Token ID: "
                                 f"{self.ids[-1]}, Expected prefix: {self.prefix!r}, Actual "
                                 f"string: {string!r}")
            new_text = string[len(self.prefix):]
            new_prefix_index = len(self.ids) - self.prefix_index
            self.ids = self.ids[self.prefix_index:]
            self.prefix = decode(self.ids, self.skip_special_tokens)
            self.prefix_index = new_prefix_index
            return new_text
        return None
