"""Tokenizer of the port: loads a `tokenizer.json` of the shapes below and
encodes batches on the card.

The loader admits exactly these pipelines, each with plain special added
tokens:

* gpt2 (`tests/fixtures/gpt2`): no normalizer, a plain BPE model, the
  ByteLevel pre-tokenizer with its regex split, the ByteLevel
  post-processor (or none) and the ByteLevel decoder (or none);
* llama3 (`tests/fixtures/llama3*`): no normalizer, BPE with
  `ignore_merges`, the Sequence of the llama-3 Split and ByteLevel
  without its regex or a prefix space, and a single-sequence
  TemplateProcessing (or no post-processor);
* bert (`tests/fixtures/bert`): BertNormalizer, BertPreTokenizer,
  WordPiece, a single-sequence TemplateProcessing (or none) and the
  WordPiece decoder (or none); its added tokens are matched on the raw
  text (`normalized: false`);
* WordLevel with Whitespace, WhitespaceSplit or BertPreTokenizer, and
  char-level BPE (unk token, `fuse_unk`, `byte_fallback`,
  `continuing_subword_prefix`, `end_of_word_suffix`) with those, with
  Metaspace (replacement `▁`, split) or with no pre-tokenizer; either
  with no normalizer or one of `normalizers.from_json` (Lowercase, NFD,
  NFKD, NFC, NFKC, StripAccents, Strip, Replace of a string, Prepend,
  BertNormalizer, a Sequence of them), a single-sequence
  TemplateProcessing (or none) and the BPEDecoder or Metaspace decoder
  (or none); added tokens `normalized: false`.  This covers the
  `CharBPETokenizer`, `SentencePieceBPETokenizer` and WordLevel recipes
  and the Llama-2 SPM shape;
* Unigram (`tests/fixtures/unigram`, `unigram_bf`: an unk id, with or
  without `byte_fallback`) with no normalizer or one of
  `normalizers.from_json`, Nmt and the `" {2,}"` regex Replace among
  them (the fixtures' Sequence; these two are admitted in this pipeline
  only), Metaspace (replacement `▁`, prepend scheme "always", split), no
  post-processor or a single-sequence TemplateProcessing; added tokens
  `normalized: false`.

Every pipeline takes any decoder of `decoders/` (`decoders.from_json`:
ByteLevel, Metaspace, WordPiece, BPEDecoder, ByteFallback, Fuse, Strip,
CTC, Replace and Sequences of them) or none.

Floats are parsed as the wheel's serde_json parses them
(`utils.serde_float.serde_f64`): Unigram's Viterbi ties turn on the last
ulp of its scores.

Anything else raises `NotImplementedError` naming the later slice of
the port that brings it.

`encode_batch_fast` (ids) and `encode_batch` (ids with char offsets,
token strings and word ids; `encode_batch_byte_offsets` for byte
offsets) run the device engine (`ops/engine.py`) on the tokenizer's
device and the host pipeline for what the device does not take.  The
device is `cuda` unless the caller asks for `device="cpu"`, where every
kernel runs its plain PyTorch version.  Pairs and pre-tokenized input
wait for a later slice.

`train` and `train_from_iterator` train the BPE, WordPiece, WordLevel or
Unigram model with a trainer of `trainers/` (BPE and WordPiece on the
trainer's device, Unigram's E-step and pruning statistics too) on the
words of `train_words`, then add the trainer's special tokens
(`add_special_tokens`) and drop the device engine.

`decode`, `decode_batch` (serial) and `decode_stream` (`DecodeStream`)
turn ids back into text on the host, as the reference does
(`tokenizer/mod.rs:1017-1127`, `:1329-1345`): each id's token from the
added tokens or the model, special ones dropped with
`skip_special_tokens`, through the decoder (tokens joined by spaces
without one).
"""

from __future__ import annotations

import json
import re
from typing import Iterable, List, Optional, Union

from . import pick_device
from .decoders import from_json as decoder_from_json
from .encoding import Encoding
from .models.bpe import BPE
from .models.unigram import Unigram
from .models.wordlevel import WordLevel
from .models.wordpiece import WordPiece
from .normalized import NormalizedString, char_to_byte_offsets
from .normalizers import Nmt, Replace
from .normalizers import Sequence as NormalizerSequence
from .normalizers import from_json as normalizer_from_json
from .normalizers.bert import BertNormalizer
from .pre_tokenizers.bert import BertPreTokenizer
from .pre_tokenizers.byte_level import ByteLevel, process_offsets
from .pre_tokenizers.metaspace import Metaspace
from .pre_tokenizers.split import LLAMA3_PATTERN, Sequence, Split
from .pre_tokenizers.whitespace import Whitespace, WhitespaceSplit
from .processors.template import TemplateProcessing
from .utils.serde_float import serde_f64

_BYTE_LEVEL_KEYS = {"type", "add_prefix_space", "trim_offsets", "use_regex"}
_BERT_NORMALIZER_KEYS = {"type", "clean_text", "handle_chinese_chars", "strip_accents",
                         "lowercase"}
_WORDPIECE_KEYS = {"type", "unk_token", "continuing_subword_prefix",
                   "max_input_chars_per_word", "vocab"}
_CHAR_BPE_KEYS = {"type", "dropout", "unk_token", "continuing_subword_prefix",
                  "end_of_word_suffix", "fuse_unk", "byte_fallback", "ignore_merges", "vocab",
                  "merges"}
_CLASS_SPLITS = {"Whitespace": Whitespace, "WhitespaceSplit": WhitespaceSplit,
                 "BertPreTokenizer": BertPreTokenizer}
_METASPACE_KEYS = {"type", "replacement", "prepend_scheme", "split"}
_UNIGRAM_KEYS = {"type", "unk_id", "vocab", "byte_fallback"}


def _unsupported(what: str, slice_name: str):
    raise NotImplementedError(f"{what} is not ported yet: it waits for {slice_name}")


def _single_sequences(inputs, is_pretokenized: bool) -> List[str]:
    inputs = list(inputs)
    if is_pretokenized:
        _unsupported("pre-tokenized input", "a later slice")
    if not all(isinstance(s, str) for s in inputs):
        _unsupported("pairs of sequences", "a later slice")
    return inputs


def _load_model(d: dict, llama3: bool) -> BPE:
    if d.get("type", "BPE") != "BPE":
        _unsupported(f"model {d.get('type')!r}", "its engine's slice of the port")
    if d.get("dropout") not in (None, 0.0):
        _unsupported("BPE dropout", "a later slice")
    if bool(d.get("ignore_merges")) != llama3:
        _unsupported("BPE ignore_merges outside the llama-3 pipeline" if not llama3 else
                     "the llama-3 pipeline without BPE ignore_merges", "a later slice")
    if d.get("continuing_subword_prefix") or d.get("end_of_word_suffix"):
        _unsupported("BPE subword prefix/suffix", "the CharBPE slice")
    if d.get("byte_fallback"):
        _unsupported("BPE byte_fallback", "the CharBPE/SPM slice")
    return BPE(d.get("vocab", {}), _merges(d), unk_token=d.get("unk_token"),
               fuse_unk=bool(d.get("fuse_unk", False)),
               ignore_merges=bool(d.get("ignore_merges", False)))


def _load_byte_level(d: Optional[dict], role: str) -> Optional[ByteLevel]:
    if d is None:
        return None
    if d.get("type") != "ByteLevel" or set(d) - _BYTE_LEVEL_KEYS:
        _unsupported(f"{role} {d.get('type')!r}", "its engine's slice of the port")
    bl = ByteLevel(d.get("add_prefix_space", True), d.get("trim_offsets", True),
                   d.get("use_regex", True))
    if role == "pre_tokenizer" and not bl.use_regex:
        _unsupported("ByteLevel pre-tokenizer without its regex split, outside the "
                     "llama-3 Sequence", "a later slice")
    return bl


def _load_llama3_sequence(d: dict) -> Sequence:
    """Exactly Sequence[Split(LLAMA3_PATTERN, Isolated), ByteLevel(use_regex=False,
    add_prefix_space=False)]."""
    pts = d.get("pretokenizers") or []
    if set(d) != {"type", "pretokenizers"} or len(pts) != 2:
        _unsupported("a Sequence pre-tokenizer other than the llama-3 one", "a later slice")
    sp, bl = pts
    if (sp != {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
               "behavior": "Isolated", "invert": False}):
        _unsupported("a Split other than the llama-3 pattern, Isolated", "a later slice")
    byte_level = _load_byte_level(bl, "Sequence member")
    if byte_level.use_regex or byte_level.add_prefix_space:
        _unsupported("a ByteLevel after the llama-3 Split with its regex or a prefix space",
                     "a later slice")
    return Sequence(Split(), byte_level)


def _load_bert(d: dict):
    """(normalizer, pre-tokenizer, model, decoder) of the BERT pipeline:
    exactly BertNormalizer, BertPreTokenizer, WordPiece and
    TemplateProcessing (or no post-processor)."""
    nz = d.get("normalizer")
    if nz is None or nz.get("type") != "BertNormalizer" or set(nz) - _BERT_NORMALIZER_KEYS:
        _unsupported("the BertPreTokenizer without its BertNormalizer", "a later slice")
    if d["pre_tokenizer"] != {"type": "BertPreTokenizer"}:
        _unsupported("a BertPreTokenizer with options", "a later slice")
    m = d["model"]
    if m.get("type") != "WordPiece" or set(m) - _WORDPIECE_KEYS:
        _unsupported(f"model {m.get('type')!r} in the BERT pipeline", "its engine's slice")
    pp = d.get("post_processor")
    if pp is not None and pp.get("type") != "TemplateProcessing":
        _unsupported(f"post-processor {pp.get('type')!r} in the BERT pipeline", "a later slice")
    normalizer = BertNormalizer(nz.get("clean_text", True), nz.get("handle_chinese_chars", True),
                                nz.get("strip_accents"), nz.get("lowercase", True))
    model = WordPiece(m.get("vocab", {}), unk_token=m.get("unk_token", "[UNK]"),
                      continuing_subword_prefix=m.get("continuing_subword_prefix", "##"),
                      max_input_chars_per_word=int(m.get("max_input_chars_per_word", 100)))
    return normalizer, BertPreTokenizer(), model, decoder_from_json(d.get("decoder"))


def _merges(d: dict):
    return [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            for m in d.get("merges", [])]


def _load_aligned(d: dict):
    """(normalizer, pre-tokenizer, model, post-processor, decoder) of a
    WordLevel, char-level BPE or Unigram pipeline, whose host offsets map
    through the normalizer's alignments."""
    nz = d.get("normalizer")
    normalizer = None if nz is None else normalizer_from_json(nz)
    pt_d, m = d.get("pre_tokenizer"), d["model"]
    if pt_d is None:
        pt = None
    elif pt_d.get("type") in _CLASS_SPLITS and set(pt_d) == {"type"}:
        pt = _CLASS_SPLITS[pt_d["type"]]()
    elif pt_d.get("type") == "Metaspace" and set(pt_d) <= _METASPACE_KEYS:
        if pt_d.get("replacement", "▁") != "▁" or not pt_d.get("split", True):
            _unsupported("Metaspace with a replacement other than '▁' or without its split",
                         "a later slice")
        pt = Metaspace(pt_d.get("prepend_scheme", "always"))
    else:
        _unsupported(f"pre-tokenizer {pt_d.get('type')!r} with these options", "a later slice")
    if m.get("type") == "Unigram":
        if set(m) - _UNIGRAM_KEYS or m.get("unk_id") is None:
            _unsupported("Unigram without an unk id or with these options", "a later slice")
        if not (isinstance(pt, Metaspace) and pt.prepend_scheme == "always"):
            _unsupported("Unigram without the Metaspace pre-tokenizer (prepend scheme "
                         "'always')", "a later slice")
        model = Unigram([(t, s) for t, s in m.get("vocab", [])], unk_id=int(m["unk_id"]),
                        byte_fallback=bool(m.get("byte_fallback", False)))
    elif m.get("type") == "WordLevel":
        if set(m) - {"type", "vocab", "unk_token"} or not isinstance(
                pt, (Whitespace, WhitespaceSplit, BertPreTokenizer)):
            _unsupported("WordLevel with these options or this pre-tokenizer", "a later slice")
        model = WordLevel(m.get("vocab", {}), m.get("unk_token", "<unk>"))
    else:
        if set(m) - _CHAR_BPE_KEYS:
            _unsupported(f"BPE options {sorted(set(m) - _CHAR_BPE_KEYS)}", "a later slice")
        if m.get("dropout") not in (None, 0.0):
            _unsupported("BPE dropout", "a later slice")
        if m.get("ignore_merges"):
            _unsupported("BPE ignore_merges outside the llama-3 pipeline", "a later slice")
        model = BPE(m.get("vocab", {}), _merges(m), unk_token=m.get("unk_token"),
                    fuse_unk=bool(m.get("fuse_unk", False)),
                    continuing_subword_prefix=m.get("continuing_subword_prefix"),
                    end_of_word_suffix=m.get("end_of_word_suffix"),
                    byte_fallback=bool(m.get("byte_fallback", False)), byte_spans=True)
    pp = d.get("post_processor")
    if pp is not None and pp.get("type") != "TemplateProcessing":
        _unsupported(f"post-processor {pp.get('type')!r} behind a "
                     f"{'no' if pt_d is None else pt_d.get('type')} pre-tokenizer",
                     "a later slice")
    if not isinstance(model, Unigram) and _unigram_only(normalizer):
        _unsupported("Nmt or a regex Replace outside the Unigram pipeline", "a later slice")
    return (normalizer, pt, model, _load_post_processor(pp, True),
            decoder_from_json(d.get("decoder")))


def _unigram_only(normalizer) -> bool:
    """Whether `normalizer` holds Nmt or a regex Replace: ported with the
    Unigram pipeline and held against the wheel only there."""
    parts = normalizer.normalizers if isinstance(normalizer, NormalizerSequence) else [normalizer]
    return any(isinstance(n, Nmt) or (isinstance(n, Replace) and n.regex) for n in parts)


def _load_post_processor(d: Optional[dict], template_ok: bool):
    if d is None or d.get("type") != "TemplateProcessing":
        return _load_byte_level(d, "post_processor")
    if not template_ok:
        _unsupported("TemplateProcessing outside the llama-3 and BERT pipelines",
                     "a later slice")
    pieces = [next(iter(p)) for p in d.get("single", [])]
    if pieces.count("Sequence") != 1:
        _unsupported("a template without exactly one sequence", "a later slice")
    return TemplateProcessing.from_json(d)


class Tokenizer:
    def __init__(self, model: Union[BPE, WordPiece, WordLevel, Unigram], pre_tokenizer,
                 added_tokens: Iterable[dict] = (),
                 post_processor: Union[ByteLevel, TemplateProcessing, None] = None,
                 decoder=None,
                 device=None, normalizer=None):
        self.model = model
        # WordLevel, char-level BPE and Unigram: offsets through the alignments
        self.aligned = isinstance(model, (WordLevel, Unigram)) or (
            isinstance(model, BPE) and not isinstance(pre_tokenizer, (ByteLevel, Sequence)))
        self.normalizer = normalizer
        self.pre_tokenizer = pre_tokenizer
        self.post_processor = post_processor
        self.decoder = decoder
        self.device = pick_device(device)
        self.added = {t["content"]: t["id"] for t in added_tokens}
        contents = sorted(self.added, key=len, reverse=True)  # leftmost-longest
        self._added_re = re.compile("|".join(map(re.escape, contents))) if contents else None
        self._engine = None
        self._engine_built = False
        self._added_r = None  # id -> added token, built at first decode

    # ------------------------------------------------------------------ io

    @classmethod
    def from_str(cls, s: str, device=None) -> "Tokenizer":
        d = json.loads(s, parse_float=serde_f64)
        pt_d = d.get("pre_tokenizer")
        pt_type = None if pt_d is None else pt_d.get("type")
        m_type = d["model"].get("type", "BPE")
        bert = pt_type == "BertPreTokenizer" and m_type == "WordPiece"
        aligned = m_type in ("WordLevel", "Unigram") or (m_type == "BPE" and pt_type in (
            None, "Whitespace", "WhitespaceSplit", "BertPreTokenizer", "Metaspace"))
        nz_d = d.get("normalizer")
        if nz_d is not None and not (bert or aligned):
            _unsupported("a normalizer in a byte-level pipeline", "a later slice")
        if d.get("truncation") is not None or d.get("padding") is not None:
            _unsupported("truncation and padding", "a later slice")
        added = d.get("added_tokens") or []
        for t in added:
            if not t.get("special") or t.get("single_word") or t.get("lstrip") or t.get("rstrip"):
                _unsupported(f"added token {t.get('content')!r} with these options", "a later slice")
            if (bert or aligned) and t.get("normalized"):
                _unsupported(f"added token {t.get('content')!r} matched on normalized text",
                             "a later slice")
        if aligned:
            normalizer, pt, model, pp, decoder = _load_aligned(d)
            return cls(model, pt, added, post_processor=pp, decoder=decoder, device=device,
                       normalizer=normalizer)
        if bert:
            normalizer, pt, model, decoder = _load_bert(d)
            return cls(model, pt, added,
                       post_processor=_load_post_processor(d.get("post_processor"), True),
                       decoder=decoder, device=device, normalizer=normalizer)
        if pt_d is not None and pt_d.get("type") == "Sequence":
            pt = _load_llama3_sequence(pt_d)
        else:
            pt = _load_byte_level(pt_d, "pre_tokenizer")
        if pt is None:
            _unsupported("a pipeline without the ByteLevel pre-tokenizer", "a later slice")
        llama3 = isinstance(pt, Sequence)
        return cls(
            _load_model(d["model"], llama3), pt, added,
            post_processor=_load_post_processor(d.get("post_processor"), llama3),
            decoder=decoder_from_json(d.get("decoder")),
            device=device,
        )

    @classmethod
    def from_file(cls, path: str, device=None) -> "Tokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_str(f.read(), device=device)

    # ---------------------------------------------------------------- encode

    def encode_batch_fast(self, inputs: Iterable[str],
                          add_special_tokens: bool = True) -> List[Encoding]:
        """Ids of each input (no offsets), through the device engine."""
        inputs = list(inputs)
        if not all(isinstance(s, str) for s in inputs):
            raise TypeError("encode_batch_fast takes a sequence of str")
        engine = self._get_device_engine()
        if engine is None:
            return [self.encode_host(s, add_special_tokens) for s in inputs]
        return engine.encode_batch(inputs, add_special_tokens)

    def encode_fast(self, sequence: str, add_special_tokens: bool = True) -> Encoding:
        return self.encode_batch_fast([sequence], add_special_tokens)[0]

    def _encode_batch(self, inputs, is_pretokenized: bool, add_special_tokens: bool,
                      offsets: str) -> List[Encoding]:
        inputs = _single_sequences(inputs, is_pretokenized)
        engine = self._get_device_engine()
        if engine is None or not engine.supports_offsets:
            return [self.encode_host(s, add_special_tokens, offsets=offsets) for s in inputs]
        return engine.encode_batch_offsets(inputs, add_special_tokens, offsets)

    def encode_batch(self, inputs: Iterable[str], is_pretokenized: bool = False,
                     add_special_tokens: bool = True) -> List[Encoding]:
        """Ids with char offsets, token strings and word ids, as the
        reference's Python binding gives them."""
        return self._encode_batch(inputs, is_pretokenized, add_special_tokens, "char")

    def encode_batch_char_offsets(self, inputs: Iterable[str], is_pretokenized: bool = False,
                                  add_special_tokens: bool = True) -> List[Encoding]:
        return self._encode_batch(inputs, is_pretokenized, add_special_tokens, "char")

    def encode_batch_byte_offsets(self, inputs: Iterable[str], is_pretokenized: bool = False,
                                  add_special_tokens: bool = True) -> List[Encoding]:
        """As `encode_batch`, with byte offsets (the reference's Rust
        default), each widened to whole chars."""
        return self._encode_batch(inputs, is_pretokenized, add_special_tokens, "byte")

    def _encode(self, sequence, pair, is_pretokenized, add_special_tokens, offsets):
        if pair is not None:
            _unsupported("pairs of sequences", "a later slice")
        return self._encode_batch([sequence], is_pretokenized, add_special_tokens, offsets)[0]

    def encode(self, sequence: str, pair=None, is_pretokenized: bool = False,
               add_special_tokens: bool = True) -> Encoding:
        return self._encode(sequence, pair, is_pretokenized, add_special_tokens, "char")

    def encode_char_offsets(self, sequence: str, pair=None, is_pretokenized: bool = False,
                            add_special_tokens: bool = True) -> Encoding:
        return self._encode(sequence, pair, is_pretokenized, add_special_tokens, "char")

    def encode_byte_offsets(self, sequence: str, pair=None, is_pretokenized: bool = False,
                            add_special_tokens: bool = True) -> Encoding:
        return self._encode(sequence, pair, is_pretokenized, add_special_tokens, "byte")

    def encode_batch_arrays(self, inputs: Iterable[str]):
        """Per packed chunk (ids, ntok, row_bad, (input, piece) of each row),
        the ids left on the device (`DeviceEngineBase.encode_batch_arrays`)."""
        engine = self._get_device_engine()
        if engine is None:
            raise RuntimeError("this tokenizer has no device engine")
        return engine.encode_batch_arrays(_single_sequences(inputs, False))

    # ----------------------------------------------------------------- train

    def train(self, files: Iterable[str], trainer=None) -> "Tokenizer":
        """Train the model on the lines of `files` (each with its ending)."""
        from .utils.iter import file_lines_with_ending

        return self.train_from_iterator(file_lines_with_ending(files), trainer)

    def train_from_iterator(self, iterator: Iterable[str], trainer=None,
                            length: Optional[int] = None) -> "Tokenizer":
        """Feed the trainer the words of each sequence (`train_words`: the
        host pipeline's normalizer and pre-tokenizer; an added token is a
        word of its own), train the model, add the trainer's special
        tokens, and drop the device engine so that the next encode builds
        its tables from the trained model.  Without a trainer the model's
        default one runs on this tokenizer's device.  `length` is accepted
        for the reference's surface; there is no progress bar."""
        if trainer is None:
            trainer = self.model.get_trainer(device=self.device)
        trainer.feed(iterator, self.train_words)
        special_tokens = trainer.train(self.model)
        self.add_special_tokens(special_tokens)
        return self

    def train_words(self, sequence: str) -> List[str]:
        """The words a trainer counts in `sequence`, as the reference's
        `Tokenizer::train` gives them: the added tokens split out of the
        raw text, each a word of its own, and on each piece between them
        the normalizer and the pre-tokenizer (Metaspace prepends to each
        piece as its scheme says)."""
        words: List[str] = []
        pos = 0
        pt = self.pre_tokenizer
        matches = self._added_re.finditer(sequence) if self._added_re else ()
        for m in list(matches) + [None]:
            piece = sequence[pos : m.start() if m else len(sequence)]
            text = piece if self.normalizer is None else self.normalizer.normalize_str(piece)
            if not text:
                pass
            elif isinstance(pt, Metaspace):
                words.extend(pt.pre_tokenize(text, pos == 0))
            elif pt is None:
                words.append(text)
            else:
                words.extend(pt.pre_tokenize(text))
            if m:
                words.append(m.group())
                pos = m.end()
        return words

    def add_special_tokens(self, tokens) -> int:
        """Add special tokens (strings or `trainers.AddedToken`), matched on
        the raw text: a token in the model's vocab keeps its id, another
        takes the next id past the vocab and the added tokens.  Returns how
        many were new; drops the device engine."""
        added = 0
        for t in tokens:
            content = getattr(t, "content", t)
            if not content or content in self.added:
                continue
            tid = self.model.vocab.get(content)
            if tid is None:
                size = len(self.model.vocab)
                top = max(self.added.values(), default=None)
                tid = top + 1 if top is not None and (top >= size or size == 0) else size
            self.added[content] = tid
            added += 1
        contents = sorted(self.added, key=len, reverse=True)  # leftmost-longest
        self._added_re = re.compile("|".join(map(re.escape, contents))) if contents else None
        self._engine = None
        self._engine_built = False
        self._added_r = None
        return added

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.added.get(token)
        return tid if tid is not None else self.model.vocab.get(token)

    def id_to_token(self, id: int) -> Optional[str]:
        """The added token of `id`, else the model's token (None if neither
        has it)."""
        if self._added_r is None:
            self._added_r = {v: k for k, v in self.added.items()}
        tok = self._added_r.get(id)
        if tok is not None:
            return tok
        return self.model.vocab_r.get(id)

    # ---------------------------------------------------------------- decode

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        """The text of `ids`: each id's token (unknown ids dropped; the added
        tokens, all special, dropped with `skip_special_tokens`) through
        the decoder, or joined by spaces without one."""
        tokens = []
        for i in ids:
            token = self.id_to_token(int(i))
            if token is None or (skip_special_tokens and token in self.added):
                continue
            tokens.append(token)
        if self.decoder is not None:
            return self.decoder.decode(tokens)
        return " ".join(tokens)

    def decode_batch(self, sequences: Iterable[Iterable[int]],
                     skip_special_tokens: bool = True) -> List[str]:
        """`decode` of each sequence, serially."""
        return [self.decode(ids, skip_special_tokens) for ids in sequences]

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)

    def _get_device_engine(self):
        """The device engine, built once; None when the vocab lacks a byte
        of the byte-level alphabet or two whole-word entries collide
        (everything then runs on the host)."""
        if not self._engine_built:
            from .ops.engine import build_device_engine

            self._engine = build_device_engine(self, self.device)
            self._engine_built = True
        return self._engine

    def encode_host(self, text: str, add_special_tokens: bool = True,
                    offsets: Optional[str] = None) -> Encoding:
        """The host pipeline: added tokens split out of the raw text, then
        on each piece between them the normalizer, the pre-tokenizer's
        split and the model, then the template.  With `offsets` ("char" or
        "byte") it also gives each token's offsets, string and word index
        (an added token is a word of its own); without, ids only."""
        if offsets is not None:
            return self._encode_host_offsets(text, add_special_tokens, offsets)
        ids: List[int] = []
        pos = 0
        matches = self._added_re.finditer(text) if self._added_re else ()
        for m in list(matches) + [None]:
            piece = text[pos : m.start() if m else len(text)]
            if piece and self.aligned:
                for word in self._aligned_word_spans(piece, pos == 0):
                    ids.extend(t[0] for t in word)
            elif piece:
                if self.normalizer is not None:
                    piece = self.normalizer.normalize_chars(piece)[0]
                for word in self.pre_tokenizer.pre_tokenize(piece):
                    ids.extend(self.model.tokenize(word))
            if m:
                ids.append(self.added[m.group()])
                pos = m.end()
        return self.post_process(Encoding(ids=ids), add_special_tokens)

    def _aligned_word_spans(self, piece: str, first: bool):
        """`_word_spans` of the WordLevel, char-level BPE and Unigram
        pipelines: the normalizer (and Metaspace's replacement and prepend;
        `first`: the piece starts the text) on a NormalizedString, the
        pre-tokenizer's words in its text, each token's byte span in its
        word mapped to the piece's original bytes through the alignments.
        A Unigram token also carries its string (an unk token's is the text
        it covers)."""
        ns = NormalizedString(piece)
        if self.normalizer is not None:
            self.normalizer.normalize(ns)
        pt, text = self.pre_tokenizer, ns.get()
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
                   for t in self.model.tokenize_spans(text[ws:we])]

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
        if self.normalizer is not None:
            norm, src = self.normalizer.normalize_chars(piece)
            for word, ws, _we in self.pre_tokenizer.pre_tokenize_spans(norm):
                yield [(tid, src[ws + ts], src[ws + te - 1] + 1)
                       for tid, ts, te in self.model.tokenize_spans(word)]
            return
        pre, shift = self.pre_tokenizer.pre_tokenize_spans(piece)
        for word, ws, _we in pre:
            yield [(tid, max(ws + ts - shift, 0), max(ws + te - shift, 0))
                   for tid, ts, te in self.model.tokenize_spans(word)]

    def _encode_host_offsets(self, text: str, add_special_tokens: bool,
                             offsets: str) -> Encoding:
        """`encode_host` with offsets.  Spans are taken in the text's chars
        (bert) or bytes (`_word_spans`) and mapped to chars or whole-char
        bytes as the device's spans are (`engine_base.map_offsets`)."""
        from .ops.engine_base import map_offsets

        chars = isinstance(self.model, WordPiece)  # the unit of the spans

        def size(s: str) -> int:
            return len(s) if chars else len(s.encode("utf-8"))

        ids, tokens, words, starts, ends = [], [], [], [], []
        pos = base = 0  # the next piece's start, in chars and in span units

        def add(tid, token, st, en):
            ids.append(tid)
            tokens.append(token)
            words.append(n_words)
            starts.append(st)
            ends.append(en)

        n_words = 0
        matches = self._added_re.finditer(text) if self._added_re else ()
        for m in list(matches) + [None]:
            piece = text[pos : m.start() if m else len(text)]
            if piece:
                for word in self._word_spans(piece, pos == 0):
                    for t in word:
                        add(t[0], t[3] if len(t) > 3 else self.model.vocab_r[t[0]],
                            base + t[1], base + t[2])
                    n_words += 1
                base += size(piece)
            if m:
                n = size(m.group())
                add(self.added[m.group()], m.group(), base, base + n)
                n_words += 1
                pos, base = m.end(), base + n
        enc = Encoding(ids=ids, tokens=tokens, words=words,
                       offsets=map_offsets(text, starts, ends, offsets,
                                           "char" if chars else "byte"))
        return self.post_process(enc, add_special_tokens, with_offsets=True)

    def post_process(self, encoding: Encoding, add_special_tokens: bool = True,
                     with_offsets: bool = False) -> Encoding:
        """The template's special tokens and type ids; with offsets tracked,
        the ByteLevel post-processor's trimming of spaces from them
        (`trim_offsets`).  It adds no tokens."""
        if isinstance(self.post_processor, TemplateProcessing):
            return self.post_processor.process(encoding, add_special_tokens)
        if with_offsets and self.post_processor is not None and self.post_processor.trim_offsets:
            process_offsets(encoding, self.post_processor.add_prefix_space)
        encoding.set_sequence_id(0)
        return encoding


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
