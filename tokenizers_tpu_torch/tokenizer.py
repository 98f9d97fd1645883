"""Tokenizer of the port: loads a `tokenizer.json` of the gpt2 shape and
encodes batches on the card.

The loader admits exactly the components of `tests/fixtures/gpt2`: a
plain BPE model, the ByteLevel pre-tokenizer with its regex split, the
ByteLevel post-processor and decoder (or none), no normalizer, and plain
special added tokens.  Anything else raises `NotImplementedError` naming
the later slice of the port that brings it.

`encode_batch_fast` runs the device engine (`ops/bpe_engine.py`) on the
tokenizer's device and the host pipeline for what the device does not
take.  The device is `cuda` unless the caller asks for `device="cpu"`,
where every kernel runs its plain PyTorch version.
"""

from __future__ import annotations

import json
import re
from typing import List, Optional, Sequence

from . import pick_device
from .encoding import Encoding
from .models.bpe import BPE
from .pre_tokenizers.byte_level import ByteLevel

_BYTE_LEVEL_KEYS = {"type", "add_prefix_space", "trim_offsets", "use_regex"}


def _unsupported(what: str, slice_name: str):
    raise NotImplementedError(f"{what} is not ported yet: it waits for {slice_name}")


def _load_model(d: dict) -> BPE:
    if d.get("type", "BPE") != "BPE":
        _unsupported(f"model {d.get('type')!r}", "its engine's slice of the port")
    if d.get("dropout") not in (None, 0.0):
        _unsupported("BPE dropout", "a later slice")
    if d.get("ignore_merges"):
        _unsupported("BPE ignore_merges", "the llama3 slice")
    if d.get("continuing_subword_prefix") or d.get("end_of_word_suffix"):
        _unsupported("BPE subword prefix/suffix", "the CharBPE slice")
    if d.get("byte_fallback"):
        _unsupported("BPE byte_fallback", "the CharBPE/SPM slice")
    merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
              for m in d.get("merges", [])]
    return BPE(d.get("vocab", {}), merges, unk_token=d.get("unk_token"),
               fuse_unk=bool(d.get("fuse_unk", False)))


def _load_byte_level(d: Optional[dict], role: str) -> Optional[ByteLevel]:
    if d is None:
        return None
    if d.get("type") != "ByteLevel" or set(d) - _BYTE_LEVEL_KEYS:
        _unsupported(f"{role} {d.get('type')!r}", "its engine's slice of the port")
    bl = ByteLevel(d.get("add_prefix_space", True), d.get("trim_offsets", True),
                   d.get("use_regex", True))
    if role == "pre_tokenizer" and not bl.use_regex:
        _unsupported("ByteLevel pre-tokenizer without its regex split", "the llama3 slice")
    return bl


class Tokenizer:
    def __init__(self, model: BPE, pre_tokenizer: ByteLevel,
                 added_tokens: Sequence[dict] = (),
                 post_processor: Optional[ByteLevel] = None,
                 decoder: Optional[ByteLevel] = None, device=None):
        self.model = model
        self.pre_tokenizer = pre_tokenizer
        self.post_processor = post_processor
        self.decoder = decoder
        self.device = pick_device(device)
        self.added = {t["content"]: t["id"] for t in added_tokens}
        contents = sorted(self.added, key=len, reverse=True)  # leftmost-longest
        self._added_re = re.compile("|".join(map(re.escape, contents))) if contents else None
        self._engine = None
        self._engine_built = False

    # ------------------------------------------------------------------ io

    @classmethod
    def from_str(cls, s: str, device=None) -> "Tokenizer":
        d = json.loads(s)
        if d.get("normalizer") is not None:
            _unsupported("a normalizer", "the WordPiece and Unigram slices")
        if d.get("truncation") is not None or d.get("padding") is not None:
            _unsupported("truncation and padding", "a later slice")
        added = d.get("added_tokens") or []
        for t in added:
            if not t.get("special") or t.get("single_word") or t.get("lstrip") or t.get("rstrip"):
                _unsupported(f"added token {t.get('content')!r} with these options", "a later slice")
        pt = _load_byte_level(d.get("pre_tokenizer"), "pre_tokenizer")
        if pt is None:
            _unsupported("a pipeline without the ByteLevel pre-tokenizer", "a later slice")
        return cls(
            _load_model(d["model"]), pt, added,
            post_processor=_load_byte_level(d.get("post_processor"), "post_processor"),
            decoder=_load_byte_level(d.get("decoder"), "decoder"),
            device=device,
        )

    @classmethod
    def from_file(cls, path: str, device=None) -> "Tokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_str(f.read(), device=device)

    # ---------------------------------------------------------------- encode

    def encode_batch_fast(self, inputs: Sequence[str],
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

    def _get_device_engine(self):
        """The device engine, built once; None when the vocab lacks a byte
        of the byte-level alphabet (everything then runs on the host)."""
        if not self._engine_built:
            from .ops.engine import build_device_engine

            self._engine = build_device_engine(self, self.device)
            self._engine_built = True
        return self._engine

    def encode_host(self, text: str, add_special_tokens: bool = True) -> Encoding:
        """The host pipeline: added tokens split out, the GPT-2 split and
        BPE on each piece between them."""
        ids: List[int] = []
        pos = 0
        matches = self._added_re.finditer(text) if self._added_re else ()
        for m in list(matches) + [None]:
            piece = text[pos : m.start() if m else len(text)]
            for word in self.pre_tokenizer.pre_tokenize(piece) if piece else ():
                ids.extend(self.model.tokenize(word))
            if m:
                ids.append(self.added[m.group()])
                pos = m.end()
        return self.post_process(Encoding(ids=ids), add_special_tokens)

    def post_process(self, encoding: Encoding, add_special_tokens: bool = True) -> Encoding:
        """The ByteLevel post-processor adds no tokens; it would trim
        offsets, which this slice does not track (they stay (0, 0))."""
        encoding.set_sequence_id(0)
        return encoding
