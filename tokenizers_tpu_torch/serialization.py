"""Writing `tokenizer.json`; port of the writing half of
`tokenizers_tpu.serialization` (reference `tokenizer/serialization.rs`
and each component's serde).

`tokenizer_to_dict` gives `{version, truncation, padding, added_tokens,
normalizer, pre_tokenizer, post_processor, decoder, model}` with each
component a "type"-tagged object whose keys come in the reference's
order, so that `Tokenizer.to_str` (the JSON of it, `separators=(",",
":")`, `ensure_ascii=False`) is byte-equal to the reference's
`to_str`.  A component the port does not know (a custom decoder) raises
SerdeError.  The reading half has the JAX package's names: each
`*_from_dict` reads a component's node as the loader does
(`Tokenizer.from_str` goes through `tokenizer_from_dict`'s
`Tokenizer._from_dict`), and `trainer_from_json` reads the C ABI's
trainer configs.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, Optional

from . import decoders as D
from . import normalizers as N
from . import pre_tokenizers as P
from . import processors as PP
from .errors import SerdeError
from .models.bpe import BPE
from .models.unigram import Unigram
from .models.wordlevel import WordLevel
from .models.wordpiece import WordPiece
from .normalizers.bert import BertNormalizer
from .normalizers.precompiled import Precompiled
from .pre_tokenizers.bert import BertPreTokenizer
from .pre_tokenizers.byte_level import ByteLevel
from .pre_tokenizers.metaspace import Metaspace
from .pre_tokenizers.whitespace import Whitespace, WhitespaceSplit
from .utils.padding import BATCH_LONGEST, PaddingParams
from .utils.truncation import TruncationParams


def _pattern(p: str, regex: bool) -> Dict[str, str]:
    return {"Regex" if regex else "String": p}


def _byte_level(b: ByteLevel) -> Dict[str, Any]:
    return {"type": "ByteLevel", "add_prefix_space": b.add_prefix_space,
            "trim_offsets": b.trim_offsets, "use_regex": b.use_regex}


def _metaspace(m: Metaspace) -> Dict[str, Any]:
    return {"type": "Metaspace", "replacement": m.replacement,
            "prepend_scheme": m.prepend_scheme, "split": m.split}


_SIMPLE_NORMALIZERS = ((N.NFD, "NFD"), (N.NFKD, "NFKD"), (N.NFC, "NFC"), (N.NFKC, "NFKC"),
                       (N.Nmt, "Nmt"), (N.Lowercase, "Lowercase"),
                       (N.StripAccents, "StripAccents"))


def normalizer_to_dict(n) -> Optional[Dict[str, Any]]:
    if n is None:
        return None
    if isinstance(n, N.Sequence):
        return {"type": "Sequence", "normalizers": [normalizer_to_dict(x) for x in n.normalizers]}
    if isinstance(n, BertNormalizer):
        return {"type": "BertNormalizer", "clean_text": n.clean_text,
                "handle_chinese_chars": n.handle_chinese_chars, "strip_accents": n.strip_accents,
                "lowercase": n.lowercase}
    for cls, name in _SIMPLE_NORMALIZERS:
        if isinstance(n, cls):
            return {"type": name}
    if isinstance(n, N.Strip):
        return {"type": "Strip", "strip_left": n.left, "strip_right": n.right}
    if isinstance(n, N.Prepend):
        return {"type": "Prepend", "prepend": n.prepend}
    if isinstance(n, N.Replace):
        return {"type": "Replace", "pattern": _pattern(n.pattern, n.regex), "content": n.content}
    if isinstance(n, N.ByteLevel):
        return {"type": "ByteLevel"}
    if isinstance(n, Precompiled):
        return {"type": "Precompiled",
                "precompiled_charsmap": base64.b64encode(n.precompiled_charsmap).decode("ascii")}
    raise SerdeError(f"Cannot serialize normalizer {n!r}")


def pre_tokenizer_to_dict(p) -> Optional[Dict[str, Any]]:
    if p is None:
        return None
    if isinstance(p, P.Sequence):
        return {"type": "Sequence",
                "pretokenizers": [pre_tokenizer_to_dict(x) for x in p.pretokenizers]}
    if isinstance(p, P.Split):
        return {"type": "Split", "pattern": {p.pattern_kind: p.pattern_str},
                "behavior": P.BEHAVIOR_TO_JSON[p.behavior], "invert": p.invert}
    if isinstance(p, P.Punctuation):
        return {"type": "Punctuation", "behavior": P.BEHAVIOR_TO_JSON[p.behavior]}
    if isinstance(p, P.Digits):
        return {"type": "Digits", "individual_digits": p.individual_digits}
    if isinstance(p, P.CharDelimiterSplit):
        return {"type": "CharDelimiterSplit", "delimiter": p.delimiter}
    if isinstance(p, P.FixedLength):
        return {"type": "FixedLength", "length": p.length}
    if isinstance(p, P.UnicodeScripts):
        return {"type": "UnicodeScripts"}
    if isinstance(p, ByteLevel):
        return _byte_level(p)
    if isinstance(p, BertPreTokenizer):
        return {"type": "BertPreTokenizer"}
    if isinstance(p, Whitespace):
        return {"type": "Whitespace"}
    if isinstance(p, WhitespaceSplit):
        return {"type": "WhitespaceSplit"}
    if isinstance(p, Metaspace):
        return _metaspace(p)
    raise SerdeError(f"Cannot serialize pre-tokenizer {p!r}")


def _ordered_vocab(vocab_r: Dict[int, str]) -> Dict[str, int]:
    return {vocab_r[i]: i for i in sorted(vocab_r)}


def model_to_dict(m) -> Dict[str, Any]:
    if isinstance(m, BPE):
        return {"type": "BPE", "dropout": m.dropout, "unk_token": m.unk_token,
                "continuing_subword_prefix": m.continuing_subword_prefix,
                "end_of_word_suffix": m.end_of_word_suffix, "fuse_unk": m.fuse_unk,
                "byte_fallback": m.byte_fallback, "ignore_merges": m.ignore_merges,
                "vocab": _ordered_vocab(m.vocab_r),
                "merges": [list(pair) for pair in m.ranked_merges()]}
    if isinstance(m, WordPiece):
        return {"type": "WordPiece", "unk_token": m.unk_token,
                "continuing_subword_prefix": m.continuing_subword_prefix,
                "max_input_chars_per_word": m.max_input_chars_per_word,
                "vocab": _ordered_vocab(m.vocab_r)}
    if isinstance(m, WordLevel):
        return {"type": "WordLevel", "vocab": _ordered_vocab(m.vocab_r), "unk_token": m.unk_token}
    if isinstance(m, Unigram):
        return {"type": "Unigram", "unk_id": m.unk_id, "vocab": [[t, s] for t, s in m.pieces],
                "byte_fallback": m.byte_fallback}
    raise SerdeError(f"Cannot serialize model {m!r}")


def processor_to_dict(p) -> Optional[Dict[str, Any]]:
    if p is None:
        return None
    if isinstance(p, PP.Sequence):
        return {"type": "Sequence", "processors": [processor_to_dict(x) for x in p.processors]}
    if isinstance(p, PP.TemplateProcessing):
        return {"type": "TemplateProcessing",
                "single": [x.to_json() for x in p.single.pieces],
                "pair": [x.to_json() for x in p.pair.pieces],
                "special_tokens": {k: {"id": v.id, "ids": v.ids, "tokens": v.tokens}
                                   for k, v in sorted(p.special_tokens.items())}}
    if isinstance(p, PP.BertProcessing):
        return {"type": "BertProcessing", "sep": list(p.sep), "cls": list(p.cls)}
    if isinstance(p, PP.RobertaProcessing):
        return {"type": "RobertaProcessing", "sep": list(p.sep), "cls": list(p.cls),
                "trim_offsets": p.trim_offsets, "add_prefix_space": p.add_prefix_space}
    if isinstance(p, ByteLevel):
        return _byte_level(p)
    raise SerdeError(f"Cannot serialize processor {p!r}")


def decoder_to_dict(dec) -> Optional[Dict[str, Any]]:
    if dec is None:
        return None
    if isinstance(dec, D.Sequence):
        return {"type": "Sequence", "decoders": [decoder_to_dict(x) for x in dec.decoders]}
    if isinstance(dec, ByteLevel):
        return _byte_level(dec)
    if isinstance(dec, Metaspace):
        return _metaspace(dec)
    if isinstance(dec, D.WordPiece):
        return {"type": "WordPiece", "prefix": dec.prefix, "cleanup": dec.cleanup}
    if isinstance(dec, D.BPEDecoder):
        return {"type": "BPEDecoder", "suffix": dec.suffix}
    if isinstance(dec, D.ByteFallback):
        return {"type": "ByteFallback"}
    if isinstance(dec, D.Fuse):
        return {"type": "Fuse"}
    if isinstance(dec, D.Strip):
        return {"type": "Strip", "content": dec.content, "start": dec.start, "stop": dec.stop}
    if isinstance(dec, D.CTC):
        return {"type": "CTC", "pad_token": dec.pad_token,
                "word_delimiter_token": dec.word_delimiter_token, "cleanup": dec.cleanup}
    if isinstance(dec, D.Replace):
        return {"type": "Replace", "pattern": _pattern(dec.pattern, dec.regex),
                "content": dec.content}
    raise SerdeError(f"Cannot serialize decoder {dec!r}")


_STRATEGIES = {"longest_first": "LongestFirst", "only_first": "OnlyFirst",
               "only_second": "OnlySecond"}


def truncation_to_dict(t: Optional[TruncationParams]):
    if t is None:
        return None
    return {"direction": "Left" if t.direction == "left" else "Right",
            "max_length": t.max_length, "strategy": _STRATEGIES[t.strategy], "stride": t.stride}


def truncation_from_dict(d) -> Optional[TruncationParams]:
    if d is None:
        return None
    strategy = {v: k for k, v in _STRATEGIES.items()}[d.get("strategy", "LongestFirst")]
    return TruncationParams(d.get("max_length", 512), strategy, d.get("stride", 0),
                            d.get("direction", "Right").lower())


def padding_to_dict(p: Optional[PaddingParams]):
    if p is None:
        return None
    return {"strategy": "BatchLongest" if p.strategy == BATCH_LONGEST
            else {"Fixed": int(p.strategy)},
            "direction": "Left" if p.direction == "left" else "Right",
            "pad_to_multiple_of": p.pad_to_multiple_of, "pad_id": p.pad_id,
            "pad_type_id": p.pad_type_id, "pad_token": p.pad_token}


def padding_from_dict(d) -> Optional[PaddingParams]:
    if d is None:
        return None
    strategy = d.get("strategy", "BatchLongest")
    strategy = strategy["Fixed"] if isinstance(strategy, dict) else BATCH_LONGEST
    return PaddingParams(strategy, d.get("direction", "Right").lower(),
                         d.get("pad_to_multiple_of"), d.get("pad_id", 0),
                         d.get("pad_type_id", 0), d.get("pad_token", "[PAD]"))


def added_tokens_to_list(vocab) -> list:
    return [{"id": i, "content": t.content, "single_word": t.single_word, "lstrip": t.lstrip,
             "rstrip": t.rstrip, "normalized": t.normalized, "special": t.special}
            for i, t in sorted(vocab.added_tokens_map_r.items())]


def tokenizer_to_dict(tok) -> Dict[str, Any]:
    return {
        "version": "1.0",
        "truncation": truncation_to_dict(tok.truncation),
        "padding": padding_to_dict(tok.padding),
        "added_tokens": added_tokens_to_list(tok.added_vocabulary),
        "normalizer": normalizer_to_dict(tok.normalizer),
        "pre_tokenizer": pre_tokenizer_to_dict(tok.pre_tokenizer),
        "post_processor": processor_to_dict(tok.post_processor),
        "decoder": decoder_to_dict(tok.decoder),
        "model": model_to_dict(tok.model),
    }


def _merges(d: dict):
    return [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            for m in d.get("merges", [])]


def model_from_dict(d: dict):
    """The model of a tokenizer.json node, as the JAX package's
    `model_from_dict` reads it (a node without "type" guessed by its
    keys)."""
    t = d.get("type")
    if t is None:
        t = ("BPE" if "merges" in d else "WordPiece" if (
            "max_input_chars_per_word" in d or "continuing_subword_prefix" in d)
            else "Unigram" if "unk_id" in d else "WordLevel")
    if t == "BPE":
        return BPE(d.get("vocab", {}), _merges(d), unk_token=d.get("unk_token"),
                   fuse_unk=bool(d.get("fuse_unk", False)),
                   ignore_merges=bool(d.get("ignore_merges", False)),
                   continuing_subword_prefix=d.get("continuing_subword_prefix"),
                   end_of_word_suffix=d.get("end_of_word_suffix"),
                   byte_fallback=bool(d.get("byte_fallback", False)), dropout=d.get("dropout"))
    if t == "WordPiece":
        return WordPiece(d.get("vocab", {}), unk_token=d.get("unk_token", "[UNK]"),
                         continuing_subword_prefix=d.get("continuing_subword_prefix", "##"),
                         max_input_chars_per_word=int(d.get("max_input_chars_per_word", 100)))
    if t == "WordLevel":
        return WordLevel(d.get("vocab", {}), d.get("unk_token", "<unk>"))
    if t == "Unigram":
        return Unigram([(v[0], v[1]) for v in d.get("vocab", [])], unk_id=d.get("unk_id"),
                       byte_fallback=bool(d.get("byte_fallback", False)))
    raise SerdeError(f"Unknown model type: {t}")


def processor_from_dict(d: Optional[dict]):
    if d is None:
        return None
    t = d.get("type")
    if t == "TemplateProcessing":
        return PP.TemplateProcessing.from_json(d)
    if t == "BertProcessing":
        return PP.BertProcessing(tuple(d["sep"]), tuple(d["cls"]))
    if t == "RobertaProcessing":
        return PP.RobertaProcessing(tuple(d["sep"]), tuple(d["cls"]),
                                    d.get("trim_offsets", True), d.get("add_prefix_space", True))
    if t == "Sequence":
        return PP.Sequence([processor_from_dict(x) for x in d["processors"]])
    if t == "ByteLevel":
        return ByteLevel(d.get("add_prefix_space", True), d.get("trim_offsets", True),
                         d.get("use_regex", True))
    raise SerdeError(f"Unknown post-processor type: {t}")


normalizer_from_dict = N.from_json
pre_tokenizer_from_dict = P.from_json
decoder_from_dict = D.from_json


def tokenizer_from_dict(d: Dict[str, Any], device=None):
    """The Tokenizer of a tokenizer.json dict, on `device` (`pick_device`)."""
    from .tokenizer import Tokenizer

    return Tokenizer._from_dict(d, device)


def trainer_from_json(payload: str, device=None):
    """A trainer from a JSON config {"type": "BpeTrainer", ...kwargs}, the
    C ABI's trainer argument; counterpart of the JAX package's
    `trainer_from_json` (reference C binding: component configs as JSON
    payloads, `bindings/c/src/lib.rs`).  The trainers that run on a device
    take `device` unless the config names one."""
    import json

    from . import trainers as T
    from .added_vocabulary import AddedToken

    d = json.loads(payload)
    kind = d.pop("type")
    cls = {"BpeTrainer": T.BpeTrainer, "WordPieceTrainer": T.WordPieceTrainer,
           "WordLevelTrainer": T.WordLevelTrainer, "UnigramTrainer": T.UnigramTrainer}.get(kind)
    if cls is None:
        raise SerdeError(f"unknown trainer type {kind!r}")
    if "special_tokens" in d:
        d["special_tokens"] = [AddedToken(t, special=True) if isinstance(t, str)
                               else AddedToken(**t) for t in d["special_tokens"]]
    if device is not None and cls is not T.WordLevelTrainer:
        d.setdefault("device", device)
    return cls(**d)
