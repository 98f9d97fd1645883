"""Decoders: token strings -> text; copy of `tokenizers_tpu.decoders`
(reference `tokenizers/src/decoders/`), host only.

Each decoder's `decode_chain` maps a list of token strings to another,
and `decode` joins the chain's result.  The ByteLevel and Metaspace
pre-tokenizers of `pre_tokenizers/` play the decoder role too (their
`decode_chain`).  `from_json` reads a `tokenizer.json` decoder entry
(JAX `serialization.decoder_from_dict`).
"""

from __future__ import annotations

from typing import List, Optional

from ..pattern import SysRegex
from ..pre_tokenizers.byte_level import ByteLevel
from ..pre_tokenizers.metaspace import Metaspace


class Decoder:
    def decode(self, tokens: List[str]) -> str:
        return "".join(self.decode_chain(tokens))

    def decode_chain(self, tokens: List[str]) -> List[str]:
        raise NotImplementedError

    @staticmethod
    def custom(obj) -> "CustomDecoder":
        """Wrap a user object with a `decode(List[str]) -> str` method
        (reference `bindings/python/src/decoders.rs`)."""
        return CustomDecoder(obj)


class CustomDecoder(Decoder):
    def __init__(self, obj):
        if not callable(getattr(obj, "decode", None)):
            raise TypeError("custom decoder must have a decode(List[str]) -> str method")
        self.obj = obj

    def decode(self, tokens: List[str]) -> str:
        return self.obj.decode(tokens)

    def decode_chain(self, tokens: List[str]) -> List[str]:
        if callable(getattr(self.obj, "decode_chain", None)):
            return self.obj.decode_chain(tokens)
        return [self.obj.decode(tokens)]


class Sequence(Decoder):
    def __init__(self, decoders: List):
        self.decoders = list(decoders)

    def decode_chain(self, tokens: List[str]) -> List[str]:
        for d in self.decoders:
            tokens = d.decode_chain(tokens)
        return tokens

    def __getitem__(self, i):
        return self.decoders[i]

    def __len__(self):
        return len(self.decoders)


class BPEDecoder(Decoder):
    """The end-of-word suffix becomes a space, and nothing on the last
    token (reference `decoders/bpe.rs:10`)."""

    def __init__(self, suffix: str = "</w>"):
        self.suffix = suffix

    def decode_chain(self, tokens: List[str]) -> List[str]:
        n = len(tokens) - 1
        return [token.replace(self.suffix, "" if i == n else " ") for i, token in enumerate(tokens)]


def wordpiece_cleanup(s: str) -> str:
    """(reference `decoders/wordpiece.rs:31-44`)"""
    return (
        s.replace(" .", ".")
        .replace(" ?", "?")
        .replace(" !", "!")
        .replace(" ,", ",")
        .replace(" ' ", "'")
        .replace(" n't", "n't")
        .replace(" 'm", "'m")
        .replace(" do not", " don't")
        .replace(" 's", "'s")
        .replace(" 've", "'ve")
        .replace(" 're", "'re")
    )


class WordPiece(Decoder):
    """The continuation prefix comes off a token, any other token but the
    first takes a space before it; `cleanup` undoes the tokenization's
    spaces around punctuation (reference `decoders/wordpiece.rs`)."""

    def __init__(self, prefix: str = "##", cleanup: bool = True):
        self.prefix = prefix
        self.cleanup = bool(cleanup)

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out = []
        for i, token in enumerate(tokens):
            if i != 0:
                if token.startswith(self.prefix):
                    token = token[len(self.prefix):]
                else:
                    token = " " + token
            if self.cleanup:
                token = wordpiece_cleanup(token)
            out.append(token)
        return out


_HEX = frozenset("0123456789abcdefABCDEF")


def _fallback_byte(token: str) -> Optional[int]:
    """The byte of a `<0xXX>` token, else None: Rust's
    `u8::from_str_radix(&token[3..5], 16)` (ASCII hex digits, an optional
    leading '+') on a token of 6 bytes."""
    if len(token) != 6 or not token.isascii() or not token.startswith("<0x") \
            or not token.endswith(">"):
        return None
    digits = token[3:5]
    body = digits[1:] if digits[0] == "+" else digits
    return int(body, 16) if body and set(body) <= _HEX else None


class ByteFallback(Decoder):
    """Runs of `<0xXX>` tokens become the text of their bytes, or one
    U+FFFD a byte where they are not UTF-8 (reference
    `decoders/byte_fallback.rs:11`)."""

    def decode_chain(self, tokens: List[str]) -> List[str]:
        new_tokens: List[str] = []
        previous_bytes: List[int] = []

        def flush():
            if previous_bytes:
                try:
                    new_tokens.append(bytes(previous_bytes).decode("utf-8"))
                except UnicodeDecodeError:
                    new_tokens.extend(["�"] * len(previous_bytes))
                previous_bytes.clear()

        for token in tokens:
            byte = _fallback_byte(token)
            if byte is not None:
                previous_bytes.append(byte)
            else:
                flush()
                new_tokens.append(token)
        flush()
        return new_tokens


class CTC(Decoder):
    """Repeats folded, the pad token removed, the word delimiter a space
    (reference `decoders/ctc.rs:14`)."""

    def __init__(self, pad_token: str = "<pad>", word_delimiter_token: str = "|",
                 cleanup: bool = True):
        self.pad_token = pad_token
        self.word_delimiter_token = word_delimiter_token
        self.cleanup = bool(cleanup)

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out = []
        prev = None
        for token in tokens:
            if token == prev:
                continue
            prev = token
            replaced = token.replace(self.pad_token, "")
            if self.cleanup:
                replaced = wordpiece_cleanup(replaced).replace(self.word_delimiter_token, " ")
            if replaced:
                out.append(replaced)
        return out


class Fuse(Decoder):
    def decode_chain(self, tokens: List[str]) -> List[str]:
        return ["".join(tokens)]


class Strip(Decoder):
    """Up to `start` leading and `stop` trailing copies of `content` off
    each token (reference `decoders/strip.rs:11`)."""

    def __init__(self, content: str = " ", start: int = 0, stop: int = 0):
        self.content = content
        self.start = start
        self.stop = stop

    def decode_chain(self, tokens: List[str]) -> List[str]:
        out = []
        for token in tokens:
            start_cut = 0
            for i, c in enumerate(token):
                if i >= self.start or c != self.content:
                    break
                start_cut = i + 1
            stop_cut = len(token)
            for i, c in enumerate(reversed(token)):
                if i >= self.stop or c != self.content:
                    break
                stop_cut = len(token) - i - 1
            out.append(token[start_cut:stop_cut])
        return out


class Replace(Decoder):
    """A pattern replaced by `content` in each token (reference
    `normalizers/replace.rs:82-96`, the decoder role): a literal string,
    or a regex of the reference's syntax (`pattern.SysRegex`: `\\w` and
    `\\s` are Oniguruma's classes, as in the JAX package)."""

    def __init__(self, pattern: str, content: str, regex: bool = False):
        self.pattern, self.content, self.regex = pattern, content, regex
        self._re = SysRegex(pattern) if regex else None

    def decode_chain(self, tokens: List[str]) -> List[str]:
        if self._re is not None:
            return [self._re.compiled.sub(lambda _m: self.content, t) for t in tokens]
        if not self.pattern:
            return list(tokens)
        return [t.replace(self.pattern, self.content) for t in tokens]


def from_json(d: Optional[dict]):
    """The decoder of a `tokenizer.json` entry (None for none)."""
    if d is None:
        return None
    t = d.get("type")
    if t == "Sequence":
        return Sequence([from_json(x) for x in d["decoders"]])
    if t == "ByteLevel":
        return ByteLevel(d.get("add_prefix_space", True), d.get("trim_offsets", True),
                         d.get("use_regex", True))
    if t == "Metaspace":
        prepend_scheme = d.get("prepend_scheme", "always")
        if d.get("add_prefix_space") is False:
            prepend_scheme = "never"
        return Metaspace(d.get("replacement", "▁"), prepend_scheme, d.get("split", True))
    if t == "WordPiece":
        return WordPiece(d.get("prefix", "##"), d.get("cleanup", True))
    if t == "BPEDecoder":
        return BPEDecoder(d.get("suffix", "</w>"))
    if t == "ByteFallback":
        return ByteFallback()
    if t == "Fuse":
        return Fuse()
    if t == "Strip":
        return Strip(d.get("content", " "), d.get("start", 0), d.get("stop", 0))
    if t == "CTC":
        return CTC(d.get("pad_token", "<pad>"), d.get("word_delimiter_token", "|"),
                   d.get("cleanup", True))
    if t == "Replace":
        pat = d["pattern"]
        if "Regex" in pat:
            return Replace(pat["Regex"], d["content"], regex=True)
        return Replace(pat["String"], d["content"])
    raise ValueError(f"Unknown decoder type: {t}")


__all__ = ["Decoder", "CustomDecoder", "Sequence", "BPEDecoder", "WordPiece", "ByteFallback",
           "CTC", "Fuse", "Strip", "Replace", "ByteLevel", "Metaspace", "wordpiece_cleanup",
           "from_json"]
