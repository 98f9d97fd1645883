"""Post-processors: special tokens, type ids and the trimming of offsets;
port of `tokenizers_tpu.processors` (reference `processors/`).

`PostProcessor.process` sets each sequence's id and type id, runs the
processor's `process_encodings` and merges the results (with their
overflowing windows crossed, `Encoding.merge_with`); `default_process`
is what a tokenizer without a post-processor does.  `BertProcessing`
(`[CLS] A [SEP] B [SEP]`, type ids 0 and 1), `RobertaProcessing`
(`<s> A </s> </s> B </s>`, type ids 0, the ByteLevel trimming of
offsets), `TemplateProcessing` (`template.py`), `Sequence` of them, and
the ByteLevel pre-tokenizer in its post-processor role (trimming only).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..encoding import Encoding


class PostProcessor:
    def added_tokens(self, is_pair: bool) -> int:
        raise NotImplementedError

    def process_encodings(self, encodings: List[Encoding],
                          add_special_tokens: bool) -> List[Encoding]:
        raise NotImplementedError

    def process(self, encoding: Encoding, pair_encoding: Optional[Encoding] = None,
                add_special_tokens: bool = True) -> Encoding:
        """(reference `tokenizer/mod.rs:96-118`)"""
        return process_pair(self, encoding, pair_encoding, add_special_tokens)


def process_pair(processor, encoding: Encoding, pair_encoding: Optional[Encoding],
                 add_special_tokens: bool) -> Encoding:
    """`PostProcessor.process` of any object with `process_encodings`."""
    encodings = [encoding] if pair_encoding is None else [encoding, pair_encoding]
    for i, enc in enumerate(encodings):
        enc.set_sequence_id(i)
        for overflow in enc.overflowing:
            overflow.set_sequence_id(i)
        enc.type_ids = [i] * len(enc)
    out = processor.process_encodings(encodings, add_special_tokens)
    # merging one encoding gives a copy of it: the processor's result is new
    # or the caller's own, so it is returned as it is
    return out[0] if len(out) == 1 else Encoding.merge(out, False)


def default_process(encodings: List[Encoding], add_special_tokens: bool) -> List[Encoding]:
    """(reference `tokenizer/mod.rs:127-146`)"""
    if len(encodings) == 1:
        return encodings
    final = Encoding()
    for i, enc in enumerate(encodings):
        enc.set_sequence_id(i)
        final.merge_with(enc, False)
    return [final]


class Sequence(PostProcessor):
    def __init__(self, processors: List):
        self.processors = list(processors)

    def added_tokens(self, is_pair: bool) -> int:
        return sum(p.added_tokens(is_pair) for p in self.processors)

    def process_encodings(self, encodings, add_special_tokens):
        for p in self.processors:
            encodings = p.process_encodings(encodings, add_special_tokens)
        return encodings

    def __getitem__(self, i):
        return self.processors[i]

    def __len__(self):
        return len(self.processors)


def _wrap(enc: Encoding, head: List[Tuple[str, int]], tail: List[Tuple[str, int]], seq: int,
          special_type: int = 0, body_type: Optional[int] = None) -> Encoding:
    """`enc` between the special tokens `head` and `tail`, these of type id
    `special_type`, its own tokens of `body_type` (None: their own)."""
    n, h, t = len(enc.ids), len(head), len(tail)
    body = enc.type_ids if body_type is None else [body_type] * n
    out = Encoding(
        ids=[i for _s, i in head] + enc.ids + [i for _s, i in tail],
        type_ids=[special_type] * h + body + [special_type] * t,
        tokens=[s for s, _i in head] + enc.tokens + [s for s, _i in tail],
        words=[None] * h + enc.words + [None] * t,
        offsets=[(0, 0)] * h + enc.offsets + [(0, 0)] * t,
        special_tokens_mask=[1] * h + [0] * n + [1] * t, attention_mask=[1] * (h + n + t))
    out.sequence_ranges = {seq: range(h, h + n)}
    return out


class BertProcessing(PostProcessor):
    """`[CLS] A [SEP] (B [SEP])` with type ids 0 and 1
    (reference `processors/bert.rs`)."""

    def __init__(self, sep: Tuple[str, int] = ("[SEP]", 102),
                 cls: Tuple[str, int] = ("[CLS]", 101)):
        self.sep = tuple(sep)
        self.cls = tuple(cls)

    def added_tokens(self, is_pair: bool) -> int:
        return 3 if is_pair else 2

    def process_encodings(self, encodings, add_special_tokens):
        if not add_special_tokens:
            return encodings
        out = []
        for i, encoding in enumerate(encodings):
            if i == 0:
                wrap = lambda e: _wrap(e, [self.cls], [self.sep], 0)  # noqa: E731
            else:
                wrap = lambda e: _wrap(e, [], [self.sep], 1, special_type=1)  # noqa: E731
            new = wrap(encoding)
            new.overflowing = [wrap(o) for o in encoding.overflowing]
            out.append(new)
        return out


class RobertaProcessing(PostProcessor):
    """`<s> A </s> (</s> B </s>)`, every type id 0, and the ByteLevel
    trimming of offsets (reference `processors/roberta.rs`)."""

    def __init__(self, sep: Tuple[str, int] = ("</s>", 2), cls: Tuple[str, int] = ("<s>", 0),
                 trim_offsets: bool = True, add_prefix_space: bool = True):
        self.sep = tuple(sep)
        self.cls = tuple(cls)
        self.trim_offsets = trim_offsets
        self.add_prefix_space = add_prefix_space

    def added_tokens(self, is_pair: bool) -> int:
        return 4 if is_pair else 2

    def process_encodings(self, encodings, add_special_tokens):
        from ..pre_tokenizers.byte_level import process_offsets

        if self.trim_offsets:
            for encoding in encodings:
                process_offsets(encoding, self.add_prefix_space)
                for o in encoding.overflowing:
                    process_offsets(o, self.add_prefix_space)
        for encoding in encodings:
            encoding.type_ids = [0] * len(encoding)
        if not add_special_tokens:
            return encodings
        out = []
        for i, encoding in enumerate(encodings):
            if i == 0:
                wrap = lambda e: _wrap(e, [self.cls], [self.sep], 0)  # noqa: E731
            else:
                wrap = lambda e: _wrap(e, [self.sep], [self.sep], 1, body_type=0)  # noqa: E731
            new = wrap(encoding)
            new.overflowing = [wrap(o) for o in encoding.overflowing]
            out.append(new)
        return out


from .template import Piece, SpecialToken, Template, TemplateProcessing  # noqa: E402
from ..pre_tokenizers.byte_level import ByteLevel  # noqa: E402  (the post-processor role)

__all__ = ["PostProcessor", "Sequence", "BertProcessing", "RobertaProcessing",
           "TemplateProcessing", "SpecialToken", "Piece", "Template", "ByteLevel",
           "default_process", "process_pair"]
