"""TemplateProcessing: special tokens laid out by a template; port of
`tokenizers_tpu.processors.template` (reference
`processors/template.rs`).

Templates are parsed from strings (`"[CLS]:0 $A:0 [SEP]:0 $B:1 [SEP]:1"`:
`$A`/`$B` or `$` with a type id are the sequences, anything else a
special token, each with an optional `:type_id`), from lists of such
strings or `Piece`s, or from their `tokenizer.json` form (`from_json`).
`process` lays the pieces out in order: each sequence takes its piece's
type id, each special token is inserted when `add_special_tokens`; a
pair takes the `pair` template, which must use both sequences.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence as Seq, Union

from ..encoding import Encoding
from . import PostProcessor


class Piece:
    """A sequence piece (`id` "A" or "B") or a special-token piece (`id` the
    token's key in `special_tokens`), with its type id."""

    __slots__ = ("kind", "id", "type_id")

    def __init__(self, kind: str, id: str, type_id: int):
        self.kind = kind  # "Sequence" | "SpecialToken"
        self.id = id
        self.type_id = type_id

    def __eq__(self, other):
        return (isinstance(other, Piece)
                and (self.kind, self.id, self.type_id) == (other.kind, other.id, other.type_id))

    def __repr__(self):
        return f"Piece({self.kind}, {self.id!r}, {self.type_id})"

    @staticmethod
    def _extract_id(s: str) -> Optional["Piece"]:
        if s.startswith("$"):
            rest = s[1:]
            if rest in ("", "A", "a"):
                return Piece("Sequence", "A", 0)
            if rest in ("B", "b"):
                return Piece("Sequence", "B", 0)
            try:
                type_id = int(rest)
            except ValueError:
                return None
            return Piece("Sequence", "A", type_id) if type_id >= 0 else None
        return Piece("SpecialToken", s, 0)

    @classmethod
    def parse(cls, s: str) -> "Piece":
        parts = s.split(":")
        piece = cls._extract_id(parts[0]) if len(parts) in (1, 2) else None
        if piece is None:
            raise ValueError(f'Cannot build Piece from string "{s}"')
        if len(parts) == 2:
            try:
                piece.type_id = int(parts[1])
            except ValueError:
                raise ValueError(f'Cannot build Piece from string "{s}"') from None
        return piece

    def to_json(self) -> dict:
        return {self.kind: {"id": self.id, "type_id": self.type_id}}

    @classmethod
    def from_json(cls, d: dict) -> "Piece":
        ((kind, body),) = d.items()
        return cls(kind, body["id"], int(body["type_id"]))


class SpecialToken:
    __slots__ = ("id", "ids", "tokens")

    def __init__(self, id: str, ids: List[int], tokens: Optional[List[str]] = None):
        if tokens is None:
            tokens = [id]
        if len(ids) != len(tokens):
            raise ValueError("SpecialToken: ids and tokens must be of the same length")
        self.id = id
        self.ids = list(ids)
        self.tokens = list(tokens)

    @classmethod
    def coerce(cls, v) -> "SpecialToken":
        """A SpecialToken, one of (token, id) / (id, token), or the wheel's
        dict {"id", "ids", "tokens"}."""
        if isinstance(v, SpecialToken):
            return v
        if isinstance(v, dict):
            return cls(v["id"], v["ids"], v.get("tokens"))
        if isinstance(v, tuple) and len(v) == 2:
            a, b = v
            return cls(a, [b], [a]) if isinstance(a, str) else cls(b, [a], [b])
        raise TypeError(f"Cannot build SpecialToken from {v!r}")


class Template:
    __slots__ = ("pieces",)

    def __init__(self, pieces: List[Piece]):
        self.pieces = pieces

    @classmethod
    def parse(cls, spec: Union[str, Seq]) -> "Template":
        parts = spec.split() if isinstance(spec, str) else list(spec)
        return cls([p if isinstance(p, Piece) else Piece.parse(p) for p in parts])


class TemplateProcessing(PostProcessor):
    def __init__(self, single: Union[str, Seq, Template] = "$0",
                 pair: Union[str, Seq, Template] = "$A:0 $B:1",
                 special_tokens: Optional[Seq] = None):
        self.single = single if isinstance(single, Template) else Template.parse(single)
        self.pair = pair if isinstance(pair, Template) else Template.parse(pair)
        self.special_tokens: Dict[str, SpecialToken] = {}
        for t in special_tokens or []:
            st = SpecialToken.coerce(t)
            self.special_tokens[st.id] = st
        self._validate()
        self._count()

    @classmethod
    def from_json(cls, d: dict) -> "TemplateProcessing":
        """The processor of its `tokenizer.json` entry, as it stands (the
        reference deserializes it without the constructor's checks)."""
        obj = cls.__new__(cls)
        obj.single = Template([Piece.from_json(x) for x in d.get("single", [])])
        obj.pair = Template([Piece.from_json(x) for x in d.get("pair", [])])
        obj.special_tokens = {v["id"]: SpecialToken(v["id"], v["ids"], v["tokens"])
                              for v in d.get("special_tokens", {}).values()}
        obj._count()
        return obj

    def _count(self) -> None:
        self.added_single = self._count_added(self.single)
        self.added_pair = self._count_added(self.pair)

    def _count_added(self, template: Template) -> int:
        return sum(len(self.special_tokens[p.id].ids) for p in template.pieces
                   if p.kind == "SpecialToken" and p.id in self.special_tokens)

    def _validate(self) -> None:
        seqs = {p.id for p in self.pair.pieces if p.kind == "Sequence"}
        if not {"A", "B"} <= seqs:
            raise ValueError("Template for `pair` must use both sequences")
        missing = {p.id for p in self.single.pieces + self.pair.pieces
                   if p.kind == "SpecialToken" and p.id not in self.special_tokens}
        if missing:
            raise ValueError(f"Missing SpecialToken(s) with id(s) `{', '.join(sorted(missing))}`")

    def added_tokens(self, is_pair: bool) -> int:
        return self.added_pair if is_pair else self.added_single

    def process_encodings(self, encodings: List[Encoding],
                          add_special_tokens: bool) -> List[Encoding]:
        if len(encodings) not in (1, 2):
            raise ValueError("encodings vector length must be either 1 or 2")
        template = self.pair if len(encodings) == 2 else self.single
        final: List[Encoding] = []
        for piece in template.pieces:
            if piece.kind == "Sequence":
                i = 0 if piece.id == "A" else 1
                encoding = encodings[i]
                encoding.type_ids = [piece.type_id] * len(encoding)
                encoding.set_sequence_id(i)
                final.append(encoding.copy())
            elif add_special_tokens:
                tok = self.special_tokens[piece.id]
                n = len(tok.ids)
                final.append(Encoding(
                    ids=list(tok.ids), type_ids=[piece.type_id] * n, tokens=list(tok.tokens),
                    words=[None] * n, offsets=[(0, 0)] * n, special_tokens_mask=[1] * n,
                    attention_mask=[1] * n))
        return final
