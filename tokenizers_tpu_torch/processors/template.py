"""TemplateProcessing for a single sequence; the part of
`tokenizers_tpu.processors.template` that `encode_batch_fast` needs.

The template is read from its `tokenizer.json` form: a list of pieces,
each `{"SpecialToken": {"id": ..., "type_id": ...}}` or
`{"Sequence": {"id": "A", "type_id": ...}}`, and a map of special tokens
to their ids and tokens.  `process` lays the pieces out in order: the
sequence takes its piece's type id, and each special token is inserted
when `add_special_tokens` (reference `processors/template.rs`).  The pair
template is not read: `encode_batch_fast` encodes single sequences.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..encoding import Encoding


class TemplateProcessing:
    def __init__(self, single: List[Tuple[str, str, int]],
                 special_tokens: Dict[str, Tuple[List[int], List[str]]]):
        """`single`: (kind, id, type_id) pieces, kind "Sequence" (id "A")
        or "SpecialToken"; `special_tokens`: id -> (ids, tokens)."""
        for kind, pid, _t in single:
            if kind == "SpecialToken" and pid not in special_tokens:
                raise ValueError(f"Missing SpecialToken(s) with id(s) `{pid}`")
            if kind == "Sequence" and pid != "A":
                raise ValueError(f"a single-sequence template has no sequence {pid!r}")
        self.single = single
        self.special_tokens = special_tokens

    @classmethod
    def from_json(cls, d: dict) -> "TemplateProcessing":
        single = []
        for piece in d["single"]:
            ((kind, body),) = piece.items()
            single.append((kind, body["id"], int(body["type_id"])))
        special = {k: (list(v["ids"]), list(v["tokens"]))
                   for k, v in d.get("special_tokens", {}).items()}
        return cls(single, special)

    def process(self, encoding: Encoding, add_special_tokens: bool = True) -> Encoding:
        parts = []
        for kind, pid, type_id in self.single:
            if kind == "Sequence":
                encoding.type_ids = [type_id] * len(encoding)
                encoding.set_sequence_id(0)
                parts.append(encoding.copy())
            elif add_special_tokens:
                ids, tokens = self.special_tokens[pid]
                n = len(ids)
                parts.append(Encoding(
                    ids=list(ids), type_ids=[type_id] * n, tokens=list(tokens),
                    words=[None] * n, offsets=[(0, 0)] * n,
                    special_tokens_mask=[1] * n, attention_mask=[1] * n,
                ))
        return Encoding.merge(parts, False)
