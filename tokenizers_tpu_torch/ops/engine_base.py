"""The host side of a device encode engine; port of
`tokenizers_tpu.ops.engine_base` for one card.

Routes inputs with added tokens to the host pipeline, splits long inputs
at tokenization-safe seams (`longdoc.py`), packs the rest into chunks
(`packing.py`), runs the engine's program over them, and re-encodes on
the host the rows the program flags `row_bad`.  There is no mesh: the
JAX package's `_shard_chunk` has no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..encoding import Encoding
from .longdoc import split_long
from .packing import MAX_L, pack_batch

CHUNK_TARGET = 1 << 15  # ~32KB device chunks for long documents


class FallbackStats:
    """Counters of the host-fallback residue: inputs routed to the host
    before the device runs (added tokens, long inputs with no safe seam)
    and rows the program flags `row_bad` (overlong words, buffer
    overflow).  Read by `chip_smoke.py` and the tests."""

    __slots__ = ("device_rows", "bad_rows", "host_pre_inputs",
                 "total_inputs", "patched_words")

    def __init__(self):
        self.reset()

    def reset(self):
        self.device_rows = 0  # work items sent to the program
        self.bad_rows = 0  # of those, flagged row_bad -> host re-encode
        self.host_pre_inputs = 0  # inputs host-routed before the device
        self.total_inputs = 0
        self.patched_words = 0  # per-word host splices (rows stay device)

    def snapshot(self) -> dict:
        return {
            "device_rows": self.device_rows,
            "bad_rows": self.bad_rows,
            "bad_row_fraction": (
                self.bad_rows / self.device_rows if self.device_rows else 0.0
            ),
            "host_pre_inputs": self.host_pre_inputs,
            "total_inputs": self.total_inputs,
            "patched_words": self.patched_words,
        }


STATS = FallbackStats()


class DeviceEngineBase:
    """Subclasses provide `tokenizer`, `add_prefix_space` and
    `_program_many(chunks)` -> per chunk (ids, ntok, row_bad[, patches])."""

    tokenizer = None
    add_prefix_space = False
    supports_offsets = False

    def _prepare(self, s: str) -> bytes:
        if self.add_prefix_space and not s.startswith(" "):
            s = " " + s
        return s.encode("utf-8")

    def _needs_host(self, s: str, added) -> bool:
        """An input holding an added token goes to the host pipeline,
        which extracts those before the model."""
        return any(t in s for t in added)

    def _split_long(self, data: bytes, target: int) -> List[bytes]:
        return split_long(data, target)

    def _apply_patches(self, prepared: bytes, row_ids, recs):
        """Splice host-encoded ids for flagged words into a device row.

        `recs`: patch records (row, col, wlen, tok_off, tok_cnt) of this
        row in ascending tok_off order; the host re-encodes each word and
        replaces the device's tok_cnt tokens at tok_off.  None when a word
        cannot be patched (the row falls back to the host pipeline)."""
        parts = []
        cur = 0
        for rec in recs:
            _r, col, wlen, ooff, kw = (int(x) for x in rec[:5])
            word_ids = self._encode_word_host(prepared, col, wlen)
            if word_ids is None or ooff < cur or ooff + kw > len(row_ids):
                return None
            parts.append(row_ids[cur:ooff])
            parts.append(np.asarray(word_ids, np.int32))
            cur = ooff + kw
        parts.append(row_ids[cur:])
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def _encode_word_host(self, prepared: bytes, col: int, wlen: int):
        """Host ids for one flagged word; None = cannot patch."""
        return None

    def _run_device(self, byte_strings: List[bytes]):
        """-> (per-input np.int32 ids or None, indices of bad inputs)."""
        results: List[Optional[np.ndarray]] = [None] * len(byte_strings)
        bad: List[int] = []
        chunks = pack_batch(byte_strings)
        for (_buf, _lengths, orig), out in zip(chunks, self._program_many(chunks)):
            ids, ntok, row_bad = (t.cpu().numpy() for t in out[:3])
            row_patches: dict = {}
            if len(out) > 3 and out[3] is not None:
                ptab, nflag = out[3]
                n = int(nflag)
                ptab = ptab.cpu().numpy()
                if 0 < n <= ptab.shape[0]:  # an overflow is already row_bad
                    for rec in ptab[:n]:
                        row_patches.setdefault(int(rec[0]), []).append(rec)
            for r, i in enumerate(orig):
                if row_bad[r]:
                    bad.append(i)
                    continue
                row_ids = ids[r, : ntok[r]]
                recs = row_patches.get(r)
                if recs:
                    row_ids = self._apply_patches(byte_strings[i], row_ids, recs)
                    STATS.patched_words += len(recs)
                    if row_ids is None:
                        bad.append(i)
                        continue
                results[i] = row_ids
        STATS.device_rows += len(byte_strings)
        STATS.bad_rows += len(bad)
        return results, bad

    def encode_batch(self, inputs: List[str], add_special_tokens: bool) -> List[Encoding]:
        added = list(self.tokenizer.added)
        encodings: List[Optional[Encoding]] = [None] * len(inputs)
        piece_strings: List[bytes] = []  # flattened device work items
        piece_owner: List[int] = []  # input index per work item
        host_idx: List[int] = []

        for i, s in enumerate(inputs):
            if self._needs_host(s, added):
                host_idx.append(i)
                continue
            data = self._prepare(s)
            if len(data) > MAX_L // 2:
                chunks = self._split_long(data, CHUNK_TARGET)
                if len(chunks) == 1:  # no safe seam: host path
                    host_idx.append(i)
                    continue
            else:
                chunks = [data]
            for c in chunks:
                piece_strings.append(c)
                piece_owner.append(i)

        STATS.total_inputs += len(inputs)
        STATS.host_pre_inputs += len(host_idx)
        if piece_strings:
            results, bad = self._run_device(piece_strings)
            bad_inputs = {piece_owner[j] for j in bad}
            per_input: dict = {}
            for j, ids in enumerate(results):
                owner = piece_owner[j]
                if owner in bad_inputs or ids is None:
                    continue
                per_input.setdefault(owner, []).append(ids)
            for i, parts in per_input.items():
                ids = np.concatenate(parts) if len(parts) > 1 else parts[0]
                encodings[i] = self.tokenizer.post_process(
                    Encoding(ids=ids.tolist()), add_special_tokens
                )
            host_idx.extend(sorted(bad_inputs))

        for i in host_idx:
            encodings[i] = self.tokenizer.encode_host(inputs[i], add_special_tokens)
        return encodings
