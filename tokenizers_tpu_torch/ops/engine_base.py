"""The host side of a device encode engine; port of
`tokenizers_tpu.ops.engine_base` for one card.

Routes inputs with added tokens to the host pipeline, splits long inputs
at tokenization-safe seams (`longdoc.py`), packs the rest into chunks
(`packing.py`), runs the engine's program over them, and re-encodes on
the host the rows the program flags `row_bad`.  Over a default mesh of
more than one rank (`parallel/runtime.py`) each rank runs its contiguous
block of every chunk's rows through the engine's cache-free program
(`_program_sharded`, the JAX package's `_shard_chunk`) and every rank
gets every row back; the host re-encodes of flagged rows then run on
every rank alike.  The offsets path is not sharded, as in JAX.

With offsets (`encode_batch_offsets`) the engine's offsets program gives
each token's span in its piece, in the engine's `offsets_space`:
"prepared_bytes" (byte-level BPE: the piece's bytes, a prefix space
included), "original_chars" (WordPiece: the chars of the original text,
tracked through the normalizer on the device) or "normalized_bytes"
(WordLevel, char-level BPE: the bytes of the text as normalized on the
host, `_prepare_aligned`, whose NormalizedString maps each span back to
the original bytes: its start from the first byte's alignment, its end
from the last byte's, as the reference's `convert_offsets` does).  The
pieces of a long input are re-based (in bytes or chars, and word ids),
the prefix space is undone, and the spans are mapped to the original
text's chars or bytes.

An engine may take pieces narrower than MAX_L // 2 (`_piece_max`): a
longer input is split at safe seams into pieces of at most that, and one
with a piece still longer goes to the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..encoding import Encoding
from .longdoc import split_long
from .packing import MAX_L, pack_batch

CHUNK_TARGET = 1 << 15  # ~32KB device chunks for long documents


def _offset_tables(text: str):
    """(UTF-8 bytes, char index of each byte, byte position of each char)."""
    data = np.frombuffer(text.encode("utf-8"), np.uint8)
    is_start = (data & 0xC0) != 0x80
    cidx = np.cumsum(is_start) - 1 if len(data) else np.zeros(0, np.int64)
    return data, cidx, np.flatnonzero(is_start)


def _bytes_to_chars(text: str, starts: np.ndarray, ends: np.ndarray):
    """Byte spans of `text` -> char spans, each widened to whole chars: a
    span that starts or ends inside a char takes the whole char, as the
    reference's alignments give every byte of a char the char's span."""
    data, cidx, _ = _offset_tables(text)
    n = len(data)
    if n == 0:
        return starts * 0, ends * 0
    st = cidx[np.clip(starts, 0, n - 1)]
    en = np.where(ends > starts, cidx[np.clip(ends - 1, 0, n - 1)] + 1, st)
    return st.astype(np.int64), en.astype(np.int64)


def _expand_bytes(text: str, starts: np.ndarray, ends: np.ndarray):
    """Byte spans of `text` widened to char boundaries (byte offsets)."""
    data, cidx, char_pos = _offset_tables(text)
    n = len(data)
    if n == 0:
        return starts * 0, ends * 0
    st = char_pos[cidx[np.clip(starts, 0, n - 1)]]
    nxt = cidx[np.clip(ends - 1, 0, n - 1)] + 1
    en = np.where(nxt < len(char_pos), char_pos[np.clip(nxt, 0, len(char_pos) - 1)], n)
    en = np.where(ends > starts, en, st)
    return st.astype(np.int64), en.astype(np.int64)


def _chars_to_bytes(text: str, starts: np.ndarray, ends: np.ndarray):
    """Char spans of `text` -> byte spans."""
    data, _cidx, char_pos = _offset_tables(text)
    n = len(data)
    if n == 0:
        return starts * 0, ends * 0
    cp = np.concatenate([char_pos, [n]])
    m = len(cp) - 1
    return cp[np.clip(starts, 0, m)].astype(np.int64), cp[np.clip(ends, 0, m)].astype(np.int64)


def map_offsets(text: str, starts, ends, kind: str, unit: str = "byte"):
    """Spans of `text` in `unit`s ("byte" or "char") as the offsets of
    `kind`: "char" (char positions, the Python binding's) or "byte" (byte
    positions widened to whole chars).  Returns a list of (start, end)."""
    st, en = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    if unit == "char":
        if kind == "byte":
            st, en = _chars_to_bytes(text, st, en)
    else:
        st, en = (_bytes_to_chars if kind == "char" else _expand_bytes)(text, st, en)
    return list(zip(st.tolist(), en.tolist()))


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
    `_program_many(chunks)` -> per chunk (ids, ntok, row_bad[, patches]),
    and for the mesh path `_program(buf, lengths)` or `_program_mesh`."""

    tokenizer = None
    add_prefix_space = False
    supports_offsets = False
    offsets_space = "prepared_bytes"  # or "original_chars", "normalized_bytes"

    def _piece_max(self, offsets: bool) -> int:
        """The longest prepared piece the program takes (of the offsets
        program where `offsets`)."""
        return MAX_L // 2

    def _prepare_aligned(self, s: str):
        """(prepared bytes, NormalizedString or None): the offsets path's
        preparation in the "normalized_bytes" space, whose spans map back
        through the NormalizedString (None: the prepared text is the
        original)."""
        return self._prepare(s), None

    def _prepare(self, s: str) -> bytes:
        """UTF-8 bytes of `s`, after the prefix space where the
        pre-tokenizer adds one (never to an empty input: it has no word)."""
        if self.add_prefix_space and s and not s.startswith(" "):
            s = " " + s
        return s.encode("utf-8")

    def _needs_host(self, s: str, added) -> bool:
        """An input holding an added token (`added`: their contents) goes to
        the host pipeline, which extracts those before the model: in its
        raw text, or, for a token matched on the normalized text, in that
        (`AddedVocabulary.needs_host`)."""
        return self.tokenizer.added_vocabulary.needs_host(s, self.tokenizer.normalizer)

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

    # ------------------------------------------------------------ the mesh

    def _program_mesh(self, buf: np.ndarray, lengths: np.ndarray, rows: int):
        """A rank's block of a chunk of `rows` rows through the program
        each rank runs on the mesh; the engines whose program carries a
        word cache run theirs without it (no mutable cache across ranks, as
        in JAX), and those whose buffers are sized by the chunk size them
        for the whole chunk (JAX's mesh program has the global shape).  A
        block fills those buffers with its own words only, so where the
        whole chunk overflows, the ranks flag fewer rows than JAX's mesh
        program: the flags fall as ranks are added."""
        return self._program(buf, lengths)

    def _program_sharded(self, chunks, mesh) -> List[tuple]:
        """`_program_many` over `mesh`: each chunk's rows padded to a
        multiple of the mesh's ranks, this rank's contiguous block through
        `_program_mesh`, and the outputs gathered in rank order, so every
        rank returns every chunk whole.  Patch records carry a row of the
        rank's block: rebased by its first row before they are gathered
        (a rank's records are dropped where they overflowed its table: its
        rows are flagged then, as one chunk's are)."""
        from ..parallel.runtime import gather_cat, mesh_group

        group, rank, n = mesh_group(mesh)
        out = []
        for buf, lengths, _orig in chunks:
            rows = -(-buf.shape[0] // n) * n
            if rows != buf.shape[0]:
                buf = np.pad(buf, ((0, rows - buf.shape[0]), (0, 0)))
                lengths = np.pad(lengths, (0, rows - lengths.shape[0]))
            lo, per = rank * (rows // n), rows // n
            res = self._program_mesh(buf[lo:lo + per], lengths[lo:lo + per], rows)
            # ids past a row's count are -1 (a program's width may follow
            # its rows' longest: the ranks' widths differ then)
            gathered = (gather_cat(res[0], group, fill=-1),) + tuple(
                gather_cat(t, group) for t in res[1:3])
            if len(res) > 3 and res[3] is not None:
                ptab, nflag = res[3]
                k = int(nflag)
                recs = ptab[:k].clone() if k <= ptab.shape[0] else ptab[:0]
                recs[:, 0] += lo
                recs = gather_cat(recs, group)
                gathered += ((recs, recs.shape[0]),)
            out.append(gathered)
        return out

    def _programs(self, chunks) -> List[tuple]:
        """`_program_many`, or `_program_sharded` over the default mesh
        when it has more than one rank."""
        from ..parallel.runtime import sharded_mesh

        mesh = sharded_mesh()
        return self._program_many(chunks) if mesh is None else self._program_sharded(chunks, mesh)

    def _run_device(self, byte_strings: List[bytes]):
        """-> (per-input np.int32 ids or None, indices of bad inputs)."""
        results: List[Optional[np.ndarray]] = [None] * len(byte_strings)
        bad: List[int] = []
        chunks = pack_batch(byte_strings)
        for (_buf, _lengths, orig), out in zip(chunks, self._programs(chunks)):
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

    def _pieces(self, data: bytes, offsets: bool) -> Optional[List[bytes]]:
        """The prepared input `data` as the program's pieces: whole, or
        split at safe seams when longer than `_piece_max`; None when it
        has no seam or a piece is still too long (the host takes it)."""
        limit = self._piece_max(offsets)
        if len(data) <= limit:
            return [data]
        chunks = self._split_long(data, min(CHUNK_TARGET, limit))
        if len(chunks) == 1 or max(map(len, chunks)) > limit:
            return None
        return chunks

    def _work_items(self, inputs: List[str], offsets: bool = False):
        """(pieces, owner of each piece, inputs for the host, the
        NormalizedString of each input in the "normalized_bytes" space
        with `offsets`): each input without an added token, prepared, in
        pieces (`_pieces`; to the host when it has none)."""
        added = list(self.tokenizer.added)
        piece_strings: List[bytes] = []  # flattened device work items
        piece_owner: List[int] = []  # input index per work item
        host_idx: List[int] = []
        aligned = offsets and self.offsets_space == "normalized_bytes"
        input_ns: dict = {}
        for i, s in enumerate(inputs):
            if self._needs_host(s, added):
                host_idx.append(i)
                continue
            if aligned:
                data, input_ns[i] = self._prepare_aligned(s)
            else:
                data = self._prepare(s)
            chunks = self._pieces(data, offsets)
            if chunks is None:
                host_idx.append(i)
                continue
            piece_strings += chunks
            piece_owner += [i] * len(chunks)
        STATS.total_inputs += len(inputs)
        STATS.host_pre_inputs += len(host_idx)
        return piece_strings, piece_owner, host_idx, input_ns

    def encode_batch(self, inputs: List[str], add_special_tokens: bool) -> List[Encoding]:
        encodings: List[Optional[Encoding]] = [None] * len(inputs)
        piece_strings, piece_owner, host_idx, _ = self._work_items(inputs)
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
                    Encoding(ids=ids.tolist()), None, add_special_tokens
                )
            host_idx.extend(sorted(bad_inputs))

        for i in host_idx:
            encodings[i] = self.tokenizer.encode_host(inputs[i], add_special_tokens)
        return encodings

    # ---------------------------------------------------------- with offsets

    def _run_device_offsets(self, byte_strings: List[bytes]):
        """-> (per-input (ids, starts, ends, word ids) or None, indices of
        bad inputs); spans in each input's prepared bytes."""
        results: List[Optional[tuple]] = [None] * len(byte_strings)
        bad: List[int] = []
        for buf, lengths, orig in pack_batch(byte_strings):
            ids, ntok, row_bad, starts, ends, words = (
                t.cpu().numpy() for t in self._program_offsets(buf, lengths))
            for r, i in enumerate(orig):
                if row_bad[r]:
                    bad.append(i)
                    continue
                n = ntok[r]
                results[i] = (ids[r, :n], starts[r, :n], ends[r, :n], words[r, :n])
        STATS.device_rows += len(byte_strings)
        STATS.bad_rows += len(bad)
        return results, bad

    def encode_batch_offsets(self, inputs: List[str], add_special_tokens: bool,
                             kind: str) -> List[Encoding]:
        """Ids with offsets of `kind` ("char" or "byte", `map_offsets`),
        token strings and word ids: the reference's `encode_batch` surface.
        Inputs the device does not take, and rows it flags, run the host
        pipeline with the same offsets."""
        encodings: List[Optional[Encoding]] = [None] * len(inputs)
        piece_strings, piece_owner, host_idx, input_ns = self._work_items(inputs, True)
        if piece_strings:
            results, bad = self._run_device_offsets(piece_strings)
            bad_inputs = {piece_owner[j] for j in bad}
            chars = self.offsets_space == "original_chars"
            per_input: dict = {}
            base: dict = {}  # input -> (span base, word base) of its next piece
            for j, res in enumerate(results):
                owner = piece_owner[j]
                sbase, wbase = base.get(owner, (0, 0))
                piece = piece_strings[j]
                base[owner] = (sbase + (len(piece.decode("utf-8")) if chars else len(piece)),
                               wbase + (int(res[3].max()) + 1 if res is not None
                                        and len(res[3]) else 0))
                if owner in bad_inputs or res is None:
                    continue
                ids, st, en, wd = res
                per_input.setdefault(owner, []).append(
                    (ids, st + sbase, en + sbase, wd + wbase))
            for i, parts in per_input.items():
                ids, st, en, wd = (np.concatenate(x) for x in zip(*parts))
                if self.add_prefix_space and not inputs[i].startswith(" "):
                    # prepared -> original bytes: undo the prefix space
                    st, en = np.maximum(st - 1, 0), np.maximum(en - 1, 0)
                ns = input_ns.get(i)
                if ns is not None and len(ns):
                    # normalized -> original bytes through the alignments
                    a = np.asarray(ns.alignments, np.int64)
                    st0 = a[np.clip(st, 0, len(a) - 1), 0]
                    en = np.where(en > st, a[np.clip(en - 1, 0, len(a) - 1), 1], st0)
                    st = st0
                idl = ids.tolist()
                enc = Encoding(ids=idl, tokens=self._token_strings(idl, inputs[i], st, en),
                               words=wd.tolist(),
                               offsets=map_offsets(inputs[i], st, en, kind,
                                                   "char" if chars else "byte"))
                encodings[i] = self.tokenizer.post_process(enc, None, add_special_tokens)
            host_idx.extend(sorted(bad_inputs))

        for i in host_idx:
            encodings[i] = self.tokenizer.encode_host(inputs[i], add_special_tokens,
                                                      offsets=kind)
        return encodings

    def _token_strings(self, ids, text=None, st=None, en=None):
        """Token strings of `ids`; `st`, `en`: the tokens' spans in `text`
        (chars in the "original_chars" space), for engines whose token
        strings depend on the text (Unigram's unk)."""
        vr = self.tokenizer.model.vocab_r
        return [vr[t] for t in ids]

    def encode_batch_arrays(self, inputs: List[str]):
        """Ids that stay on the device: per packed chunk (ids, ntok,
        row_bad, (input index, piece index) of each row), from the engine's
        program.  A long input is split at safe seams as in `encode_batch`
        into pieces, which may land in different chunks; their ids
        concatenate in piece order.  Nothing goes to
        the host: a flagged row's ids are not the input's (the caller
        re-encodes it; the JAX package's version returns no flags).  The
        rows of an input holding an added token are flagged too: the
        program encodes it as plain bytes; so are rows with per-word patch
        records (Unigram), which lack the host's ids of those words.  An
        input that `_pieces` cannot
        cut into the program's pieces raises ValueError."""
        added = list(self.tokenizer.added)
        byte_strings: List[bytes] = []
        owners: List[tuple] = []
        host = [self._needs_host(s, added) for s in inputs]
        for i, s in enumerate(inputs):
            data = self._prepare(s)
            chunks = self._pieces(data, False)
            if chunks is None:
                raise ValueError(
                    f"input {i} is {len(data)} bytes with no tokenization-safe seam "
                    f"into pieces of at most {self._piece_max(False)}; encode_batch "
                    f"takes it to the host")
            byte_strings += chunks
            owners += [(i, k) for k in range(len(chunks))]
        out = []
        chunks = pack_batch(byte_strings)
        for (_buf, _lens, orig), res in zip(chunks, self._programs(chunks)):
            row_owners = [owners[j] for j in orig]
            row_bad = res[2]
            if len(res) > 3 and res[3] is not None:
                # rows with patch records lack the host's ids of those words
                ptab, nflag = res[3]
                patched = torch.zeros_like(row_bad)
                patched[ptab[:min(int(nflag), ptab.shape[0]), 0].to(torch.int64)] = True
                row_bad = row_bad | patched
            if any(host[i] for i, _k in row_owners):
                # the chunk may hold padding rows past the owned ones
                flags = [host[i] for i, _k in row_owners]
                flags += [False] * (row_bad.shape[0] - len(flags))
                row_bad = row_bad | torch.tensor(flags, device=row_bad.device)
            out.append((res[0], res[1], row_bad, row_owners))
        return out
