"""Host-side batch packing: list[str] -> bucketed uint8[B, L] byte tensors.

The device programs are compiled per (B, L, ascii) variant; compile cost is
a first-class performance axis of this architecture (each variant is a
minutes-long XLA compile whose serialized executable must also load fast on
warm start), so packing is designed to mint as FEW variants as possible:

  * byte-lengths bucket to powers of two, and each bucket is chunked so
    B*L stays near a fixed position budget (also a power of two);
  * within a bucket that spans multiple chunks, the TAIL chunk is padded
    with empty rows up to the same row count as the full chunks — one
    canonical (B, L) shape per bucket instead of a data-dependent tail
    shape (r4 postmortem: the tail variants alone put 3 distinct compile
    keys on the flagship bench config);
  * a bucket that fits in a single partial chunk keeps power-of-two rows
    (small interactive batches stay small).

Pure-ASCII strings bucket apart from the rest so a handful of non-ASCII
docs can't disqualify whole chunks from the ASCII fast paths (expand=1 BPE
grids, dedup'd WordPiece); the ascii flag selects a different program, not
a different shape, so this costs no extra shape variants.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

MIN_L = 64
MAX_L = 1 << 17  # strings longer than this fall back to the host path
import os as _os

POSITION_BUDGET = 1 << 21  # ~2M byte positions per device call


def _position_budget() -> int:
    # TOKENIZERS_TPU_POSITION_BUDGET: override for experiments and for
    # tests that want bench-realistic doc LENGTHS in CPU-compilable
    # chunks (read per call, not at import, so test setup can set it).
    # The r2 8M-position experiment measured +24% throughput but OOM'd
    # the remote compile helper; r3 measured element-PASS-bound costs.
    return int(
        _os.environ.get("TOKENIZERS_TPU_POSITION_BUDGET", POSITION_BUDGET)
    )


def bucket_length(n: int) -> int:
    L = MIN_L
    while L < n:
        L <<= 1
    return L


def _pow2_rows(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def pack_batch(
    byte_strings: Sequence[bytes],
) -> List[Tuple[np.ndarray, np.ndarray, List[int]]]:
    """Group byte strings into (bytes u8[B,L], lengths i32[B], orig_indices)
    chunks.  Rows beyond len(orig_indices) are zero-length padding (callers
    iterate orig_indices).  Every input is returned — `bucket_length` keeps
    doubling past MAX_L, so callers wanting the MAX_L bound must pre-split
    or reject oversized strings themselves (see DeviceEngineBase)."""
    buckets = {}
    for i, s in enumerate(byte_strings):
        L = bucket_length(len(s))
        # pure-ASCII docs grouped apart from the rest: the ascii flag picks
        # the fast program variant, and mixing would disqualify the chunk
        buckets.setdefault((L, s.isascii()), []).append(i)

    out = []
    budget = _position_budget()
    for (L, _is_ascii), idxs in sorted(buckets.items()):
        rows_per_chunk = max(1, budget // L)
        # multi-chunk buckets pin every chunk (incl. the tail) to the same
        # canonical row count; single-chunk buckets stay power-of-two
        full_rows = len(idxs) > rows_per_chunk
        for c in range(0, len(idxs), rows_per_chunk):
            chunk = idxs[c : c + rows_per_chunk]
            B = rows_per_chunk if full_rows else _pow2_rows(len(chunk))
            # vectorized fill: one C-level join + fancy-index scatter
            flat = np.frombuffer(
                b"".join(byte_strings[i] for i in chunk), dtype=np.uint8
            )
            lens = np.array(
                [len(byte_strings[i]) for i in chunk], dtype=np.int32
            )
            buf = np.zeros((B, L), dtype=np.uint8)
            lengths = np.zeros((B,), dtype=np.int32)
            lengths[: len(chunk)] = lens
            starts = np.concatenate(
                [[0], np.cumsum(lens[:-1], dtype=np.int64)]
            ) if len(chunk) else np.zeros(0, np.int64)
            rows = np.repeat(
                np.arange(len(chunk), dtype=np.int64), lens.astype(np.int64)
            )
            cols = np.arange(flat.size, dtype=np.int64) - np.repeat(
                starts, lens.astype(np.int64)
            )
            buf[rows, cols] = flat
            out.append((buf, lengths, chunk))
    return out
