"""Long-document sharding: split huge inputs at tokenization-safe seams.

The reference processes each document as one string on one thread; GB-scale
single documents are the tokenizer analogue of long-context processing
(SURVEY §5).  Here a long document is split into chunks at *safe* seams —
positions where every supported pipeline provably starts a new
pre-tokenization match, so per-chunk token streams concatenate to exactly
the unsplit result:

    seam at i requires s[i] == ' ' with printable-ASCII non-space bytes on
    both sides.  Then:
      * gpt2 / llama-3: a space preceded by non-whitespace and followed by
        a non-whitespace char always begins a match (` ?X+` branches /
        `[^\\r\\n..]?\\p{L}+`), and no lookahead crosses the seam;
      * bert: whitespace always splits (and dies);
      * unigram/Metaspace: the space starts a new `▁` word, and a chunk
        that begins with a space is never prepended another `▁`.

Chunks then ride the normal packed batch (data-parallel over chips when the
batch is sharded), replacing the host fallback for oversized inputs."""

from __future__ import annotations

from typing import List, Tuple


def split_long(data: bytes, target: int, window: int = 256) -> List[bytes]:
    """Split `data` into chunks of ~`target` bytes at safe seams.

    Returns [data] unchanged when no safe seam is found in the search
    window (caller falls back to the host path)."""
    if len(data) <= target:
        return [data]
    out: List[bytes] = []
    start = 0
    n = len(data)
    while n - start > target:
        lo = max(start + 1, start + target - window)
        hi = min(n - 1, start + target)
        seam = -1
        for i in range(hi, lo, -1):
            if (
                data[i] == 0x20
                and 0x21 <= data[i - 1] <= 0x7E
                and i + 1 < n
                and 0x21 <= data[i + 1] <= 0x7E
            ):
                seam = i
                break
        if seam < 0:
            # no safe seam near the target; widen once, else give up
            for i in range(min(n - 1, start + 2 * target), lo, -1):
                if (
                    data[i] == 0x20
                    and 0x21 <= data[i - 1] <= 0x7E
                    and i + 1 < n
                    and 0x21 <= data[i + 1] <= 0x7E
                ):
                    seam = i
                    break
            if seam < 0:
                return [data]
        out.append(data[start:seam])
        start = seam
    out.append(data[start:])
    return out
