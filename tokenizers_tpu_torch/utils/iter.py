"""Iterator helpers (reference `utils/iter.rs`); copy of
`tokenizers_tpu.utils.iter`."""

from __future__ import annotations

from typing import Iterable, Iterator


def lines_with_ending(text: str) -> Iterator[str]:
    """Split keeping the '\\n' terminator on each line (reference
    `lines_with_ending`, used when feeding training files)."""
    start = 0
    n = len(text)
    while start < n:
        idx = text.find("\n", start)
        if idx < 0:
            yield text[start:]
            return
        yield text[start : idx + 1]
        start = idx + 1


def file_lines_with_ending(paths: Iterable[str]) -> Iterator[str]:
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                yield line
