"""The trainers' progress bar; copy of `tokenizers_tpu.utils.progress`
(reference `utils/progress.rs`, `indicatif` behind the `progressbar`
feature).

A bar on stderr, drawn only when stderr is a terminal and at most every
0.1 s; when it is off, `inc` adds to a counter and draws nothing.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, length: int = 0, message: str = "", enabled: bool = True):
        self.length = length
        self.message = message
        self.enabled = enabled and sys.stderr.isatty()
        self.pos = 0
        self._last = 0.0

    def set_message(self, message: str) -> None:
        self.message = message

    def set_length(self, length: int) -> None:
        self.length = length

    def reset(self) -> None:
        self.pos = 0
        self._draw(force=True)

    def inc(self, n: int = 1) -> None:
        self.pos += n
        if self.enabled:
            self._draw()

    def _draw(self, force: bool = False) -> None:
        if not self.enabled:
            return
        now = time.monotonic()
        if not force and now - self._last < 0.1:
            return
        self._last = now
        if self.length:
            width = 30
            filled = min(width, self.pos * width // max(1, self.length))
            bar = "█" * filled + " " * (width - filled)
            sys.stderr.write(f"\r{self.message:<24.24} |{bar}| {self.pos}/{self.length}")
        else:
            sys.stderr.write(f"\r{self.message:<24.24} {self.pos}")
        sys.stderr.flush()

    def finish(self) -> None:
        if self.enabled:
            self._draw(force=True)
            sys.stderr.write("\n")
            sys.stderr.flush()


def progress_bar(show: bool, length: int = 0, message: str = "") -> ProgressBar:
    return ProgressBar(length=length, message=message, enabled=show)
