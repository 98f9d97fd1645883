"""Logging set from the `TOKENIZERS_LOG` environment variable; copy of
`tokenizers_tpu.utils.log` (reference: the Python binding starts
env_logger from TOKENIZERS_LOG, `bindings/python/src/lib.rs:63`).

Levels: trace, debug, info, warn (or warning), error and off, in any
case; another value means info, and no variable leaves the package
silent.  `trace` is a level of its own, 5, below DEBUG.

Loggers under `tokenizers_tpu_torch`:
  .engine  — which device engine took a pipeline, or why none did
             (`ops/engine.py`, debug)
  .models  — the vocab-holes warning when a BPE model saves
  .trainer — the BPE trainer's route, dense or per-round
             (`parallel/bpe_train.py`, debug)
"""

from __future__ import annotations

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

ROOT = "tokenizers_tpu_torch"
_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "off": logging.CRITICAL + 10,
}

_initialized = False


def init_from_env() -> None:
    """Set the package's logger from TOKENIZERS_LOG, once a process."""
    global _initialized
    if _initialized:
        return
    _initialized = True
    spec = os.environ.get("TOKENIZERS_LOG")
    logger = logging.getLogger(ROOT)
    if spec is None:
        logger.addHandler(logging.NullHandler())
        return
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(_LEVELS.get(spec.strip().lower(), logging.INFO))


def get_logger(name: str) -> logging.Logger:
    init_from_env()
    return logging.getLogger(f"{ROOT}.{name}")
