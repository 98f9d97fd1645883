"""Device engine dispatch: the five encode engines, tried in the order of
`tokenizers_tpu.ops.engine`: byte-level BPE (gpt2, llama3), WordPiece
(bert), Unigram (SentencePiece), WordLevel, then char-level BPE (CharBPE,
SentencePiece BPE, the Llama-2 SPM shape).  `TOKENIZERS_LOG=debug` logs
which engine took a pipeline, or that none did (`utils/log.py`)."""

from __future__ import annotations

from ..utils.log import get_logger
from .bpe_engine import ByteLevelBpeEngine
from .charbpe_engine import CharBpeEngine
from .unigram_engine import UnigramEngine
from .wordlevel_engine import WordLevelEngine
from .wordpiece_engine import WordPieceEngine

log = get_logger("engine")


def build_device_engine(tokenizer, device):
    """The engine that runs `tokenizer` on `device`, or None (host path)."""
    for engine in (ByteLevelBpeEngine, WordPieceEngine, UnigramEngine, WordLevelEngine,
                   CharBpeEngine):
        eng = engine.try_build(tokenizer, device)
        if eng is not None:
            log.debug("pipeline compiled to %s on %s", engine.__name__, device)
            return eng
    log.debug("no device engine matched (model=%s, normalizer=%s, pre_tokenizer=%s): "
              "using the host path", type(tokenizer.model).__name__,
              type(tokenizer.normalizer).__name__ if tokenizer.normalizer else None,
              type(tokenizer.pre_tokenizer).__name__ if tokenizer.pre_tokenizer else None)
    return None
