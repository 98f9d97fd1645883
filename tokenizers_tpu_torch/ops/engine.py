"""Device engine dispatch: the five encode engines, tried in the order of
`tokenizers_tpu.ops.engine`: byte-level BPE (gpt2, llama3), WordPiece
(bert), Unigram (SentencePiece), WordLevel, then char-level BPE (CharBPE,
SentencePiece BPE, the Llama-2 SPM shape)."""

from __future__ import annotations

from .bpe_engine import ByteLevelBpeEngine
from .charbpe_engine import CharBpeEngine
from .unigram_engine import UnigramEngine
from .wordlevel_engine import WordLevelEngine
from .wordpiece_engine import WordPieceEngine


def build_device_engine(tokenizer, device):
    """The engine that runs `tokenizer` on `device`, or None (host path)."""
    for engine in (ByteLevelBpeEngine, WordPieceEngine, UnigramEngine, WordLevelEngine,
                   CharBpeEngine):
        eng = engine.try_build(tokenizer, device)
        if eng is not None:
            return eng
    return None
