"""Device engine dispatch: the engines of the port so far, tried in the
order of `tokenizers_tpu.ops.engine` (which tries five): byte-level BPE
(gpt2, llama3), then WordPiece (bert)."""

from __future__ import annotations

from .bpe_engine import ByteLevelBpeEngine
from .wordpiece_engine import WordPieceEngine


def build_device_engine(tokenizer, device):
    """The engine that runs `tokenizer` on `device`, or None (host path)."""
    for engine in (ByteLevelBpeEngine, WordPieceEngine):
        eng = engine.try_build(tokenizer, device)
        if eng is not None:
            return eng
    return None
