"""Device engine dispatch: the ByteLevel BPE engine is the only engine of
this slice of the port (`tokenizers_tpu.ops.engine` tries five)."""

from __future__ import annotations

from .bpe_engine import ByteLevelBpeEngine


def build_device_engine(tokenizer, device):
    """The engine that runs `tokenizer` on `device`, or None (host path)."""
    return ByteLevelBpeEngine.try_build(tokenizer, device)
