"""Device training programs of the port (one device; the multi-device
runtime waits for a later slice)."""

from .bpe_train import DistributedBpeTrainer

__all__ = ["DistributedBpeTrainer"]
