"""Multi-rank parallelism of the port: the runtime (`torch.distributed`
groups, `DeviceMesh`, the collectives), data-parallel training with counts
summed over the ranks, and sharded encode; port of
`tokenizers_tpu.parallel`."""

from .bpe_train import DistributedBpeTrainer
from .encode import shard_encode_batch, shard_encode_batch_arrays

__all__ = ["DistributedBpeTrainer", "shard_encode_batch", "shard_encode_batch_arrays"]
