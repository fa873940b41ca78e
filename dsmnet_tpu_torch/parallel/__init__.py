"""Parallelism: the (data, model) mesh over the ranks, data-parallel
placement, the sharding context, multi-process set-up and the halo
convolution (``dsmnet_tpu/parallel``).

A data-parallel step is the single-device step on each rank's shard of
the global batch, with every reduction over the batch made global: LeanBN's
moments, the losses' counts and means, D1/EPE (``context.py``) and the
gradients, summed over the data group by the step (``train/steps.py``).
"""

from .halo import halo_conv2d
from .context import (
    ShardingContext,
    activate,
    current,
    shard_activation,
    shard_cost_volume,
)
from .mesh import (
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from .multihost import (
    global_batch_from_host_local,
    host_shard,
    init_distributed,
    is_primary_host,
    shard_dataset_for_host,
)

__all__ = [
    "ShardingContext",
    "activate",
    "current",
    "shard_activation",
    "shard_cost_volume",
    "batch_sharding",
    "make_mesh",
    "replicate",
    "replicated_sharding",
    "shard_batch",
    "global_batch_from_host_local",
    "host_shard",
    "init_distributed",
    "is_primary_host",
    "shard_dataset_for_host",
    "halo_conv2d",
]
