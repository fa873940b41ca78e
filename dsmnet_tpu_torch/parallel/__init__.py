"""Parallelism: the (data, model) mesh over the ranks, the placement of
the state and the batches, the sharding context, multi-process set-up and
the halo exchanges (``dsmnet_tpu/parallel``).

A step on a mesh is the single-device step on each rank's shard of the
global batch, with every reduction over the batch made global: LeanBN's
moments, the losses' counts and means, D1/EPE (``context.py``) and the
gradients, summed by the step (``train/steps.py``).  Under a ``model``
axis above 1 the models that band H run their cost volume and 3-D part
on one band of rows per rank, each op exchanging the rows it reads
beyond its band (``halo.py``).
"""

from .halo import (
    banded_conv3d_s2,
    banded_conv3d_same,
    banded_deconv3d_k3s2,
    halo_conv2d,
    halo_pad,
)
from .context import (
    ShardingContext,
    activate,
    banded,
    current,
    gather_band,
    shard_activation,
    shard_cost_volume,
)
from .mesh import (
    band,
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
    "banded",
    "current",
    "gather_band",
    "shard_activation",
    "shard_cost_volume",
    "band",
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
    "halo_pad",
    "banded_conv3d_same",
    "banded_conv3d_s2",
    "banded_deconv3d_k3s2",
]
