"""Process groups, per-rank data and the primary rank
(``dsmnet_tpu/parallel/multihost.py``).

Every rank is one process driving one device:

  1. each calls :func:`init_distributed` before it touches a device, with
     a coordinator's address (``--multihost --coordinator host:port``) or
     torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``);
  2. under ``--multihost`` each reads only its share of the sample lists
     (:func:`shard_dataset_for_host`, strided so shuffled epochs stay
     balanced; on a mesh by the rank's ``data`` coordinate, so the ``model``
     ranks of one data index read the same samples), and the global batch
     is the data ranks' batches in order;
  3. :func:`global_batch_from_host_local` checks that every rank holds a
     batch of the same shape and puts this rank's on its device.

Only the primary rank writes files (:func:`is_primary_host`), and the
others wait at a :func:`barrier` until it has.
"""

from __future__ import annotations

import datetime
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "init_distributed",
    "host_shard",
    "shard_dataset_for_host",
    "global_batch_from_host_local",
    "is_primary_host",
    "process_index",
    "process_count",
    "local_rank",
    "barrier",
    "DEFAULT_TIMEOUT",
]

# how long a collective waits for a rank before it fails: a rank that dies
# makes its peers fail, not hang
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def local_rank() -> int:
    """This rank's device index on its host (torchrun's ``LOCAL_RANK``; 0
    for one process per host)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Make the default process group; returns whether there is one.

    With ``coordinator_address`` (``host:port``, or an ``init_method`` URL)
    the group has ``num_processes`` ranks and this is ``process_id``;
    without it, torchrun's environment (``RANK``, ``WORLD_SIZE``) is read
    through ``env://``; with neither, this is a single process and no group
    is made.  The backend is NCCL on CUDA (the rank's device,
    ``cuda:LOCAL_RANK``, is selected first) and gloo on the CPU, unless
    ``backend`` names one."""
    if dist.is_initialized():
        return True
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif num_processes not in (None, 1):
        raise ValueError(f"{num_processes} processes need a coordinator address or "
                         "torchrun's environment")
    else:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary_host() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank of the default group (nothing to wait for
    without one)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def host_shard(items: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """Deterministic per-rank shard of a sample list (strided so shuffled
    epochs stay balanced); by default this rank's of all ranks."""
    # the module's functions of those names, which the parameters shadow
    pi = globals()["process_index"]() if process_index is None else process_index
    pc = globals()["process_count"]() if process_count is None else process_count
    return items[pi::pc]


def shard_dataset_for_host(dataset, mesh=None) -> None:
    """Restrict a StereoDataset (or ConcatDataset) to this rank's share of
    the sample lists, in place: by its rank among all ranks, or, given a
    ``mesh``, by its ``data`` coordinate among the data axis's (the
    ``model`` ranks of one data index read the same samples).  Datasets
    without path lists (``SyntheticStereoDataset``) are strided by their
    ``index_offset`` / ``index_stride``, so that no two data indices feed
    the same samples."""
    if mesh is None:
        index, count = process_index(), process_count()
    else:
        from .mesh import axis_index, axis_size

        index, count = axis_index(mesh, "data"), axis_size(mesh, "data")
    if hasattr(dataset, "datasets"):
        for d in dataset.datasets:
            shard_dataset_for_host(d, mesh)
        return
    if getattr(dataset, "paths_img_left", None) is not None:
        for attr in ("paths_img_left", "paths_img_right",
                     "paths_disp_left", "paths_disp_right"):
            lst = getattr(dataset, attr, None)
            if lst is not None:
                setattr(dataset, attr, host_shard(lst, index, count))
        return
    if hasattr(dataset, "index_stride"):
        dataset.index_offset = index
        dataset.index_stride = count
        return
    warnings.warn(
        f"shard_dataset_for_host: {type(dataset).__name__} has neither path "
        "lists nor index_stride — every rank will see the SAME samples "
        "(duplicated global batch)", stacklevel=2,
    )


def _group_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_batch_from_host_local(batch, mesh, axis: str = "data",
                                 device=None) -> torch.Tensor:
    """This rank's (local_N, ...) batch on ``device``, as its share of the
    global batch (the ranks' batches in ``axis`` order).  Every rank must
    hold the same shape, as JAX's ``make_array_from_process_local_data``
    requires: the shapes are all-gathered and a mismatch raises on every
    rank."""
    group = mesh.get_group(axis)
    shape = tuple(batch.shape)
    mine = torch.tensor([len(shape), *shape] + [0] * (8 - len(shape)), dtype=torch.int64,
                        device=_group_device(group))
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    shapes = {tuple(int(v) for v in t[1:1 + int(t[0])].tolist()) for t in every}
    if len(shapes) > 1:
        raise ValueError(f"the ranks hold local batches of different shapes {sorted(shapes)}")
    t = torch.from_numpy(np.ascontiguousarray(batch)) if isinstance(batch, np.ndarray) else batch
    return t if device is None else t.to(device)
