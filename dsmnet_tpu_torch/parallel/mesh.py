"""The (data, model) mesh over the ranks, and the placement of the state
and the batches (``dsmnet_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group (``multihost.init_distributed``), with the
dims ``("data", "model")``; each rank drives one device.  The parameters,
BN statistics and optimizer state are replicated (:func:`replicate`
broadcasts them from data-rank 0), and each rank takes its contiguous
slice of a global ``(N, ...)`` batch by its ``data`` coordinate
(:func:`shard_batch`).  JAX's XLA inserts the gradient all-reduce; here
the train step sums the gradients over the data group itself
(``train/steps.py``), and the reductions over the batch go through
``parallel/context.py``.

Unlike JAX's, a mesh covers every rank: a rank outside it would train
alone on the same files.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "make_mesh",
    "replicate",
    "shard_batch",
    "batch_sharding",
    "replicated_sharding",
    "axis_size",
    "axis_index",
    "mesh_group",
    "band_rows",
    "band",
]

AXES = ("data", "model")


def make_mesh(data: int | None = None, model: int = 1, devices=None):
    """Build a (data, model) ``DeviceMesh`` over the ranks (``devices``: the
    ranks in mesh order, default every rank of the default group).
    ``data=None`` takes every rank the model axis leaves.  Raises
    ``ValueError`` for a mesh that does not cover the ranks exactly."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} ranks")
    if data * model < n or sorted(ranks) != list(range(world)):
        raise ValueError(f"mesh {data}x{model} does not cover the {world} ranks: a rank "
                         "outside the mesh would train alone")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.init_distributed first")
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def mesh_group(mesh):
    """The process group of every rank of ``mesh``: the default group, which
    a mesh of ``make_mesh`` covers (raises for one that does not)."""
    if mesh.mesh.numel() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.mesh.numel()} ranks does not cover the "
                         f"{dist.get_world_size()} ranks of the default group")
    return dist.group.WORLD


def band_rows(h: int, size: int, multiple: int = 1) -> int:
    """Rows of each of ``size`` bands of ``h`` rows, which must be a whole
    multiple of ``multiple`` (every stride-2 input of a banded model must
    split into whole, even bands); raises ``ValueError`` stating the rule."""
    if h % size or (h // size) % multiple:
        raise ValueError(
            f"H = {h} at the features' resolution does not split into {size} bands of a "
            f"multiple of {multiple} rows: a band must be a whole multiple of {multiple} "
            f"rows, so (H of the features) / {size} must be divisible by {multiple} "
            "(PSMNet: (H/4)/M by 4; GCNet: (H/2)/M by 16)")
    return h // size


def band(h: int, mesh, axis: str = "model", multiple: int = 1) -> tuple[int, int]:
    """The rows [lo, hi) of an H of ``h`` rows that this rank holds when H is
    split over ``axis`` into contiguous bands, one per coordinate: ``lo = m
    h / M``.  Each band must be a whole multiple of ``multiple`` rows, else
    ``ValueError`` states the rule."""
    rows = band_rows(h, axis_size(mesh, axis), multiple)
    m = axis_index(mesh, axis)
    return m * rows, (m + 1) * rows


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement: per array dim the mesh axis that splits it, or None
    (JAX's ``NamedSharding(mesh, PartitionSpec(*spec))``)."""

    mesh: object
    spec: tuple


def replicated_sharding(mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh, ndim: int, axis: str = "data") -> Sharding:
    return Sharding(mesh, (axis, *([None] * (ndim - 1))))


def _state_tensors(obj) -> list[torch.Tensor]:
    """The tensors of a TrainState or a module, in a fixed order:
    parameters, buffers, then the optimizer's state per parameter."""
    model = getattr(obj, "model", obj)
    opt = getattr(obj, "opt", None)
    out = [p.data for p in model.parameters()] + list(model.buffers())
    if opt is not None:
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                out += [state[k] for k in sorted(state) if torch.is_tensor(state[k])]
    return out


def _broadcast(t: torch.Tensor, src: int, group) -> None:
    if dist.get_backend(group) == "nccl" and not t.is_cuda:
        # NCCL moves CUDA tensors only (Adam keeps its step count on the CPU)
        tmp = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.broadcast(tmp, src, group=group)
        t.copy_(tmp)
    else:
        dist.broadcast(t, src, group=group)


@torch.no_grad()
def replicate(obj, mesh):
    """Give every rank of the mesh its first rank's parameters, BN
    statistics and optimizer state (and the step) of a TrainState, or the
    parameters and buffers of a module, in place; returns ``obj``."""
    group = mesh_group(mesh)
    src = int(mesh.mesh.flatten()[0])
    for t in _state_tensors(obj):
        _broadcast(t, src, group)
    if hasattr(obj, "step") and isinstance(obj.step, int):
        step = torch.tensor([obj.step], dtype=torch.int64)
        _broadcast(step, src, group)
        obj.step = int(step.item())
    return obj


def shard_batch(batch, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous slice of a global (N, ...) batch (a numpy
    array or a tensor), by its ``axis`` coordinate.  Raises when the axis
    does not divide N, as JAX's ``device_put`` does."""
    size, index = axis_size(mesh, axis), axis_index(mesh, axis)
    n = batch.shape[0]
    if n % size:
        raise ValueError(f"a batch of {n} does not split over the {size} ranks of '{axis}'")
    per = n // size
    part = batch[index * per:(index + 1) * per]
    return torch.from_numpy(np.ascontiguousarray(part)) if isinstance(part, np.ndarray) \
        else part
