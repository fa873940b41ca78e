"""Sharding context consulted by the models, the losses and the train step
(``dsmnet_tpu/parallel/context.py``).

In JAX the trainer activates a mesh, and XLA's GSPMD partitioner inserts
the all-reduces that make every reduction over the batch global: the
data-parallel step *is* the single-device step on the global batch.  Here
each rank runs the single-device code on its shard of the global batch,
and the few reductions over the batch call this module, which reduces
over the process group of the active context's data axis:

  * :func:`data_sum` — a tensor summed over the data group (a masked
    count, a masked sum, a detached statistic);
  * :func:`data_numel` — the global element count of a tensor whose shape
    is the same on every rank;
  * :func:`mean_share` — this rank's share of a global mean, its sum over
    the global count: the ranks' shares sum to the mean over the global
    batch, and their gradients, summed by the step, to its gradient;
  * :func:`data_mean` — the global mean itself, for a detached statistic;
  * :func:`data_group` — the group, for LeanBN's moments
    (``models/layers.py``) and the step's gradient bucket
    (``train/steps.py``).

Without an active context each is the single-process expression (a sum is
returned as it is), so a run without a mesh is untouched and pays nothing.
``COLLECTIVES`` counts the all-reduces by the site that asked for them.

Spatial sharding (``spatial_axis``: H of the activations and cost volumes
over the mesh's ``model`` axis) is not ported yet: :func:`shard_activation`
and :func:`shard_cost_volume` mark where the models and ops would
exchange halos, and raise when a spatial axis is set (``ROADMAP.md``,
queue 1, "Spatial sharding").
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

__all__ = [
    "ShardingContext",
    "activate",
    "current",
    "shard_cost_volume",
    "shard_activation",
    "data_group",
    "data_sum",
    "data_numel",
    "data_mean",
    "mean_share",
    "all_reduce_sum",
    "COLLECTIVES",
]

_SPATIAL = ("spatial sharding (ShardingContext.spatial_axis) is not ported yet: "
            "ROADMAP.md, queue 1, 'Spatial sharding'")

# all-reduces made, by the site that asked for them
COLLECTIVES: dict[str, int] = {}


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    """A ``DeviceMesh`` with the axis that shards the batch (``data_axis``)
    and the one that would shard H (``spatial_axis``)."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    data_axis: str | None = "data"
    spatial_axis: str | None = None


_ctx: contextvars.ContextVar[ShardingContext | None] = contextvars.ContextVar(
    "dsmnet_torch_sharding", default=None
)


@contextlib.contextmanager
def activate(ctx: ShardingContext | None):
    """Make ``ctx`` the current context inside the block (None: no context)."""
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)


def current() -> ShardingContext | None:
    return _ctx.get()


def shard_cost_volume(vol: torch.Tensor) -> torch.Tensor:
    """A (N, D, H, W, C) cost volume, batch over the data axis (each rank
    holds its shard already): the identity unless a spatial axis is set."""
    ctx = current()
    if ctx is not None and ctx.spatial_axis is not None:
        raise NotImplementedError(_SPATIAL)
    return vol


def shard_activation(x: torch.Tensor) -> torch.Tensor:
    """An NHWC activation, batch over the data axis: the identity unless a
    spatial axis is set."""
    ctx = current()
    if ctx is not None and ctx.spatial_axis is not None:
        raise NotImplementedError(_SPATIAL)
    return x


def data_group():
    """The process group of the current context's data axis, or None."""
    ctx = current()
    if ctx is None or ctx.data_axis is None:
        return None
    return ctx.mesh.get_group(ctx.data_axis)


def all_reduce_sum(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """``t`` summed over ``group``, as a new tensor (``t`` is left as it is)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES[site] = COLLECTIVES.get(site, 0) + 1
    return out


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group (no gradient flows through the sum);
    ``t`` itself without a context."""
    group = data_group()
    return t if group is None else all_reduce_sum(t, group, "data_sum")


def data_numel(t: torch.Tensor) -> int:
    """The element count of ``t`` over the data group: its own times the
    group's size (every rank holds a shard of the same shape)."""
    group = data_group()
    return t.numel() * (1 if group is None else dist.get_world_size(group))


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch, with its
    gradient: ``x.mean()`` without a context."""
    return x.mean() if data_group() is None else x.sum() / data_numel(x)


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch, for a detached statistic
    (no gradient flows through it): ``x.mean()`` without a context."""
    return x.mean() if data_group() is None else data_sum(x.sum()) / data_numel(x)
