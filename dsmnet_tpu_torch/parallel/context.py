"""Sharding context consulted by the models, the losses and the train step
(``dsmnet_tpu/parallel/context.py``).

In JAX the trainer activates a mesh, and XLA's GSPMD partitioner inserts
the all-reduces that make every reduction over the batch global and the
halo exchanges of an H-sharded activation: the step on a (data, model)
mesh *is* the single-device step on the global batch.  Here each rank
runs the single-device code on its shard, and the reductions and halos
are written out:

  * the batch: each rank holds its ``data`` coordinate's slice of the
    global batch (every rank of one data index the same slice);
  * H, under a ``spatial_axis``: a model that bands H (PSMNet, GCNet and
    GCNetLR, which declare ``band_multiple``) runs its 2-D tower on the
    whole images, then enters :func:`banded`; inside it
    :func:`shard_activation` keeps this rank's contiguous band of rows
    ``[m h / M, (m + 1) h / M)`` of the features (``m`` its ``model``
    coordinate, ``M`` the axis size), and every op that reads rows beyond
    its band exchanges them (``parallel/halo.py``).

Which group a reduction runs over is decided by the section, never by a
tensor's shape or number of dims: inside a :func:`banded` section the
ranks hold bands, so a sum over the batch is a sum over the whole mesh
(:func:`band_group`, data x model); outside it every ``model`` rank of a
data index holds the same whole tensor, so the sum runs over the data
group alone (:func:`data_group`), and a ``model`` rank never counts the
same rows twice.  The reductions:

  * :func:`data_sum` — a tensor summed over the section's group (a masked
    count, a masked sum, a detached statistic);
  * :func:`data_numel` — the global element count of a tensor whose shape
    is the same on every rank of that group;
  * :func:`mean_share` — this rank's share of a global mean, its sum over
    the global count: the ranks' shares sum to the mean over the global
    batch, and their gradients, summed by the step, to its gradient;
  * :func:`data_mean` — the global mean itself, for a detached statistic;
  * :func:`reduce_group` — the section's group, for LeanBN's moments
    (``models/layers.py``);
  * :func:`gradient_group` — the step's gradient bucket (``train/steps.py``):
    the whole mesh for a model that bands H (each rank's gradients are its
    band's share), the data group for one that runs whole on every
    ``model`` rank (each rank's gradients are already the whole's);
  * :func:`gather_band` — a banded map all-gathered over ``model`` (the
    eval step's full-resolution disparity);
  * :func:`section_band` — the rows ``(lo, hi)`` of the section's whole H
    that this rank holds (a self-supervised step's band of its views);
  * :func:`model_sum` — a tensor summed over the ``model`` group alone:
    the ranks that hold the other bands of the same images.  A statistic
    of one image (:func:`image_means`, the per-image mean |dI| of the
    ``C_ds3`` edge weights) sums there: over the whole mesh it would add
    the other data indices' images into it.

Without an active context each is the single-process expression (a sum is
returned as it is), so a run without a mesh is untouched and pays nothing.
``COLLECTIVES`` counts the all-reduces and the halo exchanges by the site
that asked for them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

from .mesh import band, band_rows, mesh_group

__all__ = [
    "ShardingContext",
    "activate",
    "current",
    "banded",
    "in_band",
    "bands",
    "spatial_coords",
    "shard_cost_volume",
    "shard_activation",
    "data_group",
    "band_group",
    "reduce_group",
    "gradient_group",
    "data_sum",
    "data_numel",
    "data_mean",
    "mean_share",
    "gather_band",
    "section_band",
    "model_sum",
    "image_means",
    "all_reduce_sum",
    "COLLECTIVES",
]

# all-reduces and halo exchanges made, by the site that asked for them
COLLECTIVES: dict[str, int] = {}


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    """A ``DeviceMesh`` with the axis that shards the batch (``data_axis``)
    and the one that shards H (``spatial_axis``).  ``band_h`` is set inside
    a :func:`banded` section only: the whole H of the 2-D features whose
    band this rank holds there."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    data_axis: str | None = "data"
    spatial_axis: str | None = None
    band_h: int | None = None


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


def _spatial() -> ShardingContext | None:
    ctx = current()
    return ctx if ctx is not None and ctx.spatial_axis is not None else None


def spatial_coords() -> tuple[int, int, object]:
    """(this rank's index, the axis size, the group) of the spatial axis."""
    ctx = _spatial()
    if ctx is None:
        raise RuntimeError("no spatial axis in the current sharding context")
    group = ctx.mesh.get_group(ctx.spatial_axis)
    return ctx.mesh.get_local_rank(ctx.spatial_axis), dist.get_world_size(group), group


@contextlib.contextmanager
def banded(h: int, multiple: int = 1):
    """The section of a model (or of a step's loss) that runs on bands of
    rows of tensors whose whole H at the 2-D features' level is ``h``: the
    identity without a spatial axis.  Checks the band rule (``mesh.band_rows``)."""
    ctx = _spatial()
    if ctx is None:
        yield
        return
    _, size, _ = spatial_coords()
    band_rows(h, size, multiple)
    with activate(dataclasses.replace(ctx, band_h=h)):
        yield


def in_band() -> bool:
    """Whether the caller runs inside a :func:`banded` section."""
    ctx = current()
    return ctx is not None and ctx.band_h is not None


def bands(model) -> bool:
    """Whether ``model`` bands H under the current context: a spatial axis
    is set and the model declares ``band_multiple``."""
    return _spatial() is not None and getattr(model, "band_multiple", None) is not None


def _band_of(x: torch.Tensor, dim: int) -> torch.Tensor:
    ctx = current()
    lo, hi = band(ctx.band_h, ctx.mesh, ctx.spatial_axis)
    rows = hi - lo
    if x.shape[dim] == rows:  # already this rank's band
        return x
    if x.shape[dim] == ctx.band_h:
        return x.narrow(dim, lo, rows)
    raise ValueError(f"a tensor of {x.shape[dim]} rows on dim {dim} is neither the whole "
                     f"H = {ctx.band_h} of the banded section nor a band of {rows} rows")


def shard_cost_volume(vol: torch.Tensor) -> torch.Tensor:
    """A (N, D, H, W, C) cost volume, batch over the data axis (each rank
    holds its shard already), H over the spatial axis inside a
    :func:`banded` section: this rank's band (the volume ops take banded
    features, so the volume is one already).  Outside a banded section the
    identity: a model that does not band runs whole on every model rank."""
    return _band_of(vol, 2) if in_band() else vol


def shard_activation(x: torch.Tensor) -> torch.Tensor:
    """An NHWC activation, batch over the data axis, H over the spatial
    axis inside a :func:`banded` section: this rank's band of rows."""
    return _band_of(x, 1) if in_band() else x


def data_group():
    """The process group of the current context's data axis, or None."""
    ctx = current()
    if ctx is None or ctx.data_axis is None:
        return None
    return ctx.mesh.get_group(ctx.data_axis)


def band_group():
    """The group of every rank of the mesh (data x model), over which a
    banded tensor's reductions run."""
    return mesh_group(current().mesh)


def reduce_group():
    """The group of the current section's reductions: every rank of the
    mesh inside a :func:`banded` section, the data group outside it, None
    without a context."""
    return band_group() if in_band() else data_group()


def gradient_group(model):
    """The group the step sums ``model``'s gradients over: the whole mesh
    when it bands H (:func:`bands`), the data group otherwise, None
    without a context."""
    return band_group() if bands(model) else data_group()


def all_reduce_sum(t: torch.Tensor, group, site: str) -> torch.Tensor:
    """``t`` summed over ``group``, as a new tensor (``t`` is left as it is)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES[site] = COLLECTIVES.get(site, 0) + 1
    return out


def section_band() -> tuple[int, int]:
    """The rows [lo, hi) of the current :func:`banded` section's whole H
    that this rank holds; (0, None) outside one (the whole H)."""
    ctx = current()
    if ctx is None or ctx.band_h is None:
        return 0, None
    return band(ctx.band_h, ctx.mesh, ctx.spatial_axis)


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the spatial axis's group inside a :func:`banded`
    section, the ranks that hold the other bands of the same images (no
    gradient flows through the sum); ``t`` itself outside one, where every
    ``model`` rank holds the whole images."""
    if not in_band():
        return t
    return all_reduce_sum(t, spatial_coords()[2], "model_sum")


def image_means(*xs: torch.Tensor) -> list[torch.Tensor]:
    """The mean of each NHWC ``x`` over its (H, W, C) per image, (N, 1, 1,
    1) each.  Inside a :func:`banded` section each ``x`` is this rank's band
    of rows: its sums are added over the ``model`` group (one all-reduce
    for all of them) and divided by the whole image's count.  No gradient
    flows through the reduction: its callers take statistics of the images,
    which are data."""
    if not in_band():
        return [x.mean(dim=(1, 2, 3), keepdim=True) for x in xs]
    _, size, _ = spatial_coords()
    sums = model_sum(torch.cat([x.sum(dim=(1, 2, 3)) for x in xs]).view(len(xs), -1))
    return [s.view(-1, 1, 1, 1) / (x[0].numel() * size) for s, x in zip(sums, xs)]


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the section's group (no gradient flows through the
    sum); ``t`` itself without a context."""
    group = reduce_group()
    return t if group is None else all_reduce_sum(t, group, "data_sum")


def data_numel(t: torch.Tensor) -> int:
    """The element count of ``t`` over the section's group: its own times
    the group's size (every rank holds a shard of the same shape)."""
    group = reduce_group()
    return t.numel() * (1 if group is None else dist.get_world_size(group))


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch, with its
    gradient: ``x.mean()`` without a context."""
    return x.mean() if reduce_group() is None else x.sum() / data_numel(x)


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch, for a detached statistic
    (no gradient flows through it): ``x.mean()`` without a context."""
    return x.mean() if reduce_group() is None else data_sum(x.sum()) / data_numel(x)


def gather_band(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole tensor of which every ``model`` rank holds a band on
    ``dim``: the bands all-gathered over the spatial axis in its order.  The
    identity outside a :func:`banded` section.  gloo moves a CUDA tensor's
    bands through the host."""
    if not in_band():
        return x
    _, size, group = spatial_coords()
    stage = dist.get_backend(group) == "gloo" and x.is_cuda
    src = x.detach().cpu() if stage else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    COLLECTIVES["gather_band"] = COLLECTIVES.get("gather_band", 0) + 1
    whole = torch.cat(parts, dim=dim)
    return whole.to(x.device) if stage else whole
