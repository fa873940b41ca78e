"""Halo exchanges over an H-sharded mesh axis (``dsmnet_tpu/parallel/halo.py``),
and the banded ops of the spatially sharded models.

Each rank holds a contiguous band of rows of a tensor.  An op that reads
rows beyond its band gets them from its neighbours first:
:func:`halo_pad` adds ``above`` rows of the rank before and ``below``
rows of the rank after (zeros at the image's border) on any dim of a
tensor of any rank; the ranks swap them with ``batch_isend_irecv`` over
the axis's group.  The exchange is an autograd ``Function`` that carries
its group, as LeanBN's moments do, so a backward on another thread and
``remat``'s recomputation exchange with the same ranks; its backward
sends each halo's gradient back to the rank that owns the rows.  gloo,
the backend of ranks that share a card, moves the rows of a CUDA tensor
through the host: the transport of ranks on one card, not a fallback.
Every exchange counts in ``context.COLLECTIVES["halo_exchange"]`` and
runs under a ``halo_exchange`` profiler record; the local work around it
(joining the halo rows to the band, the adjoint's crop and sums) runs
under ``halo_pad``.

Each banded 3-D conv is one autograd ``Function`` (``_BandedConv``): it
pads its band, runs the unbanded op (on its kernel for a CUDA tensor) on
the padded band, and crops the output rows that the padding made wrong.
For the backward it keeps the band and the halo rows, not the padded band
(the layer that made the band keeps the band already), pads again there
and runs the op's VJP (``ops/conv3d.py``):

  * :func:`banded_conv3d_same`, stride-1 SAME 3-D conv: pad (ph, ph), crop
    ph rows a side (B; its backward B and F);
  * :func:`banded_conv3d_s2`, stride-2 pad-1 3x3x3 conv: output row j
    reads input rows 2j - 1 .. 2j + 1, so pad (2, 0), which keeps H even
    as C requires, and drop the first output row (C; D and G);
  * :func:`banded_deconv3d_k3s2`, the exact-2x transposed conv: output rows
    2i - 1 .. 2i + 1 come from input row i, so pad (0, 1) and drop the
    last two output rows (D; C and G).

:func:`halo_conv2d` is a SAME 2-D conv of a band (A and E at C = Co = 32).
A band must be a whole, even number of rows at every stride-2 input
(``mesh.band_rows``); JAX's GSPMD pads uneven shards instead.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.conv2d import conv2d_same
from ..ops.conv3d import (conv3d_s2, conv3d_s2_vjp, conv3d_same, conv3d_same_vjp,
                          deconv3d_k3s2, deconv3d_k3s2_vjp)
from . import context

__all__ = ["halo_pad", "halo_conv2d", "banded_conv3d_same", "banded_conv3d_s2",
           "banded_deconv3d_k3s2"]


def _exchange(lo, hi, index: int, size: int, group):
    """Send ``lo`` to the rank before this one and ``hi`` to the rank after
    it (either may be None: nothing to send that way); returns (what the
    rank before sent as its ``hi``, what the rank after sent as its
    ``lo``), zeros at the ends of the axis, None where nothing was sent."""
    with torch.profiler.record_function("halo_exchange"):
        like = lo if lo is not None else hi
        stage = dist.get_backend(group) == "gloo" and like.is_cuda
        dev = like.device
        prep = lambda t: None if t is None else (t.cpu() if stage else t.contiguous())
        lo_s, hi_s = prep(lo), prep(hi)
        from_prev = None if hi_s is None else torch.zeros_like(hi_s)
        from_next = None if lo_s is None else torch.zeros_like(lo_s)
        ops = []
        if index > 0:
            prev = dist.get_global_rank(group, index - 1)
            if lo_s is not None:
                ops.append(dist.P2POp(dist.isend, lo_s, prev, group))
            if from_prev is not None:
                ops.append(dist.P2POp(dist.irecv, from_prev, prev, group))
        if index < size - 1:
            nxt = dist.get_global_rank(group, index + 1)
            if hi_s is not None:
                ops.append(dist.P2POp(dist.isend, hi_s, nxt, group))
            if from_next is not None:
                ops.append(dist.P2POp(dist.irecv, from_next, nxt, group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        context.COLLECTIVES["halo_exchange"] = context.COLLECTIVES.get("halo_exchange", 0) + 1
        back = lambda t: None if t is None else (t.to(dev) if stage else t)
        return back(from_prev), back(from_next)


def _halos(x, dim: int, above: int, below: int, coords):
    """(the last ``above`` rows of the band before this one, the first
    ``below`` rows of the band after it) on ``dim``: zeros at the image's
    border, None for no rows."""
    h = x.shape[dim]
    lo = x.narrow(dim, 0, below) if below else None
    hi = x.narrow(dim, h - above, above) if above else None
    return _exchange(lo, hi, *coords)


def _join(top, x, bottom, dim: int):
    with torch.profiler.record_function("halo_pad"):
        return torch.cat([t for t in (top, x, bottom) if t is not None], dim=dim)


def _unpad(g, dim: int, above: int, below: int, coords):
    """The adjoint of the padding: the band's rows of ``g`` plus the
    gradients that the neighbours' halos send back to this band's rows."""
    h = g.shape[dim] - above - below
    # the gradient of my top halo belongs to the rank before me (its last
    # rows), of my bottom halo to the rank after me (its first rows)
    g_top = g.narrow(dim, 0, above) if above else None
    g_bottom = g.narrow(dim, above + h, below) if below else None
    from_prev, from_next = _exchange(g_top, g_bottom, *coords)
    with torch.profiler.record_function("halo_pad"):
        dx = g.narrow(dim, above, h).clone()
        if from_prev is not None:
            dx.narrow(dim, 0, below).add_(from_prev)
        if from_next is not None:
            dx.narrow(dim, h - above, above).add_(from_next)
    return dx


class _HaloPad(torch.autograd.Function):
    """x -> x with ``above`` rows of the rank before it and ``below`` rows
    of the rank after it on ``dim`` (zeros at the global border)."""

    @staticmethod
    def forward(ctx, x, dim, above, below, coords):
        ctx.dim, ctx.above, ctx.below, ctx.coords = dim, above, below, coords
        top, bottom = _halos(x, dim, above, below, coords)
        return _join(top, x, bottom, dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _unpad(g, ctx.dim, ctx.above, ctx.below, ctx.coords), None, None, None, None


def _check_rows(x: torch.Tensor, dim: int, above: int, below: int) -> None:
    if max(above, below) > x.shape[dim]:
        raise ValueError(f"a band of {x.shape[dim]} rows is thinner than its halo "
                         f"({above} above, {below} below)")


def halo_pad(x: torch.Tensor, dim: int, above: int, below: int,
             coords: tuple[int, int, object] | None = None) -> torch.Tensor:
    """This rank's band ``x`` (rows on ``dim``) with ``above`` rows of the
    band before it and ``below`` rows of the band after it (zeros at the
    image's border), over the spatial axis of the current context, or the
    (index, size, group) of ``coords``."""
    _check_rows(x, dim, above, below)
    if above == below == 0:
        return x
    coords = coords if coords is not None else context.spatial_coords()
    return _HaloPad.apply(x, dim, above, below, coords)


class _BandedConv(torch.autograd.Function):
    """The band (H on dim 2) of the 3-D conv ``op`` of the whole tensor:
    ``op`` of this rank's band padded by ``rows`` = (above, below) rows of
    its neighbours, ``drop`` = (top, bottom) output rows cropped; ``vjp``
    is the op's (dx, dk) for a cotangent.  Keeps the band, the halo rows
    and the kernel for the backward, which pads the band again."""

    @staticmethod
    def forward(ctx, x, k, op, vjp, rows, drop, coords):
        top, bottom = _halos(x, 2, *rows, coords)
        y = op(_join(top, x, bottom, 2), k)
        ctx.save_for_backward(x, k, top, bottom)
        ctx.vjp, ctx.rows, ctx.drop, ctx.coords = vjp, rows, drop, coords
        return y.narrow(2, drop[0], y.shape[2] - drop[0] - drop[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, k, top, bottom = ctx.saved_tensors
        xp = _join(top, x, bottom, 2)
        with torch.profiler.record_function("halo_pad"):
            gp = F.pad(g, (0, 0, 0, 0, *ctx.drop))  # the cropped rows' cotangent is 0
        dxp, dk = ctx.vjp(xp, k, gp, ctx.needs_input_grad[:2])
        del xp, gp
        dx = None if dxp is None else _unpad(dxp, 2, *ctx.rows, ctx.coords)
        return dx, dk, None, None, None, None, None


def _banded(x, k, op, vjp, rows, drop):
    _check_rows(x, 2, *rows)
    return _BandedConv.apply(x, k, op, vjp, rows, drop, context.spatial_coords())


def banded_conv3d_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The band of the stride-1 SAME 3-D conv of the whole (N,D,H,W,C)
    tensor, H banded: ``conv3d_same`` (kernel B) on the band with kh // 2
    rows of each neighbour."""
    ph = k.shape[1] // 2
    return _banded(x, k, conv3d_same, conv3d_same_vjp, (ph, ph), (ph, ph))


def banded_conv3d_s2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The band of the stride-2 pad-1 3x3x3 conv of the whole tensor
    (``conv3d_s2``, kernel C): pad 2 rows above (one is read, two keep H
    even), drop the first output row."""
    if x.shape[2] % 2:
        raise ValueError(f"banded_conv3d_s2: a band of {x.shape[2]} rows is odd: every "
                         "stride-2 input of a banded model must split into even bands "
                         "(mesh.band_rows)")
    return _banded(x, k, conv3d_s2, conv3d_s2_vjp, (2, 0), (1, 0))


def banded_deconv3d_k3s2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The band of the exact-2x k3 s2 transposed conv of the whole tensor
    (``deconv3d_k3s2``, kernel D): pad 1 row below, drop the last two
    output rows."""
    return _banded(x, k, deconv3d_k3s2, deconv3d_k3s2_vjp, (0, 1), (0, 2))


def halo_conv2d(x_local: torch.Tensor, kernel: torch.Tensor, mesh,
                axis_name: str = "model") -> torch.Tensor:
    """SAME-padded, stride-1 NHWC 2-D convolution of a tensor whose H is
    split over ``axis_name`` of ``mesh`` (this rank's band ``x_local``, at
    least ``kh // 2`` rows); ``kernel`` (kh, kw, Cin, Cout) with odd kh and
    kw.  Equal to the band of the convolution of the whole tensor.  On a
    CUDA tensor a 3x3 conv at C = Co = 32 runs kernel A through
    ``ops.conv2d.conv2d_same`` on the padded band (its SAME padding adds two
    rows that are cropped); other shapes run ``F.conv2d``, as JAX's runs
    ``lax.conv``."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"halo_conv2d takes odd kernel sizes, got {kh}x{kw}")
    ph, pw = kh // 2, kw // 2
    group = mesh.get_group(axis_name)
    coords = (mesh.get_local_rank(axis_name), dist.get_world_size(group), group)
    x = halo_pad(x_local, 1, ph, ph, coords)
    if (kh, kw) == (3, 3):
        # SAME padding adds a row above and below the padded band: crop them
        return conv2d_same(x, kernel)[:, ph:x.shape[1] - ph]
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).contiguous(),
                 padding=(0, pw))
    return y.permute(0, 2, 3, 1)
