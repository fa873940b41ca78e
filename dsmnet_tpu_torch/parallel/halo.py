"""Halo-exchange convolution over an H-sharded mesh axis
(``dsmnet_tpu/parallel/halo.py``).

Each rank holds a contiguous band of rows of an NHWC tensor.  To convolve
its band with SAME padding it needs ``kh // 2`` rows of each neighbour:
the ranks swap those rows with ``batch_isend_irecv`` over the axis's
group, the first and last rank take zeros for the image border, and each
rank convolves its padded band without H padding.  The exchange is an
autograd ``Function``: its backward sends each halo's gradient back to the
rank that owns the rows.  The spatially sharded models (``ROADMAP.md``,
queue 1, "Spatial sharding") will reuse it.

On a CUDA tensor a 3x3 conv at C = Co = 32 runs kernel A through
``ops.conv2d.conv2d_same`` on the padded band (its SAME padding adds two
rows that are cropped); other shapes run ``F.conv2d``, as JAX's runs
``lax.conv``.  gloo, the backend of ranks that share a card, moves the
halo rows of a CUDA tensor through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.conv2d import conv2d_same

__all__ = ["halo_conv2d"]


def _exchange(lo: torch.Tensor, hi: torch.Tensor, index: int, size: int, group):
    """Send ``lo`` to the rank before this one and ``hi`` to the rank after
    it; returns (what the rank before sent as its ``hi``, what the rank
    after sent as its ``lo``), zeros at the ends of the axis."""
    stage = dist.get_backend(group) == "gloo" and lo.is_cuda
    dev = lo.device
    lo_s, hi_s = (lo.cpu(), hi.cpu()) if stage else (lo.contiguous(), hi.contiguous())
    from_prev, from_next = torch.zeros_like(hi_s), torch.zeros_like(lo_s)
    ops = []
    if index > 0:
        prev = dist.get_global_rank(group, index - 1)
        ops += [dist.P2POp(dist.isend, lo_s, prev, group), dist.P2POp(dist.irecv, from_prev,
                                                                      prev, group)]
    if index < size - 1:
        nxt = dist.get_global_rank(group, index + 1)
        ops += [dist.P2POp(dist.isend, hi_s, nxt, group), dist.P2POp(dist.irecv, from_next,
                                                                     nxt, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if stage:
        from_prev, from_next = from_prev.to(dev), from_next.to(dev)
    return from_prev, from_next


class _HaloPad(torch.autograd.Function):
    """(N, h, W, C) -> (N, h + 2 ph, W, C): the band with ``ph`` rows of each
    neighbour above and below it (zeros at the global border)."""

    @staticmethod
    def forward(ctx, x, ph, index, size, group):
        ctx.ph, ctx.index, ctx.size, ctx.group = ph, index, size, group
        top, bottom = _exchange(x[:, :ph], x[:, -ph:], index, size, group)
        return torch.cat([top, x, bottom], dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ph = ctx.ph
        # the gradient of my top halo belongs to the rank before me (its last
        # rows), of my bottom halo to the rank after me (its first rows)
        from_prev, from_next = _exchange(g[:, :ph], g[:, -ph:], ctx.index, ctx.size, ctx.group)
        dx = g[:, ph:-ph].clone()
        dx[:, :ph] += from_prev
        dx[:, -ph:] += from_next
        return dx, None, None, None, None


def halo_conv2d(x_local: torch.Tensor, kernel: torch.Tensor, mesh,
                axis_name: str = "model") -> torch.Tensor:
    """SAME-padded, stride-1 NHWC 2-D convolution of a tensor whose H is
    split over ``axis_name`` of ``mesh`` (this rank's band ``x_local``, at
    least ``kh // 2`` rows); ``kernel`` (kh, kw, Cin, Cout) with odd kh and
    kw.  Equal to the band of the convolution of the whole tensor."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"halo_conv2d takes odd kernel sizes, got {kh}x{kw}")
    ph, pw = kh // 2, kw // 2
    if ph > x_local.shape[1]:
        raise ValueError(f"a band of {x_local.shape[1]} rows is thinner than the halo ({ph})")
    x = x_local
    if ph > 0:
        group = mesh.get_group(axis_name)
        index, size = mesh.get_local_rank(axis_name), dist.get_world_size(group)
        x = _HaloPad.apply(x, ph, index, size, group)
    if (kh, kw) == (3, 3):
        # SAME padding adds a row above and below the padded band: crop them
        return conv2d_same(x, kernel)[:, ph:x.shape[1] - ph]
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).contiguous(),
                 padding=(0, pw))
    return y.permute(0, 2, 3, 1)
