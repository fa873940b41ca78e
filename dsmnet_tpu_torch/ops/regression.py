"""Trilinear upsample + soft-argmin disparity regression, chunked over H.

PyTorch counterpart of ``dsmnet_tpu/ops/regression.py``: PSMNet lifts each
1/4-resolution classifier cost to full resolution with an align-corners
trilinear upsample and collapses the disparity axis with softmax +
expectation.  The D-upsample runs once at coarse spatial resolution; each
chunk of output rows is then expanded to full resolution, reduced to
disparity and dropped, so the (N, D, H, W) logits never exist at once.

The arithmetic is float32 whatever the compute dtype (float64 for a
float64 cost, which the parity tests use).

Inside a banded section (``parallel.context.banded``) the cost is this
rank's band of coarse rows and the result its band of output rows: an
output row near the band's edge interpolates between a coarse row of the
band and one of its neighbour's, so the cost is padded by a row of each
neighbour (zeros at the border, where the weights are 0) and the band's
output rows take their rows of ``Ah`` at the global coarse rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import context
from .resize import interp_tensor

__all__ = ["trilinear_soft_argmin"]


def trilinear_soft_argmin(cost: torch.Tensor, out_dhw: tuple[int, int, int],
                          h_chunk: int = 32) -> torch.Tensor:
    """soft_argmin(resize_trilinear(cost, out_dhw)) without materializing
    the upsampled volume.  cost: (N, Dc, Hc, Wc, 1); returns (N, H, W, 1),
    or this rank's band of its H rows inside a banded section."""
    n, dc, hc, wc, c1 = cost.shape
    if c1 != 1:
        raise ValueError(f"cost must have one channel, got shape {tuple(cost.shape)}")
    d, h, w = out_dhw
    acc = torch.promote_types(cost.dtype, torch.float32)
    banded = context.in_band()
    if banded:
        from ..parallel.halo import halo_pad

        m, size, _ = context.spatial_coords()
        cost = halo_pad(cost, 2, 1, 1)
        band_h = h // size
        # Ah of the whole H, its columns the global coarse rows -1 .. Hc:
        # the band's output rows against its padded coarse rows
        Ah = F.pad(interp_tensor(h, hc * size, cost, acc), (1, 1))
        Ah = Ah[m * band_h:(m + 1) * band_h, m * hc:(m + 1) * hc + 2]
        h = band_h
    x = cost[..., 0].to(acc)
    Ad = interp_tensor(d, dc, x)
    if not banded:
        Ah = interp_tensor(h, hc, x)
    Aw = interp_tensor(w, wc, x)
    x = torch.einsum("ed,ndhw->nehw", Ad, x)  # (N, D, Hc, Wc)
    dvals = torch.arange(d, dtype=acc, device=x.device)
    rows = []
    for i0 in range(0, h, h_chunk):
        hi = torch.einsum("ih,ndhw->ndiw", Ah[i0:i0 + h_chunk], x)
        full = torch.einsum("jw,ndiw->ndij", Aw, hi)  # (N, D, chunk, W)
        p = torch.softmax(full, dim=1)
        rows.append(torch.einsum("ndij,d->nij", p, dvals))
    return torch.cat(rows, dim=1)[..., None]
