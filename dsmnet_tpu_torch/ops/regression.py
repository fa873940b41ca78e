"""Trilinear upsample + soft-argmin disparity regression, chunked over H.

PyTorch counterpart of ``dsmnet_tpu/ops/regression.py``: PSMNet lifts each
1/4-resolution classifier cost to full resolution with an align-corners
trilinear upsample and collapses the disparity axis with softmax +
expectation.  The D-upsample runs once at coarse spatial resolution; each
chunk of output rows is then expanded to full resolution, reduced to
disparity and dropped, so the (N, D, H, W) logits never exist at once.

The arithmetic is float32 whatever the compute dtype (float64 for a
float64 cost, which the parity tests use).
"""

from __future__ import annotations

import torch

from .resize import interp_tensor

__all__ = ["trilinear_soft_argmin"]


def trilinear_soft_argmin(cost: torch.Tensor, out_dhw: tuple[int, int, int],
                          h_chunk: int = 32) -> torch.Tensor:
    """soft_argmin(resize_trilinear(cost, out_dhw)) without materializing
    the upsampled volume.  cost: (N, Dc, Hc, Wc, 1); returns (N, H, W, 1)."""
    n, dc, hc, wc, c1 = cost.shape
    if c1 != 1:
        raise ValueError(f"cost must have one channel, got shape {tuple(cost.shape)}")
    d, h, w = out_dhw
    acc = torch.promote_types(cost.dtype, torch.float32)
    x = cost[..., 0].to(acc)
    Ad = interp_tensor(d, dc, x)
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
