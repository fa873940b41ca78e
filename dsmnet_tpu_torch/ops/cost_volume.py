"""Concatenation cost volume (plain reference only).

PyTorch counterpart of ``concat_cost_volume_reference``
(``dsmnet_tpu/ops/cost_volume.py:35``).  PSMNet's serving path never
builds the volume (the fused stem, ``ops/fused_costvol.py``, computes the
volume's first convolution from 2-D tap maps); this is the stem's test
oracle.

    cost[n, d, h, w, :F] = fL[n, h, w] * [w >= d]   (mask_left; else fL)
    cost[n, d, h, w, F:] = fR[n, h, w - d] * [w >= d]
and slices with d >= W are zero in both halves (the left half stays
dense for every d when mask_left is False).
"""

from __future__ import annotations

import torch

__all__ = ["concat_cost_volume_reference"]


def concat_cost_volume_reference(fL: torch.Tensor, fR: torch.Tensor, D: int,
                                 mask_left: bool = True) -> torch.Tensor:
    """(N,H,W,F) x2 -> (N,D,H,W,2F)."""
    n, h, w, f = fL.shape
    vol = fL.new_zeros((n, D, h, w, 2 * f))
    for d in range(D):
        if mask_left:
            vol[:, d, :, d:, :f] = fL[:, :, d:]
        else:
            vol[:, d, :, :, :f] = fL
        if d < w:
            vol[:, d, :, d:, f:] = fR[:, :, :w - d]
    return vol
