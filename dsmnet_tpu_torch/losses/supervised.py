"""Supervised pyramid disparity loss (``dsmnet_tpu/losses/supervised.py``;
reference losses/loss.py:326-338,407-421).

Per level: the prediction upsampled to full resolution (align-corners
bilinear, scale 2^level), masked (gt > 0) L1 over a count floored at 1,
plus 0.1 * mean(clip(|dx| + |dy|, 0, 1)) over the same mask when
``flag_smooth``.  Levels are combined with the curriculum weights,
indexed by *scale*: PSMNet returns scales [0, 0, 0], so all three heads
take ``weights[0]``.

Under a sharding context (``parallel/context.py``) each rank's loss is
its share of the loss of the global batch: the mask count is global, so
the ranks' losses sum to it.  Inside a banded section (a model that bands
H, ``parallel.context.banded``) the maps and the ground truth are this
rank's bands of rows, the count and the sums run over the whole mesh,
and the smoothness term's ``diff1_dy`` reads the first row of the band
below; the count's floor of 1 applies to the global count.
"""

from __future__ import annotations

import torch

from ..ops.gradients import diff1_dx, diff1_dy
from ..ops.resize import upsample_bilinear
from ..parallel.context import data_sum, in_band

__all__ = ["supervised_level_loss", "supervised_pyramid_loss"]


def supervised_level_loss(disp_gt: torch.Tensor, disp: torch.Tensor, flag_smooth: bool = False,
                          factor: float = 1.0) -> torch.Tensor:
    """Masked L1 (+ optional clipped smoothness) at one level.  Under a
    sharding context this rank's share: its masked sums over the global
    count."""
    mask = (disp_gt > 0).to(disp.dtype)
    count = data_sum(mask.sum()).clamp(min=1.0)
    loss = ((disp_gt - disp).abs() * mask).sum() / count
    if flag_smooth:
        dxdy = (diff1_dx(disp).abs() + diff1_dy(disp).abs()) / factor
        loss = loss + 0.1 * (dxdy.clamp(0.0, 1.0) * mask).sum() / count
    return loss


def supervised_pyramid_loss(disp_gt: torch.Tensor, disps, scales, weights,
                            flag_smooth: bool = True) -> torch.Tensor:
    """Weighted sum of the per-level losses; ``weights`` (count_levels,)."""
    h, w = disp_gt.shape[1], disp_gt.shape[2]
    weights = torch.as_tensor(weights, dtype=disp_gt.dtype, device=disp_gt.device)
    loss = disp_gt.new_zeros(())
    for pred, level in zip(disps, scales):
        if level > 0:
            if in_band():
                raise NotImplementedError("a banded model's maps are at full resolution "
                                          "(scale 0): no banded upsample is ported")
            pred = upsample_bilinear(pred, 2 ** level)[:, :h, :w]
        loss = loss + weights[level] * supervised_level_loss(disp_gt, pred, flag_smooth)
    return loss
