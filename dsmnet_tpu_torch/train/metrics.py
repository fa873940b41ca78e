"""Accuracy metrics and host-side meters (``dsmnet_tpu/train/metrics.py``).

D1/EPE as the reference training script computes them (stereo.py:103-113): EPE =
mean |d - d_gt| over d_gt > 0; D1 = percentage of valid pixels that are
neither within 3 px nor within 5% of the ground truth.
"""

from __future__ import annotations

import torch

from ..parallel.context import data_sum

__all__ = ["d1_epe", "AverageMeter"]


def d1_epe(disp: torch.Tensor, disp_gt: torch.Tensor):
    """(d1_percent, epe) as 0-d tensors, of the global batch under a
    sharding context (over the whole mesh for the bands of a banded
    section: ``parallel.context.data_sum``); a batch with no valid pixel
    gives (0, 0) rather than NaN, so meters can skip it."""
    mask = (disp_gt > 0).to(disp.dtype)
    count = data_sum(mask.sum())
    safe = count.clamp(min=1.0)
    diff = (disp_gt - disp).abs()
    epe = data_sum((diff * mask).sum()) / safe
    good = (diff <= 3.0) | (diff / disp_gt.clamp(min=1e-9) <= 0.05)
    d1 = 100.0 - 100.0 * data_sum((good.to(disp.dtype) * mask).sum()) / safe
    zero = disp.new_zeros(())
    return torch.where(count > 0, d1, zero), torch.where(count > 0, epe, zero)


class AverageMeter:
    """Running value/average meter (reference utils/utils.py:87-117)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
