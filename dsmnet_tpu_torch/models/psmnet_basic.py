"""PSMNet (basic): the non-hourglass variant.

PyTorch counterpart of ``dsmnet_tpu/models/psmnet_basic.py`` (:23-52):
PSMNet's SPP feature extractor, the masked D/4 concat volume on kernel
H, five residual 3-D blocks and one classifier, then the trilinear
soft-argmin regression of the stacked model.

The feature tower runs once per view, as in JAX (``psmnet_basic.py:30-32``),
not as one batch-2N pass: in train mode each BN updates its running
statistics twice, left view then right, so ``calibrate_batch_stats``
(momentum 0) leaves the tower's BNs with the right view's statistics.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.cost_volume import concat_cost_volume
from ..ops.regression import trilinear_soft_argmin
from .layers import ConvBN, crop_add, reset_parameters
from .psmnet import _FeatureExtraction

__all__ = ["PSMNetBasic"]


def _c3(cin: int, relu: bool) -> ConvBN:
    return ConvBN(cin, 32, 3, 1, dims=3, bn=True, relu=relu)


class PSMNetBasic(nn.Module):
    """PSMNet basic (reference basic.py:18-42,80-90)."""

    def __init__(self, maxdisparity: int = 192, count_levels: int = 1):
        super().__init__()
        self.maxdisparity = maxdisparity
        self.count_levels = count_levels
        self.feature_extraction = _FeatureExtraction()
        self.dres0_0 = _c3(64, True)
        self.dres0_1 = _c3(32, True)
        for i in range(1, 5):
            self.add_module(f"dres{i}_0", _c3(32, True))
            self.add_module(f"dres{i}_1", _c3(32, False))
        self.classify_0 = _c3(32, True)
        self.classify_1 = ConvBN(32, 1, 3, 1, dims=3, bn=False, relu=False)

    def reset_parameters(self, generator: torch.Generator) -> "PSMNetBasic":
        """Seeded weights: every kernel drawn from ``generator``, BN at identity."""
        return reset_parameters(self, generator)

    def forward(self, imL: torch.Tensor, imR: torch.Tensor, clamp: bool = False):
        if imL.shape != imR.shape:
            raise ValueError(f"image shapes differ: {tuple(imL.shape)} vs {tuple(imR.shape)}")
        fL = self.feature_extraction(imL)
        fR = self.feature_extraction(imR)
        cost = concat_cost_volume(fL, fR, self.maxdisparity // 4, mask_left=True)
        x = self.dres0_1(self.dres0_0(cost))
        for i in range(1, 5):
            y = getattr(self, f"dres{i}_1")(getattr(self, f"dres{i}_0")(x))
            x = crop_add(y, x)
        out = self.classify_1(self.classify_0(x))
        h, w = imL.shape[1], imL.shape[2]
        pred = trilinear_soft_argmin(out, (self.maxdisparity, h, w))
        if clamp:
            pred = pred.clamp(1e-6, max(self.maxdisparity, w))
        return [0], [pred]
