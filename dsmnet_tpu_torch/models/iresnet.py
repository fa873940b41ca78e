"""iResNet: initial disparity + iterative warp-based refinement.

PyTorch counterpart of ``dsmnet_tpu/models/iresnet.py`` (:31-150).  A
shared multi-scale stem runs over both views as one batch-2N pass and
fuses the stride-2 and stride-4 features back into full-resolution
32-channel descriptors.  The initial-disparity subnet is a DispNetC-style
encoder-decoder over an 81-shift correlation at 1/4 (kernel I).  Each
refinement iteration warps the right descriptors by the current
disparity, forms the reconstruction error, correlates the shared 1/2
projections (D = 41, stride 2, 3x3 average pool; kernel I again) and adds
residuals to the 1/4, 1/2 and full-resolution heads.  Every conv carries
a bias and there is no BN, as in the JAX model; module names follow the
flax tree.

``forward`` returns ``(scales, disps)``: per iteration r_pr0, r_pr1, r_pr2
(scales 0, 1, 2) in front of pr0 .. pr6 (scales 0 .. 6), the heads in
float32 (float64 for a float64 model) and ``disps[0]`` clamped to [1e-6,
max(maxdisparity, W)] when asked.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.corr import corr1d
from ..ops.resize import upsample2x
from ..ops.warp import imwarp
from .dispnet import _LEVELS, _PrHead, _conv, _head_dtype
from .layers import DeconvBN, crop_cat, reset_parameters

__all__ = ["IResNet"]

# refinement convs: name -> (input channels, features, stride)
_REFINE = {"r_conv0": (65, 32, 1), "r_conv1": (32, 64, 2), "c_conv1": (64, 64, 1),
           "r_conv1_1": (105, 64, 1), "r_conv2": (64, 128, 2), "r_conv2_1": (128, 128, 1),
           "r_iconv1": (129, 64, 1), "r_iconv0": (65, 32, 1)}


class IResNet(nn.Module):
    """Reference models/iresnet.py: stem, initial-disparity subnet and
    ``iterations`` refinement passes (1 by default)."""

    corr_d, refine_d = 81, 41

    def __init__(self, maxdisparity: int = 192, count_levels: int = 7, iterations: int = 1):
        super().__init__()
        self.maxdisparity = maxdisparity
        self.count_levels = count_levels
        self.iterations = iterations
        # the multi-scale stem (iresnet.py:27-31,93-104)
        self.conv1 = _conv(3, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.deconv1_s = DeconvBN(64, 32, 4, 2)
        self.deconv2_s = DeconvBN(128, 32, 8, 4)
        self.conv_de1_de2 = _conv(64, 32, 1, 1)
        # the initial-disparity subnet (iresnet.py:107-165)
        self.redir = _conv(128, 64, 1, 1)
        cin = self.corr_d + 64
        for name, f, s in (("conv3", 256, 2), ("conv3_1", 256, 1), ("conv4", 512, 2),
                           ("conv4_1", 512, 1), ("conv5", 512, 2), ("conv5_1", 512, 1),
                           ("conv6", 1024, 2), ("conv6_1", 1024, 1)):
            self.add_module(name, _conv(cin, f, 3, s))
            cin = f
        self.pr6 = _PrHead(1024)
        for lvl, (ch, skip) in _LEVELS.items():
            self.add_module(f"deconv{lvl}", DeconvBN(cin, ch, 4, 2))
            self.add_module(f"iconv{lvl}", _conv(ch + 1 + skip, ch, 3, 1))
            self.add_module(f"pr{lvl}", _PrHead(ch))
            cin = ch
        self.deconv0 = DeconvBN(32, 32, 4, 2)
        self.iconv0 = _conv(32 + 1 + 32, 32, 3, 1)
        self.pr0 = _PrHead(32)
        # the refinement subnet (iresnet.py:64-79,167-197)
        for name, (ci, f, s) in _REFINE.items():
            self.add_module(name, _conv(ci, f, 3, s))
        self.r_res2 = _PrHead(128)
        self.r_deconv1 = DeconvBN(128, 64, 4, 2)
        self.r_res1 = _PrHead(64)
        self.r_deconv0 = DeconvBN(64, 32, 4, 2)
        self.r_res0 = _PrHead(32)

    def reset_parameters(self, generator: torch.Generator) -> "IResNet":
        """Seeded weights: kernels and biases drawn from ``generator``."""
        return reset_parameters(self, generator)

    def forward(self, imL: torch.Tensor, imR: torch.Tensor, clamp: bool = False):
        if imL.shape != imR.shape:
            raise ValueError(f"image shapes differ: {tuple(imL.shape)} vs {tuple(imR.shape)}")
        n, h, w = imL.shape[:3]
        # both views through the shared stem as one batch-2N pass
        conv1LR = self.conv1(torch.cat([imL, imR], dim=0))
        conv2LR = self.conv2(conv1LR)
        up1LR = self.deconv1_s(conv1LR)[:, :h, :w]
        descLR = self.conv_de1_de2(crop_cat(up1LR, self.deconv2_s(conv2LR)))
        conv1L, conv2L, conv2R = conv1LR[:n], conv2LR[:n], conv2LR[n:]
        descL, descR = descLR[:n], descLR[n:]

        x = torch.cat([corr1d(conv2L, conv2R, self.corr_d), self.redir(conv2L)], dim=-1)
        skips = {2: conv2L, 1: conv1L}
        for lvl in (3, 4, 5, 6):
            x = getattr(self, f"conv{lvl}_1")(getattr(self, f"conv{lvl}")(x))
            if lvl < 6:
                skips[lvl] = x
        pr = self.pr6(x)
        outs, scales, prs = [pr], [6], {}
        for lvl in _LEVELS:
            deconv = getattr(self, f"deconv{lvl}")(x)
            x = getattr(self, f"iconv{lvl}")(crop_cat(deconv, upsample2x(pr), skips[lvl]))
            pr = prs[lvl] = getattr(self, f"pr{lvl}")(x)
            outs.insert(0, pr)
            scales.insert(0, lvl)
        iconv0 = self.iconv0(crop_cat(self.deconv0(x), upsample2x(prs[1]), descL))
        r_pr0 = self.pr0(iconv0)
        outs.insert(0, r_pr0)
        scales.insert(0, 0)

        r_pr2, r_pr1 = prs[2], prs[1]
        # loop-invariant shared projection, both views in one batch pass
        c1LR = self.c_conv1(conv1LR)
        c1L, c1R = c1LR[:n], c1LR[n:]
        for _ in range(self.iterations):
            recon_err = (descL - imwarp(descR, -r_pr0)).abs()
            r_conv0 = self.r_conv0(crop_cat(recon_err, r_pr0, descL))
            r_corr = corr1d(c1L, c1R, self.refine_d, stride=2, kernel_size=3)
            r_conv1_1 = self.r_conv1_1(crop_cat(self.r_conv1(r_conv0), r_corr))
            r_conv2_1 = self.r_conv2_1(self.r_conv2(r_conv1_1))
            r_res2 = self.r_res2(r_conv2_1)
            r_pr2 = r_pr2 + r_res2
            r_iconv1 = self.r_iconv1(crop_cat(self.r_deconv1(r_conv2_1), upsample2x(r_res2),
                                              r_conv1_1))
            r_res1 = self.r_res1(r_iconv1)
            r_pr1 = r_pr1 + r_res1
            r_iconv0 = self.r_iconv0(crop_cat(self.r_deconv0(r_iconv1), upsample2x(r_res1),
                                              r_conv0))
            r_pr0 = r_pr0 + self.r_res0(r_iconv0)
            outs[:0] = [r_pr0, r_pr1, r_pr2]
            scales[:0] = [0, 1, 2]

        outs = [_head_dtype(o) for o in outs]
        if clamp:
            outs[0] = outs[0].clamp(1e-6, max(self.maxdisparity, w))
        return scales, outs
