"""PSMNet (stacked hourglass): SPP feature pyramid + 3-D hourglasses + regression.

PyTorch counterpart of ``dsmnet_tpu/models/psmnet.py``, on its unfolded
pathway (:244-311): channels-last features, the fused cost-volume stem,
NDHWC 3-D convs and the chunked trilinear soft-argmin regression.

Faithful quirks kept on purpose (``psmnet.py:10-17``):
  * convbn pads by its dilation for every kernel, so the SPP 1x1 branch
    convs pad by 1 before their bilinear upsample;
  * an SPP window larger than the 1/4-resolution map (an input under 256
    pixels) pools an empty map, VALID as ``lax.reduce_window``, and the
    branch is its BN's constant (``psmnet.py:48-53,78-81``);
  * the third hourglass receives ``presqu=pre1``;
  * classifier costs accumulate: cost2 += cost1, cost3 += cost2;
  * the model returns [pred3, pred2, pred1], all at scale 0.

``forward`` returns ``(scales, disps)`` like the JAX model's ``apply``; BN
uses batch statistics in train mode (``model.train()``) and the running
statistics in eval mode.

Under a spatial sharding context (``parallel.context``) every ``model``
rank runs the tower on the whole images; the rest runs on this rank's
band of the 1/4-resolution rows (``band_multiple`` = 4: the two stride-2
levels of the hourglasses need whole, even bands), every 3-D op
exchanging its halo rows, and each returned map is the band of the
full-resolution rows.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3d import deconv3d_k3s2
from ..ops.cost_volume import concat_cost_volume
from ..ops.fused_costvol import cost_volume_conv3x3
from ..parallel import context as sharding
from ..parallel.context import shard_activation
from ..parallel.halo import banded_deconv3d_k3s2
from ..ops.regression import trilinear_soft_argmin
from ..ops.resize import resize_bilinear
from .layers import (
    ConvBN,
    Kernel,
    LeanBN,
    ResBlockPSM,
    crop_add,
    default_dtype,
    remat,
    reset_parameters,
    siamese,
    torch_fanin_uniform,
)

__all__ = ["PSMNet"]


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool, stride k, VALID (SPP branches).  A window larger
    than the map gives a map of h // k rows and w // k columns, one of them
    0, as JAX's ``lax.reduce_window``."""
    h, w = x.shape[1:3]
    if h < k or w < k:
        return x[:, : h // k, : w // k]
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def _spp_branch(branch: ConvBN, x: torch.Tensor) -> torch.Tensor:
    """The branch's 1x1 ConvBN (padding 1) on a pooled map.  On an empty
    map the padded conv is (h + 2, w + 2) zeros, then BN and ReLU, as in
    JAX; the kernel enters as a product over the empty map, so its
    gradient is an exact 0, as JAX's, not None."""
    if x.shape[1] and x.shape[2]:
        return branch(x)
    x, kern = branch.Conv_0.cast(x)
    y = F.pad(torch.einsum("nhwc,co->nhwo", x, kern[0, 0]), (0, 0, 1, 1, 1, 1))
    return F.relu(branch.BatchNorm_0(branch.Conv_0.add_bias(y)))


class _FeatureExtraction(nn.Module):
    """Stem + 4 residual stages + SPP + fuse -> 32 channels at 1/4 scale."""

    def __init__(self):
        super().__init__()
        self.firstconv0 = ConvBN(3, 32, 3, 2, bn=True, padding=1)
        self.firstconv1 = ConvBN(32, 32, 3, 1, bn=True, padding=1)
        self.firstconv2 = ConvBN(32, 32, 3, 1, bn=True, padding=1)
        self.stages = []
        cin = 32
        for name, planes, blocks, stride, dilation in (("layer1", 32, 3, 1, 1),
                                                       ("layer2", 64, 16, 2, 1),
                                                       ("layer3", 128, 3, 1, 1),
                                                       ("layer4", 128, 3, 1, 2)):
            names = []
            for i in range(blocks):
                self.add_module(f"{name}_{i}", ResBlockPSM(
                    cin, planes, stride if i == 0 else 1, dilation))
                names.append(f"{name}_{i}")
                cin = planes
            self.stages.append(names)
        for i in range(4):
            self.add_module(f"branch{i}", ConvBN(128, 32, 1, 1, bn=True, padding=1))
        self.lastconv0 = ConvBN(320, 128, 3, 1, bn=True, padding=1)
        self.lastconv1 = ConvBN(128, 32, 1, 1, bn=False, relu=False, padding=0)

    def _stage(self, x, i):
        for name in self.stages[i]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x):
        x = self.firstconv2(self.firstconv1(self.firstconv0(x)))
        x = self._stage(x, 0)
        raw = self._stage(x, 1)
        skip = self._stage(self._stage(raw, 2), 3)
        h, w = skip.shape[1], skip.shape[2]
        branches = []
        for i, k in enumerate((64, 32, 16, 8)):
            b = _spp_branch(getattr(self, f"branch{i}"), _avg_pool(skip, k))
            branches.append(resize_bilinear(b, (h, w)))
        fused = torch.cat([raw, skip] + branches[::-1], dim=-1)
        return self.lastconv1(self.lastconv0(fused))


class _Deconv(Kernel):
    """ConvTranspose3d k3 s2 p1 op1 kernel holder (flax (3,3,3,Cout,Cin))."""

    def __init__(self, cin: int, features: int):
        super().__init__((3, 3, 3, features, cin), torch_fanin_uniform)

    def forward(self, x):
        x, k = self.cast(x)
        return banded_deconv3d_k3s2(x, k) if sharding.in_band() else deconv3d_k3s2(x, k)


class _Hourglass(nn.Module):
    """Stride-2 down x2, deconv up x2 with presqu/postsqu cross-connections."""

    def __init__(self, p: int):
        super().__init__()
        self.conv1 = ConvBN(p, 2 * p, 3, 2, dims=3, bn=True, relu=True)
        self.conv2 = ConvBN(2 * p, 2 * p, 3, 1, dims=3, bn=True, relu=False)
        self.conv3 = ConvBN(2 * p, 2 * p, 3, 2, dims=3, bn=True, relu=True)
        self.conv4 = ConvBN(2 * p, 2 * p, 3, 1, dims=3, bn=True, relu=True)
        self.conv5 = _Deconv(2 * p, 2 * p)
        self.conv5_bn = LeanBN(2 * p)
        self.conv6 = _Deconv(2 * p, p)
        self.conv6_bn = LeanBN(p)

    def forward(self, x, presqu, postsqu):
        out = self.conv1(x)
        pre = self.conv2(out)
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = self.conv4(self.conv3(pre))
        post = self.conv5_bn(self.conv5(out))
        post = F.relu(crop_add(post, presqu if presqu is not None else pre))
        out = self.conv6_bn(self.conv6(post))
        return out, pre, post


class _FusedStem(Kernel):
    """Cost-volume build + dres0 first conv, fused: the D/4 x H x W x 2F
    volume is never materialized.  Its kernel sits directly under
    ``dres0_0`` as in the flax tree."""

    def __init__(self, f2: int, features: int, D: int, mask_left: bool = True):
        super().__init__((3, 3, 3, f2, features))
        self.D = D
        self.mask_left = mask_left
        self.BatchNorm_0 = LeanBN(features)

    def forward(self, fL, fR):
        dt = default_dtype() or fL.dtype
        x = cost_volume_conv3x3(fL.to(dt), fR.to(dt), self.kernel.to(dt), self.D,
                                self.mask_left)
        return F.relu(self.BatchNorm_0(x))


class _Classifier(nn.Module):
    """convbn3d + relu, then the Cout=1 3-D conv."""

    def __init__(self):
        super().__init__()
        self.c0 = ConvBN(32, 32, 3, 1, dims=3, bn=True)
        self.c1 = ConvBN(32, 1, 3, 1, dims=3, bn=False, relu=False)

    def forward(self, x):
        return self.c1(self.c0(x))


class PSMNet(nn.Module):
    """Stacked-hourglass PSMNet (reference stackhourglass.py:64-168).

    ``fused_stem=False`` builds the masked concat volume (kernel H) and runs
    ``dres0_0`` as a plain ConvBN over it (JAX ``psmnet.py:246-250``; the
    parameter tree then has ``dres0_0.Conv_0.kernel``); ``remat``
    recomputes each hourglass in the backward (JAX ``psmnet.py:228``);
    ``count_levels`` is the number of loss levels, as the JAX field."""

    band_multiple = 4  # rows of a band at 1/4 resolution: a multiple of 4

    def __init__(self, maxdisparity: int = 192, count_levels: int = 1,
                 fused_stem: bool = True, remat: bool = False):
        super().__init__()
        self.maxdisparity = maxdisparity
        self.count_levels = count_levels
        self.fused_stem = fused_stem
        self.remat = remat
        self.feature_extraction = _FeatureExtraction()
        self.dres0_0 = _FusedStem(64, 32, maxdisparity // 4) if fused_stem \
            else ConvBN(64, 32, 3, 1, dims=3, bn=True, relu=True)
        self.dres0_1 = ConvBN(32, 32, 3, 1, dims=3, bn=True, relu=True)
        self.dres1_0 = ConvBN(32, 32, 3, 1, dims=3, bn=True, relu=True)
        self.dres1_1 = ConvBN(32, 32, 3, 1, dims=3, bn=True, relu=False)
        self.dres2 = _Hourglass(32)
        self.dres3 = _Hourglass(32)
        self.dres4 = _Hourglass(32)
        self.classif1 = _Classifier()
        self.classif2 = _Classifier()
        self.classif3 = _Classifier()

    def reset_parameters(self, generator: torch.Generator) -> "PSMNet":
        """Seeded weights: every kernel drawn from ``generator``, BN at identity."""
        return reset_parameters(self, generator)

    def forward(self, imL: torch.Tensor, imR: torch.Tensor, clamp: bool = False):
        if imL.shape != imR.shape:
            raise ValueError(f"image shapes differ: {tuple(imL.shape)} vs {tuple(imR.shape)}")
        fL, fR = siamese(self.feature_extraction, imL, imR)
        # H-sharded under a spatial mesh axis: this rank's band from here on
        with sharding.banded(fL.shape[1], self.band_multiple):
            return self._regularize(imL, fL, fR, clamp)

    def _regularize(self, imL, fL, fR, clamp):
        """Volume, hourglasses and regression over the features fL, fR."""
        fL, fR = shard_activation(fL), shard_activation(fR)

        if self.fused_stem:
            cost0 = self.dres0_0(fL, fR)
        else:
            cost0 = self.dres0_0(concat_cost_volume(fL, fR, self.maxdisparity // 4,
                                                    mask_left=True))
        cost0 = self.dres0_1(cost0)
        d1 = self.dres1_1(self.dres1_0(cost0))
        cost0 = crop_add(d1, cost0)

        hg = remat if self.remat else (lambda m, *a: m(*a))
        out1, pre1, post1 = hg(self.dres2, cost0, None, None)
        out1 = crop_add(out1, cost0)
        out2, pre2, post2 = hg(self.dres3, out1, pre1, post1)
        out2 = crop_add(out2, cost0)
        out3, pre3, post3 = hg(self.dres4, out2, pre1, post2)
        out3 = crop_add(out3, cost0)

        cost1 = self.classif1(out1)
        cost2 = crop_add(self.classif2(out2), cost1)
        cost3 = crop_add(self.classif3(out3), cost2)

        h, w = imL.shape[1], imL.shape[2]
        full = (self.maxdisparity, h, w)
        pred3 = trilinear_soft_argmin(cost3, full)
        pred1 = trilinear_soft_argmin(cost1, full)
        pred2 = trilinear_soft_argmin(cost2, full)
        if clamp:
            pred3 = pred3.clamp(1e-6, max(self.maxdisparity, w))
        return [0, 0, 0], [pred3, pred2, pred1]
