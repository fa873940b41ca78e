"""GCNet: concat cost volume + 3-D conv hourglass + soft-argmin.

PyTorch counterpart of ``dsmnet_tpu/models/gcnet.py`` (``GCNet``,
:192-231), on its unfolded pathway (``_Feature3D`` :58-86); the JAX
folded pathway is a TPU layout of the same math and parameter tree.

  * 2-D features (``layer2d``): 5x5/s2 conv + BN + ReLU, 8 residual
    blocks, a plain 3x3 conv with bias -> 32 channels at 1/2, both views
    as one batch-2N pass (``siamese``);
  * the (N, D, H/2, W/2, 64) concat volume with D = maxdisparity // 2 and
    the left half dense (``mask_left=False``) on kernel H;
  * the 3-D hourglass (``layer3d``): stride-2 convs l21/l24/l27/l30, two
    refine convs at each level, transposed convs l33..l37 with cropped
    additive skips, every conv and deconv with a bias;
  * soft-argmin of the negated cost over the maxdisparity bins of l37's
    output, cropped to the input size.

``remat`` recomputes each 3-D stage (a conv or deconv with its BN and
ReLU) in the backward, with the volume built inside the two stages that
read it (l21 and l19 + l20), so that it is never kept for the backward:
the JAX folded pathway's remat (``gcnet.py:88-167``).  l37 is kept, as
in JAX.

``forward`` returns ``([0], [disp])`` like the JAX model's ``apply``.

Under a spatial sharding context (``parallel.context``) every ``model``
rank runs the 2-D tower on the whole images; the volume and the 3-D
hourglass run on this rank's band of the 1/2-resolution rows
(``band_multiple`` = 16: l21, l24, l27 and l30 need whole, even bands),
every 3-D op exchanging its halo rows, and the disparity is the band of
the full-resolution rows.  ``GCNetLR`` (``gcnet.py:234-267``), the
bidirectional variant outside the factory, does the same.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.cost_volume import concat_cost_volume
from ..parallel import context as sharding
from ..parallel.context import shard_activation
from ..ops.softargmin import soft_argmin
from .layers import ConvBN, DeconvBN, ResStackGC, crop_add, remat, reset_parameters, siamese

__all__ = ["GCNet", "GCNetLR"]

_F = 32


class _Feature2D(nn.Module):
    """``gcnet.py:33-41``: 5x5/s2 conv(+BN+ReLU), 8 res blocks, plain 3x3."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBN(3, _F, 5, 2, bn=True, use_bias=True)
        self.block1 = ResStackGC(_F, blocks=8)
        self.conv2 = ConvBN(_F, _F, 3, 1, bn=False, relu=False, use_bias=True)

    def forward(self, x):
        return self.conv2(self.block1(self.conv1(x)))


class _Feature3D(nn.Module):
    """``gcnet.py:58-86``: the 3-D hourglass over the volume + soft-argmin."""

    _CONVS = (  # name, cin, features, stride
        ("l19", 2 * _F, _F, 1), ("l20", _F, _F, 1),
        ("l21", 2 * _F, 2 * _F, 2), ("l22", 2 * _F, 2 * _F, 1), ("l23", 2 * _F, 2 * _F, 1),
        ("l24", 2 * _F, 2 * _F, 2), ("l25", 2 * _F, 2 * _F, 1), ("l26", 2 * _F, 2 * _F, 1),
        ("l27", 2 * _F, 2 * _F, 2), ("l28", 2 * _F, 2 * _F, 1), ("l29", 2 * _F, 2 * _F, 1),
        ("l30", 2 * _F, 4 * _F, 2), ("l31", 4 * _F, 4 * _F, 1), ("l32", 4 * _F, 4 * _F, 1),
    )
    _DECONVS = (("l33", 4 * _F, 2 * _F), ("l34", 2 * _F, 2 * _F), ("l35", 2 * _F, 2 * _F),
                ("l36", 2 * _F, _F))

    def __init__(self, remat: bool = False):
        super().__init__()
        self.remat = remat
        for name, cin, f, s in self._CONVS:
            self.add_module(name, ConvBN(cin, f, 3, s, dims=3, bn=True, use_bias=True))
        for name, cin, f in self._DECONVS:
            self.add_module(name, DeconvBN(cin, f, 3, 2, dims=3, bn=True))
        self.l37 = DeconvBN(_F, 1, 3, 2, dims=3, bn=False, relu=False)

    def forward(self, fL, fR, D: int):
        """The hourglass over the (N, D, H, W, 64) concat volume of fL and fR."""
        def vol(a, b):
            return concat_cost_volume(a, b, D, mask_left=False)

        run = remat if self.remat else (lambda m, *a: m(*a))
        if self.remat:  # the volume built inside the two stages that read it
            x21 = remat(lambda a, b: self.l21(vol(a, b)), fL, fR)
            skip = lambda: remat(lambda a, b: self.l20(self.l19(vol(a, b))), fL, fR)
        else:
            v = vol(fL, fR)
            x21, skip = self.l21(v), lambda: self.l20(self.l19(v))
        x24 = run(self.l24, x21)
        x27 = run(self.l27, x24)
        x32 = run(self.l32, run(self.l31, run(self.l30, x27)))
        x33 = crop_add(run(self.l33, x32), run(self.l29, run(self.l28, x27)))
        x34 = crop_add(run(self.l34, x33), run(self.l26, run(self.l25, x24)))
        x35 = crop_add(run(self.l35, x34), run(self.l23, run(self.l22, x21)))
        x36 = crop_add(run(self.l36, x35), skip())
        # (N, 2D, H, W, 1) -> soft-argmin over the doubled disparity axis
        return soft_argmin(self.l37(x36)[..., 0], negate=True)


class GCNet(nn.Module):
    """``gcnet.py:192-231``.  Returns a single full-resolution map."""

    band_multiple = 16  # rows of a band at 1/2 resolution: a multiple of 16

    def __init__(self, maxdisparity: int = 192, count_levels: int = 1, remat: bool = False):
        super().__init__()
        self.maxdisparity = maxdisparity
        self.count_levels = count_levels
        self.layer2d = _Feature2D()
        self.layer3d = _Feature3D(remat)

    def reset_parameters(self, generator: torch.Generator) -> "GCNet":
        """Seeded weights: kernels and biases drawn from ``generator``, BN at identity."""
        return reset_parameters(self, generator)

    def forward(self, imL: torch.Tensor, imR: torch.Tensor, clamp: bool = False):
        if imL.shape != imR.shape:
            raise ValueError(f"image shapes differ: {tuple(imL.shape)} vs {tuple(imR.shape)}")
        fL, fR = siamese(self.layer2d, imL, imR)
        h, w = imL.shape[1], imL.shape[2]
        # H-sharded under a spatial mesh axis: this rank's band from here on
        with sharding.banded(fL.shape[1], self.band_multiple):
            fL, fR = shard_activation(fL), shard_activation(fR)
            disp = self.layer3d(fL, fR, self.maxdisparity // 2)[:, :h, :w, :]
        if clamp:
            disp = disp.clamp(1e-6, max(self.maxdisparity, w))
        return [0], [disp]


class GCNetLR(nn.Module):
    """Bidirectional GCNet (``gcnet.py:234-267``): one 2-D and one 3-D tower
    for the left and the right disparity.  The right view's volume is the
    left view's volume of the horizontally mirrored pair (swap + flip W),
    run through the same hourglass and un-mirrored.  Returns ``(dispL,
    dispR)``, each (N, H, W, 1); not in the factory, as in JAX."""

    band_multiple = 16

    def __init__(self, maxdisparity: int = 192):
        super().__init__()
        self.maxdisparity = maxdisparity
        self.layer2d = _Feature2D()
        self.layer3d = _Feature3D()

    def reset_parameters(self, generator: torch.Generator) -> "GCNetLR":
        """Seeded weights: kernels and biases drawn from ``generator``, BN at identity."""
        return reset_parameters(self, generator)

    def forward(self, imL: torch.Tensor, imR: torch.Tensor):
        if imL.shape != imR.shape:
            raise ValueError(f"image shapes differ: {tuple(imL.shape)} vs {tuple(imR.shape)}")
        fL, fR = siamese(self.layer2d, imL, imR)
        h, w = imL.shape[1], imL.shape[2]
        D = self.maxdisparity // 2
        with sharding.banded(fL.shape[1], self.band_multiple):
            fL, fR = shard_activation(fL), shard_activation(fR)
            dispL = self.layer3d(fL, fR, D)[:, :h, :w, :]
            dispR = self.layer3d(fR.flip(2), fL.flip(2), D).flip(2)[:, :h, :w, :]
        return dispL, dispR
