"""DispNet and DispNetC (the 1-D correlation variant).

PyTorch counterpart of ``dsmnet_tpu/models/dispnet.py`` (:30-142): an
encoder of strided 2-D convs and a six-level decoder of 4x4 stride-2
deconvs, crop-concat skips and 0.1-scaled 1-channel disparity heads; every
conv carries a bias and there is no BN.  DispNet encodes the two views
concatenated on channels; DispNetC runs conv1/conv2 over both views as one
batch-2N pass and correlates them at 1/4 resolution with D = 41 shifts on
kernel I.

``forward`` returns ``(scales, disps)``, scales 0..6, the heads in float32
and ``disps[0]`` (full resolution, not the coarsest head as in the
reference) clamped when asked (``dispnet.py:13-16,74-76``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.corr import corr1d
from ..ops.resize import upsample_bilinear
from .layers import ConvBN, DeconvBN, crop_cat, reset_parameters

__all__ = ["DispNet", "DispNetC"]

# the encoder after conv2: name, features, kernel, stride (conv3a's input
# width differs between the models)
_ENCODER = (("conv3a", 256, 5, 2), ("conv3b", 256, 3, 1), ("conv4a", 512, 3, 2),
            ("conv4b", 512, 3, 1), ("conv5a", 512, 3, 2), ("conv5b", 512, 3, 1),
            ("conv6a", 1024, 3, 2), ("conv6b", 1024, 3, 1))
# decoder level -> (channels of the deconv and iconv, channels of the skip)
_LEVELS = {5: (512, 512), 4: (256, 512), 3: (128, 256), 2: (64, 128), 1: (32, 64)}


def _conv(cin: int, features: int, kernel: int, stride: int, **kw) -> ConvBN:
    return ConvBN(cin, features, kernel, stride, use_bias=True, **kw)


class _PrHead(nn.Module):
    """Disparity head: a plain 3x3 conv whose init is scaled by 0.1."""

    def __init__(self, cin: int):
        super().__init__()
        self.ConvBN_0 = _conv(cin, 1, 3, 1, relu=False, kernel_scale=0.1)

    def forward(self, x):
        return self.ConvBN_0(x)


class _DispDecoder(nn.Module):
    """The shared 6-level decoder: deconv + crop-concat [deconv, upsampled
    pr, skip] + iconv + 1-channel pr head per level."""

    def __init__(self):
        super().__init__()
        self.pr6 = _PrHead(1024)
        cin = 1024
        for lvl, (ch, skip) in _LEVELS.items():
            self.add_module(f"deconv{lvl}", DeconvBN(cin, ch, 4, 2))
            self.add_module(f"iconv{lvl}", _conv(ch + 1 + skip, ch, 3, 1))
            self.add_module(f"pr{lvl}", _PrHead(ch))
            cin = ch

    def forward(self, bottleneck, skips):
        pr = self.pr6(bottleneck)
        outs, scales = [pr], [6]
        x = bottleneck
        for lvl in _LEVELS:
            deconv = getattr(self, f"deconv{lvl}")(x)
            x = getattr(self, f"iconv{lvl}")(crop_cat(deconv, upsample_bilinear(pr, 2),
                                                      skips[lvl]))
            pr = getattr(self, f"pr{lvl}")(x)
            outs.insert(0, pr)
            scales.insert(0, lvl)
        return scales, outs


def _head_dtype(o: torch.Tensor) -> torch.Tensor:
    """A head in float32, or float64 for a float64 model."""
    return o.to(torch.promote_types(o.dtype, torch.float32))


def _finalize(scales, outs, im_shape, clamp: bool, maxdisp: int, delt: float = 1e-6):
    """Upsample pr1 to full resolution, crop to the input, heads to float32
    (float64 stays float64, as the port's soft-argmin keeps it), clamp
    ``disps[0]`` when asked (``dispnet.py:67-77``)."""
    h, w = im_shape[1], im_shape[2]
    outs = [upsample_bilinear(outs[0], 2)[:, :h, :w, :]] + outs
    outs = [_head_dtype(o) for o in outs]
    if clamp:
        outs[0] = outs[0].clamp(delt, max(maxdisp, w))
    return [0] + scales, outs


class DispNet(nn.Module):
    """Plain encoder-decoder on concat(imL, imR) (reference models/dispnet.py)."""

    def __init__(self, maxdisparity: int = 192, count_levels: int = 7):
        super().__init__()
        self.maxdisparity = maxdisparity
        self.count_levels = count_levels
        self.conv1 = _conv(6, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        _add_encoder(self, 128)
        self.decoder = _DispDecoder()

    def reset_parameters(self, generator: torch.Generator) -> "DispNet":
        """Seeded weights: kernels and biases drawn from ``generator``."""
        return reset_parameters(self, generator)

    def forward(self, imL: torch.Tensor, imR: torch.Tensor, clamp: bool = False):
        if imL.shape != imR.shape:
            raise ValueError(f"image shapes differ: {tuple(imL.shape)} vs {tuple(imR.shape)}")
        conv1 = self.conv1(torch.cat([imL, imR], dim=-1))
        conv2 = self.conv2(conv1)
        skips = {2: conv2, 1: conv1}
        scales, outs = self.decoder(_encode(self, conv2, skips), skips)
        return _finalize(scales, outs, imL.shape, clamp, self.maxdisparity)


class DispNetC(nn.Module):
    """Siamese conv1/conv2 + 1-D correlation (``corr_d`` shifts, 41 by
    default, JAX ``dispnet.py:112``) + redir skip (reference
    models/dispnetcorr.py:25-79)."""

    def __init__(self, maxdisparity: int = 192, count_levels: int = 7, corr_d: int = 41):
        super().__init__()
        self.maxdisparity = maxdisparity
        self.count_levels = count_levels
        self.corr_d = corr_d
        self.conv1 = _conv(3, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.redir = _conv(128, 64, 1, 1)
        _add_encoder(self, self.corr_d + 64)
        self.decoder = _DispDecoder()

    def reset_parameters(self, generator: torch.Generator) -> "DispNetC":
        """Seeded weights: kernels and biases drawn from ``generator``."""
        return reset_parameters(self, generator)

    def forward(self, imL: torch.Tensor, imR: torch.Tensor, clamp: bool = False):
        if imL.shape != imR.shape:
            raise ValueError(f"image shapes differ: {tuple(imL.shape)} vs {tuple(imR.shape)}")
        n = imL.shape[0]
        conv1 = self.conv1(torch.cat([imL, imR], dim=0))
        conv2 = self.conv2(conv1)
        conv2L, conv2R = conv2[:n], conv2[n:]
        corr = corr1d(conv2L, conv2R, self.corr_d)
        x = torch.cat([corr, self.redir(conv2L)], dim=-1)
        skips = {2: conv2L, 1: conv1[:n]}
        scales, outs = self.decoder(_encode(self, x, skips), skips)
        return _finalize(scales, outs, imL.shape, clamp, self.maxdisparity)


def _add_encoder(model: nn.Module, cin: int) -> None:
    for name, f, k, s in _ENCODER:
        model.add_module(name, _conv(cin, f, k, s))
        cin = f


def _encode(model: nn.Module, x: torch.Tensor, skips: dict) -> torch.Tensor:
    """Run conv3a .. conv6b on ``x``: adds conv3b, conv4b, conv5b to
    ``skips`` as levels 3..5 and returns the bottleneck conv6b."""
    for lvl in (3, 4, 5, 6):
        x = getattr(model, f"conv{lvl}b")(getattr(model, f"conv{lvl}a")(x))
        if lvl < 6:
            skips[lvl] = x
    return x
