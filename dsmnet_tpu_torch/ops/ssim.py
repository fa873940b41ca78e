"""SSIM map of the reference's channel-collapsing variant
(``dsmnet_tpu/ops/ssim.py``; reference losses/SSIM.py:24-42).

The reference divides its Gaussian window by the channel count and
convolves with ``groups=1``: a Gaussian blur of the *channel mean*.  So
every statistic (mu, sigma) is one of channel-averaged quantities, and
the map has one channel.  Window 11, sigma 1.5, C1 = 0.01^2, C2 = 0.03^2.
The blur is two separable 1-D convolutions of the one-channel maps.

Inside a banded section (``parallel.context.banded``) the images are
this rank's band of rows: the five one-channel maps are padded with
``window_size // 2`` rows of the bands above and below
(``parallel.halo.halo_pad``, zeros at the image's top and bottom, which
are the whole image's zero padding), blurred vertically without padding,
so that exactly the band's rows come out, then horizontally.  Padding
the five maps moves five channels of rows, fewer than the two 3-channel
images would.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import context

__all__ = ["ssim_map", "gaussian_kernel_1d"]


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Normalized 1-D Gaussian taps (reference losses/SSIM.py:6-8), computed
    in float64 and rounded to float32, as JAX's are: a float64 map is
    blurred with these float32 values."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs.astype(np.float64) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (N,H,W,1) maps, zero-padded to the same
    size; of a band of rows inside a banded section, the band of the whole
    maps' blur."""
    g = torch.as_tensor(gaussian_kernel_1d(window_size, sigma), dtype=x.dtype, device=x.device)
    p = window_size // 2
    if context.in_band():
        from ..parallel.halo import halo_pad

        x, ph = halo_pad(x, 1, p, p), 0
    else:
        ph = p
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, g.view(1, 1, window_size, 1), padding=(ph, 0))
    y = F.conv2d(y, g.view(1, 1, 1, window_size), padding=(0, p))
    return y.permute(0, 2, 3, 1)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
             sigma: float = 1.5) -> torch.Tensor:
    """SSIM map of two NHWC images -> (N,H,W,1), of their channel means;
    sigma is blur(mean_c(x * x)) - blur(mean_c(x))^2, so the variance
    across channels is folded in."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    # the five maps blurred as one batch of channels
    maps = torch.cat([img1.mean(-1, keepdim=True), img2.mean(-1, keepdim=True),
                      (img1 * img1).mean(-1, keepdim=True),
                      (img2 * img2).mean(-1, keepdim=True),
                      (img1 * img2).mean(-1, keepdim=True)], dim=0)
    mu1, mu2, s11, s22, s12 = _blur(maps, window_size, sigma).chunk(5, dim=0)
    sigma1_sq = s11 - mu1 * mu1
    sigma2_sq = s22 - mu2 * mu2
    sigma12 = s12 - mu1 * mu2
    num = (2.0 * mu1 * mu2 + c1) * (2.0 * sigma12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (sigma1_sq + sigma2_sq + c2)
    return num / den
