"""Finite differences and edge-aware smoothness terms of NHWC maps
(``dsmnet_tpu/ops/gradients.py``; reference losses/loss.py:36-147).

The reference's padding conventions: a first difference is zero-padded
by one at the right / bottom, a second or ratio difference by one on both
sides of the differentiated axis, so every output keeps its input's
shape.  Images are (N,H,W,C), disparities (N,H,W,1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "diff1_dx",
    "diff1_dy",
    "diff2_dx",
    "diff2_dy",
    "diff_z_dx",
    "diff_z_dy",
    "c_imdiff1",
    "c_ds1",
    "c_ds2",
    "c_ds3",
    "c_ds3t",
    "c_ds3t1",
]


def _pad_w(d: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return F.pad(d, (0, 0, left, right))


def _pad_h(d: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    return F.pad(d, (0, 0, 0, 0, top, bottom))


def diff1_dx(x: torch.Tensor) -> torch.Tensor:
    """First difference along W, zero-padded right (loss.py:36-39)."""
    return _pad_w(x[:, :, 1:] - x[:, :, :-1], 0, 1)


def diff1_dy(x: torch.Tensor) -> torch.Tensor:
    """First difference along H, zero-padded bottom (loss.py:41-44).  Inside
    a banded section (``parallel.context.banded``) ``x`` is this rank's band
    of rows: its last row's difference reads the first row of the band
    below (``parallel.halo.halo_pad``), and only the image's last row is 0."""
    from ..parallel import context

    if not context.in_band():
        return _pad_h(x[:, 1:] - x[:, :-1], 0, 1)
    from ..parallel.halo import halo_pad

    m, size, _ = context.spatial_coords()
    xp = halo_pad(x, 1, 0, 1)
    d = xp[:, 1:] - xp[:, :-1]
    return _pad_h(d[:, :-1], 0, 1) if m == size - 1 else d


def diff2_dx(x: torch.Tensor) -> torch.Tensor:
    """Second difference along W, zero-padded both sides (loss.py:46-49)."""
    return _pad_w(x[:, :, 2:] + x[:, :, :-2] - 2.0 * x[:, :, 1:-1], 1, 1)


def diff2_dy(x: torch.Tensor) -> torch.Tensor:
    """Second difference along H, zero-padded both sides (loss.py:51-54)."""
    return _pad_h(x[:, 2:] + x[:, :-2] - 2.0 * x[:, 1:-1], 1, 1)


def diff_z_dx(x: torch.Tensor) -> torch.Tensor:
    """Ratio curvature along W, x/x_right + x/x_left - 2 (loss.py:56-59)."""
    c = x[:, :, 1:-1]
    return _pad_w(c / x[:, :, 2:] + c / x[:, :, :-2] - 2.0, 1, 1)


def diff_z_dy(x: torch.Tensor) -> torch.Tensor:
    """Ratio curvature along H (loss.py:61-64)."""
    c = x[:, 1:-1]
    return _pad_h(c / x[:, 2:] + c / x[:, :-2] - 2.0, 1, 1)


def c_imdiff1(img: torch.Tensor, img_warp: torch.Tensor) -> torch.Tensor:
    """L1 of the gradient differences of an image and its warp (loss.py:66-69)."""
    return ((diff1_dx(img) - diff1_dx(img_warp)).abs()
            + (diff1_dy(img) - diff1_dy(img_warp)).abs())


def c_ds1(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """First-order edge-aware smoothness, Monodepth's (loss.py:71-83)."""
    wx = torch.exp(-diff1_dx(img).abs().sum(-1, keepdim=True))
    wy = torch.exp(-diff1_dy(img).abs().sum(-1, keepdim=True))
    return diff1_dx(disp).abs() * wx + diff1_dy(disp).abs() * wy


def c_ds2(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Second-order edge-aware smoothness (loss.py:85-97)."""
    wx = torch.exp(-diff2_dx(img).abs().sum(-1, keepdim=True))
    wy = torch.exp(-diff2_dy(img).abs().sum(-1, keepdim=True))
    return diff2_dx(disp).abs() * wx + diff2_dy(disp).abs() * wy


def _mean_normalized_edge_weights(img: torch.Tensor):
    """exp(-max_c |dI| / (0.5 mean |dI|)), the weights of the C_ds3 family
    (loss.py:104-109).  A constant image divides by a zero mean, as in JAX."""
    idx, idy = diff1_dx(img).abs(), diff1_dy(img).abs()
    m_idx = idx.mean(dim=(1, 2, 3), keepdim=True)
    m_idy = idy.mean(dim=(1, 2, 3), keepdim=True)
    wx = torch.exp(-idx.amax(-1, keepdim=True) / (0.5 * m_idx))
    wy = torch.exp(-idy.amax(-1, keepdim=True) / (0.5 * m_idy))
    return wx, wy


def c_ds3(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Ratio smoothness of |d| + 1 under the mean-normalized max-channel
    edge weights (loss.py:99-114)."""
    d = disp.abs() + 1.0
    ddx = diff_z_dx(d).abs().clamp(0.0, 10.0)
    ddy = diff_z_dy(d).abs().clamp(0.0, 10.0)
    wx, wy = _mean_normalized_edge_weights(img)
    return ddx * wx + ddy * wy


def c_ds3t(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """C_ds3t (loss.py:132-147): the reference's copy of C_ds3."""
    return c_ds3(img, disp)


def c_ds3t1(img: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """C_ds3t1 (loss.py:116-130): first-order |dd| under the
    mean-normalized edge weights."""
    wx, wy = _mean_normalized_edge_weights(img)
    return diff1_dx(disp).abs() * wx + diff1_dy(disp).abs() * wy
