"""Finite differences and edge-aware smoothness terms of NHWC maps
(``dsmnet_tpu/ops/gradients.py``; reference losses/loss.py:36-147).

The reference's padding conventions: a first difference is zero-padded
by one at the right / bottom, a second or ratio difference by one on both
sides of the differentiated axis, so every output keeps its input's
shape.  Images are (N,H,W,C), disparities (N,H,W,1).

Inside a banded section (``parallel.context.banded``) the maps are this
rank's band of rows.  A difference along H reads the rows of the bands
beside it (``parallel.halo.halo_pad``: one row below for a first
difference, one a side for a second or ratio difference); at the image's
top and bottom the band's own rows are cut before the difference and its
zero rows padded after, as the whole map's padding makes them, so that
no difference (and no ratio's division) reads the zero rows of the
halo.  The ``C_ds3`` family's per-image mean |dI| sums each band over
the ``model`` group and divides by the whole image's count
(``parallel.context.image_means``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import context

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
    if not context.in_band():
        return _pad_h(x[:, 1:] - x[:, :-1], 0, 1)
    xp, top, bottom = _halo_rows(x, 0, 1)
    return _pad_h(xp[:, 1:] - xp[:, :-1], top, bottom)


def _halo_rows(x: torch.Tensor, above: int, below: int):
    """Inside a banded section: (this band of ``x`` with ``above`` rows of
    the band before it and ``below`` of the band after it, where those
    bands exist; the zero rows to pad a difference of it with at the top
    and at the bottom, where they do not).  Every rank exchanges the same
    rows; the image's first and last ranks then cut the zero rows of the
    halo, so that the difference never reads them."""
    from ..parallel.halo import halo_pad

    m, size, _ = context.spatial_coords()
    xp = halo_pad(x, 1, above, below)
    top = above if m == 0 else 0
    bottom = below if m == size - 1 else 0
    return xp[:, top:xp.shape[1] - bottom], top, bottom


def diff2_dx(x: torch.Tensor) -> torch.Tensor:
    """Second difference along W, zero-padded both sides (loss.py:46-49)."""
    return _pad_w(x[:, :, 2:] + x[:, :, :-2] - 2.0 * x[:, :, 1:-1], 1, 1)


def diff2_dy(x: torch.Tensor) -> torch.Tensor:
    """Second difference along H, zero-padded both sides (loss.py:51-54);
    of a band, with a row of each neighbouring band."""
    xp, top, bottom = _halo_rows(x, 1, 1) if context.in_band() else (x, 1, 1)
    return _pad_h(xp[:, 2:] + xp[:, :-2] - 2.0 * xp[:, 1:-1], top, bottom)


def diff_z_dx(x: torch.Tensor) -> torch.Tensor:
    """Ratio curvature along W, x/x_right + x/x_left - 2 (loss.py:56-59)."""
    c = x[:, :, 1:-1]
    return _pad_w(c / x[:, :, 2:] + c / x[:, :, :-2] - 2.0, 1, 1)


def diff_z_dy(x: torch.Tensor) -> torch.Tensor:
    """Ratio curvature along H (loss.py:61-64); of a band, with a row of
    each neighbouring band (never divided by a halo's zero row)."""
    xp, top, bottom = _halo_rows(x, 1, 1) if context.in_band() else (x, 1, 1)
    c = xp[:, 1:-1]
    return _pad_h(c / xp[:, 2:] + c / xp[:, :-2] - 2.0, top, bottom)


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
    (loss.py:104-109).  A constant image divides by a zero mean, as in JAX.
    The means are of each whole image, its bands' sums added over the
    ``model`` group inside a banded section."""
    idx, idy = diff1_dx(img).abs(), diff1_dy(img).abs()
    m_idx, m_idy = context.image_means(idx, idy)
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
