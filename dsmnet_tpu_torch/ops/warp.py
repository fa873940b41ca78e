"""Disparity-based view synthesis (image warping) as a gather, channels-last.

PyTorch counterpart of ``dsmnet_tpu/ops/warp.py``: the reference's
``imwrap_BCHW`` sample grid in closed form,

    px(i, j) = X0 + j*scale - disp[i, j]              (fliplr=False)
    px(i, j) = (W0-1-X0) - j*scale + disp[i, j]       (fliplr=True)
    py(i, j) = Y0 + i*scale

with (X0, Y0) = ``left_top``, sampled bilinearly with zero padding outside
the source (``grid_sample(..., padding_mode='zeros')``, align_corners).
``eps`` is added to the source first, so that sampled pixels are nonzero
and ``warped != 0`` marks the pixels seen in the other view.

When the origin's y and the scale are integers and the sampled rows lie
inside the source, every sample sits exactly on a source row: the rows are
a strided slice and the bilinear gather needs only its two horizontal taps
(JAX :62-77).  That path gives the generic 4-tap path's bits, since there
the vertical weight is 0 and the bottom taps add exact zeros.  No Pallas
kernel stands behind this module in JAX.

A warp samples along W only, so each output row reads one source row: a
band of rows (``parallel.context.banded``) needs no exchange.  The
self-supervised step warps a band of the crop by passing the band's
first row in the origin's y (``(nedge, nedge + lo)``) against the whole,
uncropped source, which takes the fast path; ``warp_disparity`` reads
the same band of the other view's band at origin (0, 0).
"""

from __future__ import annotations

import torch

__all__ = ["imwarp", "warp_disparity"]


def imwarp(im_src: torch.Tensor, disp: torch.Tensor, fliplr: bool = False,
           left_top: tuple[float, float] = (0.0, 0.0), scale_factor: float = 1.0,
           eps: float | torch.Tensor = 5.5e-5) -> torch.Tensor:
    """Warp ``im_src`` (N,H0,W0,C) by the left-view disparity ``disp``
    (N,H,W,1): the synthesized left view (N,H,W,C) in im_src's dtype.
    ``left_top`` is (x, y) in source pixels; ``scale_factor`` source pixels
    per output pixel; ``eps`` a float or a 0-d tensor (the self-supervised
    step draws it on the device)."""
    _, h0, w0, _ = im_src.shape
    _, h, w, cd = disp.shape
    if cd != 1:
        raise ValueError(f"disparity must have one channel, got {cd}")
    x0, y0 = left_top
    jj = torch.arange(w, dtype=torch.float32, device=disp.device).view(1, 1, w)
    d = disp[..., 0]
    px = (w0 - 1.0 - x0) - jj * scale_factor + d if fliplr else x0 + jj * scale_factor - d
    src = im_src + torch.as_tensor(eps, dtype=im_src.dtype, device=im_src.device)

    s_i = int(scale_factor) if float(scale_factor).is_integer() else None
    y0_i = int(y0) if float(y0).is_integer() else None
    if s_i is not None and y0_i is not None and 0 <= y0_i and y0_i + s_i * (h - 1) < h0:
        return _bilinear_gather_zero_pad_h(src[:, y0_i:y0_i + s_i * h:s_i], px)
    ii = torch.arange(h, dtype=torch.float32, device=disp.device).view(1, h, 1)
    return _bilinear_gather_zero_pad(src, px, (y0 + ii * scale_factor).expand_as(px))


def _bilinear_gather_zero_pad_h(rows: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """2-tap horizontal bilinear sample of rows (N,H,W0,C), already the
    source rows, at float columns px (N,H,W); taps outside contribute zero."""
    n, h, w0, c = rows.shape
    x0f = torch.floor(px)
    wx = (px - x0f).to(rows.dtype)[..., None]
    x0 = x0f.long()

    def tap(xi):
        valid = ((xi >= 0) & (xi <= w0 - 1))[..., None].to(rows.dtype)
        idx = xi.clamp(0, w0 - 1)[..., None].expand(n, h, xi.shape[-1], c)
        return torch.gather(rows, 2, idx) * valid

    return tap(x0) * (1.0 - wx) + tap(x0 + 1) * wx


def _bilinear_gather_zero_pad(src: torch.Tensor, px: torch.Tensor,
                              py: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of src (N,H0,W0,C) at float pixel coordinates
    (N,H,W); each corner tap outside the image contributes zero."""
    n, h0, w0, c = src.shape
    x0f, y0f = torch.floor(px), torch.floor(py)
    wx = (px - x0f).to(src.dtype)[..., None]
    wy = (py - y0f).to(src.dtype)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    flat = src.reshape(n, h0 * w0, c)

    def tap(yi, xi):
        valid = ((xi >= 0) & (xi <= w0 - 1) & (yi >= 0) & (yi <= h0 - 1))[..., None]
        idx = (yi.clamp(0, h0 - 1) * w0 + xi.clamp(0, w0 - 1)).reshape(n, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(n, idx.shape[1], c)).reshape(*xi.shape, c)
        return vals * valid.to(src.dtype)

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def warp_disparity(disp_other: torch.Tensor, disp: torch.Tensor,
                   eps: float | torch.Tensor = 5.5e-5) -> torch.Tensor:
    """Warp the flipped view's disparity map into this view (LR consistency):
    ``imwarp`` with fliplr, origin (0, 0) and scale 1."""
    return imwarp(disp_other, disp, fliplr=True, eps=eps)
