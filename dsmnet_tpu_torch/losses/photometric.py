"""Self-supervised photometric loss family (``dsmnet_tpu/losses/photometric.py``;
reference losses/loss.py:149-512).

The four per-level losses and the two-view pyramid, on NHWC tensors:

  * ``common``    — 0.425 (1 - SSIM) + 0.15 L1 + w C_ds3 + w LR-consistency
  * ``depthmono`` — Monodepth's variant, C_ds1 smoothness
  * ``cap``       — the 'ds' / 'lr' substrings of the loss name toggle the
                    smoothness and LR terms
  * ``sssmnet``   — adds the loop-closure |im - im_wrap1|, second-order
                    smoothness and the max-disparity term

Shared: the similarity-gated weight w = max(0, SSIM - 0.75) / 2 + 0.001
(loss.py:33-34), computed detached; occlusion weights from the agreement
of the two views' disparities (loss.py:393-404); the image pyramid by ::2
striding (loss.py:17-22).  The < 1024 valid-pixel fallback of ``common``
and ``depthmono`` is a ``torch.where`` on device tensors, so the loss
never waits for the device.

Under a data-parallel sharding context (``parallel/context.py``) the
similarity gate and the fallback read the global batch's means and
valid count, and each plain mean is this rank's share (its sum over the
global count), so that the ranks' losses sum to the global batch's.
Inside a banded section (a model that bands H, ``parallel.context.banded``)
the targets and the disparities are this rank's bands of rows and the
warps' origins carry the band's first row; SSIM's blur and the
smoothness terms' differences along H read their neighbours' rows, the
``C_ds3`` edge weights' per-image means sum over the ``model`` group, and
the similarity gate, the fallback and the means reduce over the whole
mesh (the global batch).  The banded models return full-resolution maps
(scale 0), so a band has no pyramid.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.gradients import c_ds1, c_ds2, c_ds3, c_imdiff1
from ..ops.resize import upsample_bilinear
from ..ops.ssim import ssim_map
from ..ops.warp import imwarp, warp_disparity
from ..parallel.context import data_mean, data_sum, in_band, mean_share

__all__ = ["photometric_pyramid_loss", "weight_common", "PhotoLossConfig"]

_BASE_W_AP = 1.0
_W_MDH = 1e-4


@dataclasses.dataclass(frozen=True)
class PhotoLossConfig:
    """Static configuration parsed from the reference's loss-name DSL."""

    kind: str  # 'common' | 'depthmono' | 'cap' | 'sssmnet'
    flag_mask: bool = False
    with_ds: bool = True  # cap only: 'ds' substring toggle (loss.py:270)
    with_lr: bool = True  # cap only: 'lr' substring toggle (loss.py:275)


def _wfun(sim: torch.Tensor) -> torch.Tensor:
    """Similarity-gated ds / lr weight (loss.py:33-34)."""
    return (sim - 0.75).clamp(min=0.0) / 2.0 + 0.001


def _similarity(ssim: torch.Tensor, mask_ap: torch.Tensor, fallback_all: bool) -> torch.Tensor:
    """Detached mean SSIM over the valid-warp mask; ``fallback_all`` takes
    the mean over every pixel when fewer than 1024 are valid
    (loss.py:157-158).  Both means and the count are the global batch's."""
    ssim = ssim.detach()
    m = mask_ap.to(ssim.dtype)
    sim = data_sum((ssim * m).sum()) / data_sum(m.sum()).clamp(min=1.0)
    if fallback_all:
        sim = torch.where(data_sum(mask_ap.sum()) < 1024, data_mean(ssim), sim)
    return sim


def weight_common(disp: torch.Tensor, disp_wrap: torch.Tensor, factor=1.0) -> torch.Tensor:
    """Occlusion weight from the two views' disparity agreement
    (loss.py:393-404): 1 below 1 px, a linear ramp to 0.01 at 3 px, 0.01
    beyond."""
    delt = (disp - disp_wrap).detach().abs() / factor
    ramp = 1.0 - (delt - 1.0) * (0.99 / 2.0)
    one, floor = delt.new_ones(()), delt.new_full((), 0.01)
    return torch.where(delt < 1.0, one, torch.where(delt < 3.0, ramp, floor))


def _apply_occlusion(C_ap, C_lr, invalid, mask_ap, w_common):
    """Occlusion masking of every kind (loss.py:170-178): the image term
    weighted 1 where (invalid & mask_ap), else w_common; the LR term 0
    where invalid, else w_common."""
    if w_common is None:
        return C_ap, C_lr
    weight_im = torch.where(invalid & mask_ap, w_common.new_ones(()), w_common)
    weight_lr = torch.where(invalid, w_common.new_zeros(()), w_common)
    return C_ap * weight_im, C_lr * weight_lr


def _level_loss(cfg: PhotoLossConfig, im, im_wrap, disp, aux, factor, w_common):
    """One pyramid level.  ``aux`` is disp_wrap for common / depthmono /
    cap, and im_wrap1 (the loop-closure warp) for sssmnet."""
    ssim = ssim_map(im, im_wrap)
    mask_ap = im_wrap[..., :1] != 0
    w = _wfun(_similarity(ssim, mask_ap, cfg.kind in ("common", "depthmono")))

    # C_ap is (N,H,W,3): the one-channel SSIM term broadcast against the L1
    if cfg.kind == "sssmnet":
        C_ap = (0.85 * 0.5) * (1.0 - ssim) + 0.15 * (
            (im - im_wrap).abs() + c_imdiff1(im, im_wrap))
        C_lr = (im - aux).abs()
        invalid = aux[..., :1] == 0
    else:
        C_ap = (0.85 * 0.5) * (1.0 - ssim) + 0.15 * (im - im_wrap).abs()
        C_lr = (disp - aux).abs()
        invalid = aux == 0

    C_ap, C_lr = _apply_occlusion(C_ap, C_lr, invalid, mask_ap, w_common)
    C_ap_m, C_lr_m = mean_share(C_ap), mean_share(C_lr)

    if cfg.kind == "common":
        return C_ap_m * _BASE_W_AP + mean_share(c_ds3(im, disp)) * w + C_lr_m * w
    if cfg.kind == "depthmono":
        return C_ap_m * _BASE_W_AP + mean_share(c_ds1(im, disp)) * w + C_lr_m * w
    if cfg.kind == "cap":
        C = C_ap_m * _BASE_W_AP
        if cfg.with_ds:
            C = C + mean_share(c_ds1(im, disp)) * (w / factor)
        if cfg.with_lr:
            C = C + C_lr_m * w
        return C
    if cfg.kind == "sssmnet":
        return (C_ap_m * _BASE_W_AP + mean_share(c_ds2(im, disp)) * (w / factor) + C_lr_m * w
                + mean_share(disp.abs()) * _W_MDH)
    raise ValueError(cfg.kind)


def _strided_pyramid(im: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Image pyramid by ::2 striding (loss.py:17-22)."""
    pyr = [im]
    for _ in range(1, levels):
        pyr.append(pyr[-1][:, ::2, ::2])
    return pyr


def photometric_pyramid_loss(
    cfg: PhotoLossConfig,
    imR_src: torch.Tensor,
    imL: torch.Tensor,
    dispLs: list[torch.Tensor],
    scales: list[int],
    left_top: tuple[int, int],
    imR1_src: torch.Tensor,
    imL1: torch.Tensor,
    dispL1s: list[torch.Tensor],
    scales1: list[int],
    left_top1: tuple[int, int],
    weights,
    eps=5.5e-5,
) -> torch.Tensor:
    """Two-view photometric pyramid loss (loss.py:424-512).

    ``imR_src`` / ``imR1_src`` are the *uncropped* right sources, so that
    a warp samples real content outside the crop window (``left_top``);
    ``imL`` / ``imL1`` the cropped left targets; ``weights`` the per-scale
    curriculum; ``eps`` (a float or a 0-d tensor) the warps' offset.
    Levels above ``min(2, max(scales))`` are upsampled to that level.
    ``scales1`` is the flipped view's, which JAX's signature also takes and
    ignores: both forwards are of one model.  Inside a banded section the
    views and maps are bands, ``left_top`` / ``left_top1`` carry the band's
    first row of the crop in y, and every level must be 0.
    """
    del scales1
    if in_band() and max(scales) > 0:
        raise NotImplementedError("a banded model's maps are at full resolution (scale 0): "
                                  "no banded pyramid or upsample is ported")
    maxlevel = min(2, max(scales))
    i0 = scales.index(maxlevel)
    h, w = dispLs[i0].shape[1], dispLs[i0].shape[2]
    imLs = _strided_pyramid(imL, maxlevel + 1)
    imL1s = _strided_pyramid(imL1, maxlevel + 1)
    weights = torch.as_tensor(weights, dtype=imL.dtype, device=imL.device)

    loss = imL.new_zeros(())
    for i, level in enumerate(scales):
        if level > maxlevel:
            up = 2 ** (level - maxlevel)
            dispL = upsample_bilinear(dispLs[i], up)[:, :h, :w]
            dispL1 = upsample_bilinear(dispL1s[i], up)[:, :h, :w]
            scale_factor = 2 ** maxlevel
        else:
            dispL, dispL1 = dispLs[i], dispL1s[i]
            scale_factor = 2 ** level

        imL_wrap = imwarp(imR_src, dispL, False, left_top, scale_factor, eps)
        imL1_wrap = imwarp(imR1_src, dispL1, False, left_top1, scale_factor, eps)

        w_common = w_common1 = None
        if cfg.kind == "sssmnet":
            aux = warp_disparity(imL1_wrap, dispL, eps)  # im_wrap1: the loop closure
            aux1 = warp_disparity(imL_wrap, dispL1, eps)
            if cfg.flag_mask:
                w_common = weight_common(dispL, warp_disparity(dispL1, dispL, eps),
                                         scale_factor)
                w_common1 = weight_common(dispL1, warp_disparity(dispL, dispL1, eps),
                                          scale_factor)
        else:
            aux = warp_disparity(dispL1, dispL, eps)  # dispL_wrap
            aux1 = warp_disparity(dispL, dispL1, eps)
            if cfg.flag_mask:
                w_common = weight_common(dispL, aux, scale_factor)
                w_common1 = weight_common(dispL1, aux1, scale_factor)

        im_t, im1_t = imLs[min(level, maxlevel)], imL1s[min(level, maxlevel)]
        tmp = _level_loss(cfg, im_t, imL_wrap, dispL, aux, 2 ** level, w_common)
        tmp1 = _level_loss(cfg, im1_t, imL1_wrap, dispL1, aux1, 2 ** level, w_common1)
        loss = loss + (tmp + tmp1) * weights[level]
    return loss
