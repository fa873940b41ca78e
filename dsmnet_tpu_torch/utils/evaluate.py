"""Offline evaluation metrics (``dsmnet_tpu/utils/evaluate.py``; reference
utils/evaluate.py).

numpy implementations usable without a device: D1/EPE, warp pixel
error (photometric reconstruction error under the predicted disparity),
and the depth-style error battery (abs_rel, sq_rel, rmse, rmse_log, D1,
delta<1.25 accuracies — evaluate.py:46-73).
"""

from __future__ import annotations

import numpy as np

__all__ = ["evaluate_pair", "compute_errors", "warp_pixel_error"]


def _warp_np(im_src: np.ndarray, disp: np.ndarray) -> np.ndarray:
    """Bilinear left-view synthesis: out[y, x] = im_src[y, x - d] with
    zeros outside (numpy mirror of ``ops.warp.imwarp``)."""
    h, w = disp.shape[:2]
    xs = np.arange(w, dtype=np.float64)[None, :] - disp
    x0 = np.floor(xs).astype(np.int64)
    frac = (xs - x0)[..., None] if im_src.ndim == 3 else (xs - x0)
    valid0 = (x0 >= 0) & (x0 <= w - 1)
    valid1 = (x0 + 1 >= 0) & (x0 + 1 <= w - 1)
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    rows = np.arange(h)[:, None]
    v0 = im_src[rows, x0c] * (valid0[..., None] if im_src.ndim == 3 else valid0)
    v1 = im_src[rows, x1c] * (valid1[..., None] if im_src.ndim == 3 else valid1)
    return v0 * (1 - frac) + v1 * frac


def warp_pixel_error(imL: np.ndarray, imR: np.ndarray, dispL: np.ndarray) -> float:
    """Mean |imL - warp(imR, dispL)| over pixels the warp reaches, scaled
    to [0,255] (evaluate.py:36-44)."""
    imL = np.asarray(imL, np.float64)
    imR = np.asarray(imR, np.float64)
    warped = _warp_np(imR, np.asarray(dispL, np.float64))
    mask = warped.sum(axis=-1) > 0 if warped.ndim == 3 else warped > 0
    diff = np.abs(imL - warped)
    vals = diff[mask] if mask.any() else diff
    return float(vals.mean() * 255.0)


def evaluate_pair(dispL: np.ndarray, dispL_gt: np.ndarray | None = None,
                  imL: np.ndarray | None = None, imR: np.ndarray | None = None):
    """(d1, epe, pixel_error) for one pair (evaluate.py:9-34); entries are
    -1 when their inputs are missing."""
    d1 = epe = -1.0
    if dispL_gt is not None:
        mask = dispL_gt > 0
        if mask.any():
            diff = np.abs(dispL_gt - dispL)[mask]
            epe = float(diff.mean())
            good = np.logical_or(diff <= 3, diff / dispL_gt[mask] <= 0.05)
            d1 = float(100.0 - 100.0 * good.sum() / mask.sum())
    pix = -1.0
    if imL is not None and imR is not None:
        pix = warp_pixel_error(imL, imR, dispL)
    return d1, epe, pix


def compute_errors(gt: np.ndarray, pred: np.ndarray):
    """Depth-style error battery over gt > 0 (evaluate.py:46-73).

    Returns (abs_rel, sq_rel, rmse, rmse_log, d1, a1, a2, a3)."""
    mask = gt > 0
    gt = gt[mask].astype(np.float64)
    pred = pred[mask].astype(np.float64)
    eps = 1e-6
    diff = np.abs(gt - pred)

    thresh = np.maximum(gt / (pred + eps), pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25**2).mean())
    a3 = float((thresh < 1.25**3).mean())

    bad = np.logical_and(diff >= 3, diff / gt >= 0.05)
    d1 = float(100.0 * bad.sum() / mask.sum())

    rmse = float(np.sqrt((diff**2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred + eps)) ** 2).mean()))
    abs_rel = float((diff / gt).mean())
    sq_rel = float((diff**2 / gt).mean())
    return abs_rel, sq_rel, rmse, rmse_log, d1, a1, a2, a3
