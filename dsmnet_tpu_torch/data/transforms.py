"""Per-sample numpy augmentations (``dsmnet_tpu/data/transforms.py``;
reference myTransforms/aug_spatial.py, aug_color.py).

The spatial augmentations run per sample before batching (random stereo
shift, crop, crop and scale with disparity fixups); the supervised
pipeline also normalizes here (Stereo_train, myTransforms/__init__.py:88-101).

Every transform acts on one (H, W, C) float32 sample with channels
[imL(3), imR(3), dispL?, dispR?], images in [0, 255] before ``to_unit``.
The crop-and-scale resize (cv2 ``INTER_LINEAR`` in JAX) is torch's
``bilinear`` without corner alignment or antialiasing, the same
half-pixel sampling, so no cv2 is needed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "SpatialStereo",
    "to_unit",
    "lighting_np",
    "normalize_np",
    "resize_image",
    "supervised_train_transform",
    "eval_transform",
    "selfsup_train_transform",
    "selfsup_eval_transform",
]

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_PCA_EIGVAL = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
_PCA_EIGVEC = np.asarray(
    [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ],
    np.float32,
)


def resize_image(img: np.ndarray, hw: tuple[int, int], mode: str = "bilinear") -> np.ndarray:
    """(H, W, C) float32 -> (h, w, C) by half-pixel ``mode`` ("bilinear" or
    "bicubic") sampling with edge replication: cv2.resize's INTER_LINEAR or
    INTER_CUBIC on a float image."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=tuple(hw), mode=mode, align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).contiguous().numpy()


class SpatialStereo:
    """Random stereo shift + crop (+ optional crop and scale)
    (aug_spatial.py:7-88).

    The stereo shift moves the *right* image columns left by a random
    amount and adds that amount to nonzero disparities, which simulates a
    wider baseline (aug_spatial.py:17-41).
    """

    def __init__(self, size_crop=(768, 384), scale_delt=0.0, shift_max=32,
                 rng: np.random.RandomState | None = None):
        self.size_crop = size_crop  # (w, h) like the reference
        self.scale_delt = scale_delt
        self.shift_max = shift_max
        self.rng = rng or np.random.RandomState()

    def _shift(self, img, shift):
        if shift == 0:
            return img
        c = img.shape[2]
        img = img.copy()
        if shift > 0:
            img[:, :-shift, 3:6] = img[:, shift:, 3:6]
            if c >= 8:
                img[:, :-shift, 7:8] = img[:, shift:, 7:8]
        else:
            img[:, -shift:, 3:6] = img[:, :shift, 3:6]
            if c >= 8:
                img[:, -shift:, 7:8] = img[:, :shift, 7:8]
        for idx in range(6, c):
            mask = img[:, :, idx] != 0
            img[:, :, idx][mask] += shift
        return img[:, :-shift] if shift > 0 else img[:, -shift:]

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.ndim != 3 or img.shape[2] < 6:
            raise ValueError(f"expected an (H, W, >=6) sample, got {img.shape}")
        h0, w0 = img.shape[:2]
        w1, h1 = self.size_crop

        if self.shift_max > 0:
            shift = int(self.rng.randint(0, min(self.shift_max, w0)))
            img = self._shift(img, shift)
            w0 -= abs(shift)

        if self.scale_delt == 0:
            w1, h1 = min(w0, w1), min(h0, h1)
            ws = int(self.rng.randint(0, w0 - w1)) if w0 > w1 else 0
            hs = int(self.rng.randint(0, h0 - h1)) if h0 > h1 else 0
            return img[hs : hs + h1, ws : ws + w1]

        scale = 1.0 + self.rng.uniform(0, self.scale_delt)
        if self.rng.rand() > 0.5:
            scale = 1.0 / scale
        w = int(w1 / scale + 0.5)
        h = int(h1 / scale + 0.5)
        adjust = max(float(h) / min(h, h0), float(w) / min(w, w0))
        scale *= adjust
        w = int(w / adjust + 0.5)
        h = int(h / adjust + 0.5)
        ws = int(self.rng.randint(0, w0 - w)) if w0 > w else 0
        hs = int(self.rng.randint(0, h0 - h)) if h0 > h else 0
        img = img[hs : hs + h, ws : ws + w]
        if scale != 1.0:
            img = resize_image(img, (h1, w1))
            if img.shape[2] > 6:
                img[:, :, 6:] *= scale
        return img


def to_unit(img: np.ndarray, channels: int = 6) -> np.ndarray:
    """Scale the first ``channels`` image channels to [0, 1]; disparity
    channels stay in pixels (aug_color.py:15-26 ToTensor_numpy)."""
    img = img.astype(np.float32).copy()
    img[:, :, :channels] /= 255.0
    return img


def lighting_np(img, alphastd=0.1, groups=2, rng=None):
    """AlexNet PCA lighting noise shared across the pair
    (aug_color.py:66-99, same_group=True)."""
    rng = rng or np.random.RandomState()
    alpha = rng.normal(0, alphastd, size=3).astype(np.float32)
    rgb = (_PCA_EIGVEC * alpha[None, :] * _PCA_EIGVAL[None, :]).sum(1)
    out = img.copy()
    for g in range(min(groups, img.shape[2] // 3)):
        sl = slice(3 * g, 3 * g + 3)
        out[:, :, sl] = np.clip(img[:, :, sl] + rgb[None, None, :], 0, 1)
    return out


def normalize_np(img, groups=2):
    """Per-group ImageNet normalization (aug_color.py:28-45)."""
    out = img.copy()
    for g in range(min(groups, img.shape[2] // 3)):
        sl = slice(3 * g, 3 * g + 3)
        out[:, :, sl] = (img[:, :, sl] - IMAGENET_MEAN) / IMAGENET_STD
    return out


def supervised_train_transform(size_crop=(768, 384), scale_delt=0.0, shift_max=32,
                               rng=None):
    """Stereo_train (myTransforms/__init__.py:88-95): spatial, to-unit,
    lighting, normalize."""
    rng = rng or np.random.RandomState()
    spatial = SpatialStereo(size_crop, scale_delt, shift_max, rng)

    def transform(img):
        img = spatial(img)
        img = to_unit(img)
        img = lighting_np(img, 0.1, 2, rng)
        return normalize_np(img, 2)

    return transform


def eval_transform():
    """Stereo_eval (__init__.py:97-101): to-unit + normalize."""

    def transform(img):
        return normalize_np(to_unit(img), 2)

    return transform


def selfsup_train_transform(size_crop=(768, 384), scale_delt=0.0, shift_max=32,
                            rng=None):
    """Stereo_Spatial (__init__.py:103-107): spatial + to-unit only; the
    colour augmentation runs on the device after batching."""
    spatial = SpatialStereo(size_crop, scale_delt, shift_max, rng or np.random.RandomState())

    def transform(img):
        return to_unit(spatial(img))

    return transform


def selfsup_eval_transform():
    """Stereo_ToTensor (__init__.py:115-118): to-unit only."""
    return to_unit
