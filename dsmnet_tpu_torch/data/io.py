"""Image, disparity and PFM I/O (``dsmnet_tpu/data/io.py``; reference
myDatasets_stereo/img_rw.py, img_rw_pfm.py).

``imread`` and ``load_pfm`` are the serving path's, in ``images.py``.
KITTI disparity PNGs are uint16 scaled by 256, but the reference loads
them through cv2's default 8-bit path, which truncates them to whole
pixels (img_rw.py:23-29); ``load_disp(precise=True)`` reads the 16-bit
value / 256 instead.  cv2 is imported only where a PNG or other image
file is read or written.
"""

from __future__ import annotations

import sys

import numpy as np

from ..images import imread, load_pfm

__all__ = ["imread", "imwrite", "load_disp", "load_pfm", "save_pfm"]


def save_pfm(fname: str, image: np.ndarray, scale: float = 1.0) -> None:
    """PFM writer (img_rw_pfm.py:46-71): float32 HxW, HxWx1 or HxWx3, rows
    bottom-up, the scale's sign giving the byte order."""
    if image.dtype.name != "float32":
        raise ValueError("PFM image dtype must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must be HxWx3, HxWx1 or HxW")
    endian = image.dtype.byteorder
    if endian == "<" or (endian == "=" and sys.byteorder == "little"):
        scale = -scale
    with open(fname, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def imwrite(fname: str, image: np.ndarray) -> None:
    """Write an RGB image (cv2, BGR on disk) or, for a '.pfm' name, a PFM."""
    if ".pfm" in fname:
        save_pfm(fname, image)
        return
    import cv2

    cv2.imwrite(fname, np.ascontiguousarray(np.flip(image, axis=2)))


def load_disp(fname: str, precise: bool = False) -> np.ndarray:
    """First-channel float32 disparity with inf/nan zeroed (img_rw.py:12-21).

    ``precise=True`` reads a 16-bit KITTI PNG at full resolution / 256
    instead of the reference's 8-bit truncation."""
    if ".pfm" in fname:
        disp = load_pfm(fname)[0]
        if disp.ndim > 2:
            disp = disp[:, :, 0]
    elif precise and fname.endswith(".png"):
        import cv2

        raw = cv2.imread(fname, cv2.IMREAD_UNCHANGED)
        if raw is None:
            raise IOError(f"cannot read disparity: {fname}")
        if raw.ndim > 2:
            raw = raw[:, :, 0]
        disp = raw.astype(np.float32)
        if raw.dtype == np.uint16:
            disp /= 256.0
    else:
        img = imread(fname)
        disp = img[:, :, 0] if img.ndim > 2 else img
    disp = np.asarray(disp, np.float32).copy()
    disp[~np.isfinite(disp)] = 0.0
    return disp
