"""Image I/O and normalization for the port's serving path.

The port's own copies of ``imread`` / ``load_pfm`` (``dsmnet_tpu/data/io.py``)
and ``normalize_imagenet`` (``dsmnet_tpu/train/color_aug.py:91``), plus a
dependency-free PNG writer for disparity maps.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "imread", "load_pfm", "normalize_imagenet",
           "write_png"]


def load_pfm(fname: str):
    """PFM reader with endianness + vertical flip handling -> (array, scale)."""
    with open(fname, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{fname}: not a PFM file")
        m = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("latin-1"))
        if not m:
            raise ValueError(f"{fname}: malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def imread(fname: str) -> np.ndarray:
    """RGB (H,W,3) image, or a PFM float array."""
    if ".pfm" in fname:
        return load_pfm(fname)[0]
    import cv2

    img = cv2.imread(fname)
    if img is None:
        raise IOError(f"cannot read image: {fname}")
    return np.ascontiguousarray(np.flip(img, axis=2))  # BGR -> RGB


def normalize_imagenet(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Per-3-channel-group ImageNet normalization of a channels-last tensor."""
    mean = torch.as_tensor(IMAGENET_MEAN * groups, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(IMAGENET_STD * groups, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def write_png(fname: str, image: np.ndarray) -> None:
    """Write a 2-D float array as an 8-bit grayscale PNG, min..max -> 0..255."""
    a = np.asarray(image, np.float64)
    lo, hi = float(a.min()), float(a.max())
    g = np.zeros(a.shape, np.uint8) if hi <= lo else \
        np.round((a - lo) * (255.0 / (hi - lo))).astype(np.uint8)
    h, w = g.shape
    raw = b"".join(b"\x00" + g[i].tobytes() for i in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(fname, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
