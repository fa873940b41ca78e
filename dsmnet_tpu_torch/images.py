"""Image I/O and normalization for the port's serving path.

The port's own copies of ``imread`` / ``load_pfm`` (``dsmnet_tpu/data/io.py``)
and ``normalize_imagenet`` (``dsmnet_tpu/train/color_aug.py:91``), plus a
dependency-free PNG writer for disparity maps that writes the pixels the
JAX deploy's ``plt.imsave`` writes (``dsmnet_tpu/cli.py:160-171``):
matplotlib's default colormap, viridis, carried here as data, since the
card's machine may lack matplotlib.  ``write_png16`` writes the uint16
grayscale PNG of a KITTI submission (``dsmnet_tpu/train/trainer.py:384-389``
writes it through cv2, which the card's machine may also lack), and
``read_png16`` reads such a file back.
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
           "colorize", "write_png", "write_png16", "read_png16"]

# matplotlib's viridis as ``Colormap(x, bytes=True)`` looks it up: its 256
# RGB entries times 255, truncated to uint8 (alpha is 255), row by row
VIRIDIS_RGB = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f624711634712654714664715"
    "6747166947186a48196b481a6c481c6e481d6f481e7048207148217248227348237447257547267647277747"
    "2878472a79472b7a472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83"
    "433b83433c84423d84423e854240854141864142864043874044873f45873f47883e48883e49893d4a893d4b"
    "893d4c893c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c36"
    "5b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d31668d30678d30688d2f698d"
    "2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e2c728e2b738e2b748e2a758e2a768e2a778e2978"
    "8e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24"
    "868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e881e9f881ea0871fa1"
    "871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad8028ae7f29"
    "af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7"
    "645bc8625ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517c"
    "d24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938"
    "a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e0"
    "1fcae01ecde01dcfe11cd2e11bd4e11ad7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aee"
    "e51bf1e51cf3e51ef6e61ff8e621fae622fde724"
), np.uint8).reshape(256, 3)


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


def colorize(image: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of a 2-D float array, as ``plt.imsave`` colours it
    with its defaults (``Normalize`` then ``Colormap.__call__`` of viridis,
    matplotlib 3.10): x - min rounded to the array's dtype, divided by
    max - min in float64 and rounded again (all 0 when max == min); times
    256, 256 itself to 255, truncated to the index."""
    a = np.asarray(image)
    dt = a.dtype if a.dtype.kind == "f" else np.dtype(np.float64)
    lo, hi = float(a.min()), float(a.max())
    if hi == lo:
        t = np.zeros(a.shape, dt)
    else:
        t = (a.astype(np.float64) - lo).astype(dt)
        t = (t.astype(np.float64) / (hi - lo)).astype(dt) * dt.type(256)
    t[t == 256] = 255
    idx = np.clip(t, 0, 255).astype(np.intp)
    rgba = np.full(a.shape + (4,), 255, np.uint8)
    rgba[..., :3] = VIRIDIS_RGB[idx]
    return rgba


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _write_png_rows(fname: str, rows: np.ndarray, bit_depth: int, colour_type: int) -> None:
    """A PNG of ``rows`` (H, row bytes...) in big-endian sample order,
    every line unfiltered."""
    h, w = rows.shape[:2]
    raw = b"".join(b"\x00" + rows[i].tobytes() for i in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(fname, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth, colour_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def write_png(fname: str, image: np.ndarray) -> None:
    """Write a 2-D float array as the RGBA PNG of :func:`colorize`."""
    # 8-bit RGBA (colour type 6)
    _write_png_rows(fname, colorize(image), 8, 6)


def write_png16(fname: str, image: np.ndarray) -> None:
    """Write a 2-D uint16 array as a 16-bit grayscale PNG (colour type 0), the
    file ``cv2.imwrite`` writes for it."""
    a = np.asarray(image)
    if a.ndim != 2 or a.dtype != np.uint16:
        raise ValueError(f"expected a 2-D uint16 array, got {a.shape} {a.dtype}")
    _write_png_rows(fname, a.astype(">u2"), 16, 0)


def read_png16(fname: str) -> np.ndarray:
    """Read a 16-bit grayscale PNG whose lines are unfiltered, as
    :func:`write_png16` writes it, into a 2-D uint16 array; raises for any
    other PNG."""
    with open(fname, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{fname}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    if header is None or header[2:] != (16, 0, 0, 0, 0):
        raise ValueError(f"{fname}: not a 16-bit grayscale PNG without interlacing: {header}")
    w, h = header[:2]
    lines = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 2 * w)
    if lines[:, 0].any():
        raise ValueError(f"{fname}: filtered lines are not read here")
    return lines[:, 1:].copy().view(">u2").astype(np.uint16)
