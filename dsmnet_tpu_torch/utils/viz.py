"""Plotting helpers (``dsmnet_tpu/utils/viz.py``; reference utils/utils.py:56-84
imshow/imsplot).

Matplotlib grid display of NHWC arrays or tensors — used by the
dataloader debug tool and for eyeballing warps during loss debugging.
Import is deferred so headless training never touches matplotlib.
"""

from __future__ import annotations

import numpy as np

__all__ = ["imshow_array", "imsplot", "save_grid"]


def _to_np(img):
    if hasattr(img, "detach"):  # a torch tensor, on any device
        img = img.detach().float().cpu().numpy()
    arr = np.asarray(img)
    if arr.ndim == 4:
        arr = arr[0]
    return arr


def imshow_array(img, ax=None):
    """Show one (H,W,C)/(N,H,W,C) image or single-channel map."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    arr = _to_np(img)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        ax.imshow(np.clip(arr, 0, 1))
    else:
        ax.imshow(arr[..., 0] if arr.ndim == 3 else arr)
    ax.axis("off")


def imsplot(*imgs, cols: int = 2):
    """Grid plot of up to 8 arrays (utils.py:72-84)."""
    import matplotlib.pyplot as plt

    count = min(8, len(imgs))
    if count == 0:
        return
    cols = min(cols, count)
    rows = (count + cols - 1) // cols
    for i in range(count):
        plt.subplot(rows, cols, i + 1)
        imshow_array(imgs[i])


def save_grid(path: str, *imgs, cols: int = 2):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(6 * cols, 4 * ((min(8, len(imgs)) + cols - 1) // cols)))
    imsplot(*imgs, cols=cols)
    plt.savefig(path, bbox_inches="tight")
    plt.close()
