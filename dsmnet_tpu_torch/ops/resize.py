"""Align-corners bilinear resizing as dense interpolation matmuls.

PyTorch counterpart of ``dsmnet_tpu/ops/resize.py``: the reference's
torch-0.3 upsampling always aligned corners, and the JAX package builds
the 1-D operators itself.  The port keeps the same float32 operators so
that both packages weight samples identically.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["interp_matrix", "resize_bilinear", "resize_trilinear", "upsample2x",
           "upsample_bilinear"]


@functools.lru_cache(maxsize=None)
def interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Dense 1-D align-corners linear interpolation matrix (n_out, n_in).

    Row i holds the bilinear weights with which input samples combine to
    produce output sample i, with src = i * (n_in-1)/(n_out-1).
    """
    A = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1 or n_out == 1:
        # degenerate axes: every output copies input sample 0 (align-corners
        # with a single output lands on src=0)
        A[:, 0] = 1.0
        return A
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    j0 = np.floor(src).astype(np.int64)
    j0 = np.minimum(j0, n_in - 2)
    frac = (src - j0).astype(np.float32)
    rows = np.arange(n_out)
    A[rows, j0] = 1.0 - frac
    A[rows, j0 + 1] = frac
    return A


def interp_tensor(n_out: int, n_in: int, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(interp_matrix(n_out, n_in), dtype=dtype or like.dtype,
                           device=like.device)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Align-corners bilinear resize of NHWC ``x`` to spatial ``out_hw``."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    x = torch.einsum("ih,nhwc->niwc", interp_tensor(oh, h, x), x)
    return torch.einsum("jw,niwc->nijc", interp_tensor(ow, w, x), x)


def resize_trilinear(x: torch.Tensor, out_dhw: tuple[int, int, int]) -> torch.Tensor:
    """Align-corners trilinear resize of NDHWC ``x`` to ``out_dhw`` (torch-0.3
    ``F.upsample(cost, [D, H, W], mode='trilinear')``, which lifts PSMNet's
    1/4-resolution costs in the reference)."""
    n, d, h, w, c = x.shape
    od, oh, ow = out_dhw
    if (od, oh, ow) == (d, h, w):
        return x
    x = torch.einsum("ed,ndhwc->nehwc", interp_tensor(od, d, x), x)
    x = torch.einsum("ih,nehwc->neiwc", interp_tensor(oh, h, x), x)
    return torch.einsum("jw,neiwc->neijc", interp_tensor(ow, w, x), x)


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-factor align-corners bilinear upsample of NHWC ``x``."""
    return resize_bilinear(x, (scale * x.shape[1], scale * x.shape[2]))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x align-corners bilinear upsample of NHWC ``x`` (torch-0.3
    ``nn.Upsample(scale_factor=2, mode='bilinear')``)."""
    return upsample_bilinear(x, 2)
