"""stride-1 SAME 3x3 2-D convolution, channels-last.

PyTorch counterpart of ``dsmnet_tpu/ops/conv2d.py``.  As in the JAX
package (``pallas2d_ok``, ``dsmnet_tpu/ops/conv2d_pallas.py:41-55``), only
C == Co == 32 goes to the hand-written kernel (kernel A,
``csrc/conv2d_k3.cu``, which replaces ``conv2d_fwd_pallas_folded``);
every other shape takes the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import _build

__all__ = ["conv2d_same", "conv2d_k3", "conv2d_k3_plain"]


def conv2d_k3_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version: x (N,H,W,C), k (3,3,C,Co) HWIO -> (N,H,W,Co)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def kernel_ok(x: torch.Tensor, k: torch.Tensor) -> bool:
    return x.dim() == 4 and x.shape[-1] == 32 and tuple(k.shape) == (3, 3, 32, 32)


def conv2d_k3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel A wrapper.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if not config.launches_kernel("conv2d", x):
        return conv2d_k3_plain(x, k)
    _build.require_cuda("conv2d_k3", x, k)
    if not kernel_ok(x, k):
        raise ValueError(f"conv2d_k3 takes x (N,H,W,32), k (3,3,32,32); got "
                         f"{tuple(x.shape)}, {tuple(k.shape)}")
    n, h, w, c = x.shape
    y = torch.empty((n, h, w, 32), dtype=x.dtype, device=x.device)
    _build.launch("conv2d_k3", x.device, x.data_ptr(), k.data_ptr(), y.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, h, w, c, 32)
    return y


def conv2d_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """stride-1 SAME conv, x (N,H,W,C), k (3,3,C,Co)."""
    if config.impl["conv2d"] != "plain" and kernel_ok(x, k):
        return conv2d_k3(x.contiguous(), k.contiguous())
    return conv2d_k3_plain(x, k)
