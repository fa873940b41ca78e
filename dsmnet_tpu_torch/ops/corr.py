"""1-D horizontal correlation (DispNetC's matching stage), with its gradient.

PyTorch counterpart of ``dsmnet_tpu/ops/corr.py``:

    corr[n, h, w, d] = sum_c fL[n, h, w, c] * fR[n, h, w - d*stride, c]

for w - d*stride >= 0, else 0, so channel d is all zero when d >= W.
``kernel_size > 1`` then applies a k x k average pool, stride 1, zero
padding k//2, whose divisor counts the padding (torch's default).

``corr1d`` is the autograd ``Function`` ``_Corr1d``: the forward is kernel
I (``csrc/corr1d.cu``, replaces ``_corr1d_pallas_fwd``) on a CUDA tensor,
the backward the plain port of JAX's ``_corr1d_vjp_bwd``.  Both sum in
float32 (float64 for float64 inputs) and return the inputs' dtype, as the
Pallas output does.  JAX keeps jnp by default, measured on a TPU; the port
launches its kernel for every CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import _build

__all__ = ["corr1d", "corr1d_plain", "corr1d_kernel", "corr1d_vjp"]


def corr1d_plain(fL: torch.Tensor, fR: torch.Tensor, D: int, stride: int = 1) -> torch.Tensor:
    """Plain version: (N,H,W,C) x2 -> (N,H,W,D), one product-sum per shift."""
    acc = torch.promote_types(fL.dtype, torch.float32)
    a, b = fL.to(acc), fR.to(acc)
    n, h, w, _ = fL.shape
    out = a.new_zeros((n, h, w, D))
    for d in range(D):
        s = d * stride
        if s < w:
            out[..., s:, d] = (a[:, :, s:] * b[:, :, :w - s]).sum(-1)
    return out.to(fL.dtype)


def corr1d_vjp(fL: torch.Tensor, fR: torch.Tensor, g: torch.Tensor,
               stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The correlation's VJP (JAX ``_corr1d_vjp_bwd``, ``corr.py:123``):
    g (N,H,W,D) -> (dfL, dfR), each (N,H,W,C) in fL's dtype."""
    w = fL.shape[2]
    dfL = torch.zeros_like(fL)
    dfR = torch.zeros_like(fR)
    for d in range(g.shape[-1]):
        s = d * stride
        if s >= w:
            break
        gd = g[..., d:d + 1]
        dfL[:, :, s:] += gd[:, :, s:] * fR[:, :, :w - s]
        dfR[:, :, :w - s] += gd[:, :, s:] * fL[:, :, s:]
    return dfL, dfR


def corr1d_kernel(fL: torch.Tensor, fR: torch.Tensor, D: int, stride: int = 1) -> torch.Tensor:
    """Kernel I wrapper.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises.  C times the element size must
    be a multiple of 16 bytes."""
    _build.require_no_grad("corr1d", fL, fR)
    if not config.launches_kernel("corr1d", fL):
        return corr1d_plain(fL, fR, D, stride)
    _build.require_cuda("corr1d", fL, fR)
    if (fL.dim() != 4 or fR.shape != fL.shape or D < 1 or stride < 1
            or (fL.shape[-1] * fL.element_size()) % 16):
        raise ValueError(f"corr1d takes fL, fR (N,H,W,C) of one shape, C * element size a "
                         f"multiple of 16 bytes, D >= 1 and stride >= 1; got "
                         f"{tuple(fL.shape)}, {tuple(fR.shape)}, D={D}, stride={stride}")
    n, h, w, c = fL.shape
    out = torch.empty((n, h, w, D), dtype=fL.dtype, device=fL.device)
    _build.launch("corr1d", fL.device, fL.data_ptr(), fR.data_ptr(), out.data_ptr(),
                  _build.DTYPE_CODES[fL.dtype], n, h, w, c, D, stride)
    return out


class _Corr1d(torch.autograd.Function):
    """Kernel I forward; the plain VJP backward."""

    @staticmethod
    def forward(ctx, fL, fR, D, stride):
        ctx.save_for_backward(fL, fR)
        ctx.stride = stride
        return corr1d_kernel(fL, fR, D, stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        fL, fR = ctx.saved_tensors
        dfL, dfR = corr1d_vjp(fL, fR, g, ctx.stride)
        return dfL, dfR, None, None


def corr1d(fL: torch.Tensor, fR: torch.Tensor, D: int, stride: int = 1,
           kernel_size: int = 1) -> torch.Tensor:
    """1-D horizontal correlation, (N,H,W,C) x2 -> (N,H,W,D)."""
    if config.impl["corr1d"] == "plain":
        corr = corr1d_plain(fL, fR, D, stride)
    else:
        corr = _Corr1d.apply(fL.contiguous(), fR.contiguous(), D, stride)
    if kernel_size > 1:
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        corr = F.avg_pool2d(corr.permute(0, 3, 1, 2), kernel_size, stride=1,
                            padding=kernel_size // 2).permute(0, 2, 3, 1)
    return corr
