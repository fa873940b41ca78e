"""Concatenation cost volume of GCNet and PSMNet-basic, with its gradient.

PyTorch counterpart of ``dsmnet_tpu/ops/cost_volume.py``:

    cost[n, d, h, w, :F] = fL[n, h, w] * [w >= d]   (mask_left; else fL)
    cost[n, d, h, w, F:] = fR[n, h, w - d] * [w >= d]
and slices with d >= W are zero in both halves (the left half stays
dense for every d when mask_left is False).

``concat_cost_volume`` is the autograd ``Function`` ``_CostVolume``: the
forward is kernel H (``csrc/cost_volume.cu``, replaces
``_cost_volume_pallas_fwd``) on a CUDA tensor, the backward the JAX
package's linear VJP (``_cv_vjp_bwd``) in plain PyTorch, as it is jnp
there.  JAX keeps the volume on jnp by default, measured on a TPU; the
port launches its kernel for every CUDA tensor, in float32 and in bf16.
PSMNet's own path never builds the volume (the fused stem,
``ops/fused_costvol.py``); there ``concat_cost_volume_reference`` is the
stem's test oracle.
"""

from __future__ import annotations

import torch

from .. import config
from . import _build

__all__ = ["concat_cost_volume", "concat_cost_volume_reference", "cost_volume_kernel",
           "cost_volume_vjp"]


def concat_cost_volume_reference(fL: torch.Tensor, fR: torch.Tensor, D: int,
                                 mask_left: bool = True) -> torch.Tensor:
    """Plain version: (N,H,W,F) x2 -> (N,D,H,W,2F)."""
    n, h, w, f = fL.shape
    vol = fL.new_zeros((n, D, h, w, 2 * f))
    for d in range(D):
        if mask_left:
            vol[:, d, :, d:, :f] = fL[:, :, d:]
        else:
            vol[:, d, :, :, :f] = fL
        if d < w:
            vol[:, d, :, d:, f:] = fR[:, :, :w - d]
    return vol


def cost_volume_vjp(g: torch.Tensor, mask_left: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The volume's linear VJP (JAX ``_cv_vjp_bwd``, ``cost_volume.py:112``):
    g (N,D,H,W,2F) -> (dfL, dfR), each (N,H,W,F)."""
    _, D, _, w, f2 = g.shape
    f = f2 // 2
    gl, gr = g[..., :f], g[..., f:]
    if mask_left:
        d = torch.arange(D, device=g.device)[:, None, None, None]
        col = torch.arange(w, device=g.device)[None, None, :, None]
        gl = gl * (col >= d).to(g.dtype)
    dfR = gr[:, 0].clone()
    for d in range(1, min(D, w)):
        dfR[:, :, :w - d] += gr[:, d, :, d:]
    return gl.sum(1), dfR


def cost_volume_kernel(fL: torch.Tensor, fR: torch.Tensor, D: int,
                       mask_left: bool = True) -> torch.Tensor:
    """Kernel H wrapper.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises.  The kernel copies 16-byte
    words, so F times the element size must be a multiple of 16."""
    _build.require_no_grad("cost_volume", fL, fR)
    if not config.launches_kernel("cost_volume", fL):
        return concat_cost_volume_reference(fL, fR, D, mask_left)
    _build.require_cuda("cost_volume", fL, fR)
    if fL.dim() != 4 or fR.shape != fL.shape or D < 1 or (fL.shape[-1] * fL.element_size()) % 16:
        raise ValueError(f"cost_volume takes fL, fR (N,H,W,F) of one shape, F * element size a "
                         f"multiple of 16 bytes, and D >= 1; got {tuple(fL.shape)}, "
                         f"{tuple(fR.shape)}, D={D}")
    n, h, w, f = fL.shape
    out = torch.empty((n, D, h, w, 2 * f), dtype=fL.dtype, device=fL.device)
    _build.launch("cost_volume", fL.device, fL.data_ptr(), fR.data_ptr(), out.data_ptr(),
                  _build.DTYPE_CODES[fL.dtype], n, h, w, f, D, int(mask_left))
    return out


class _CostVolume(torch.autograd.Function):
    """Kernel H forward; the plain linear VJP backward."""

    @staticmethod
    def forward(ctx, fL, fR, D, mask_left):
        ctx.mask_left = mask_left
        return cost_volume_kernel(fL, fR, D, mask_left)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dfL, dfR = cost_volume_vjp(g, ctx.mask_left)
        return dfL, dfR, None, None


def concat_cost_volume(fL: torch.Tensor, fR: torch.Tensor, D: int,
                       mask_left: bool = True) -> torch.Tensor:
    """Concatenation cost volume, (N,H,W,F) x2 -> (N,D,H,W,2F).  Each row
    of the volume reads its own row of fL and fR alone, so inside a banded
    section (``parallel.context.banded``) the volume of this rank's bands
    is its band of the whole volume, with no halo
    (``parallel.context.shard_cost_volume`` checks that it is one)."""
    from ..parallel.context import shard_cost_volume

    if config.impl["cost_volume"] == "plain":
        return shard_cost_volume(concat_cost_volume_reference(fL, fR, D, mask_left))
    return shard_cost_volume(_CostVolume.apply(fL.contiguous(), fR.contiguous(), D, mask_left))
