"""stride-1 SAME 3x3 2-D convolution, channels-last, with its gradient.

PyTorch counterpart of ``dsmnet_tpu/ops/conv2d.py``.  As in the JAX
package (``pallas2d_ok``, ``dsmnet_tpu/ops/conv2d_pallas.py:41-55``), only
C == Co == 32 goes to the hand-written kernels, through the autograd
``Function`` ``_Conv2dK3`` (the JAX ``custom_vjp``, ``conv2d.py:38-65``):

  * forward: kernel A (``csrc/conv2d_k3.cu``, replaces
    ``conv2d_fwd_pallas_folded``); in bf16 kernel B's walk
    (``csrc/s1_fwd_ring.cuh``) at KH = 1, over contiguous ranges of work
    items (n, row segment, output row) planned by :func:`k2_items` and
    :func:`k2_run`;
  * dx: kernel A on the cotangent with the flipped, channel-swapped kernel;
  * dK: kernel E (``csrc/conv2d_dk_k3.cu``, replaces
    ``conv2d_dk_pallas_folded``), float32, cast to the kernel's dtype; in
    bf16 kernel F's row ring (``csrc/s1_dk_ring.cuh``) at KD = 1, all nine
    taps a block, its rows and partials planned by :func:`dk_rows` and
    :func:`dk_chunks`.

Every other shape takes the plain version and plain autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import _build
from .conv3d import DK_K3_TILES, _cdiv

__all__ = ["conv2d_same", "conv2d_k3", "conv2d_k3_plain", "conv2d_dk_k3", "conv2d_dk_plain"]

# Kernel A's bf16 walk (csrc/conv2d_k3.cu on csrc/s1_fwd_ring.cuh at KH =
# 1): output positions of a row segment (two warpgroups of 64) and blocks
# resident per SM
K2_SEGMENT = 128
K2_BLOCKS_PER_SM = 2


def k2_items(n: int, h: int, w: int) -> int:
    """Work items (n, row segment, output row h), h fastest, of kernel A's
    bf16 walk."""
    return n * _cdiv(w, K2_SEGMENT) * h


def k2_run(items: int, sms: int) -> int:
    """Work items per block of kernel A's bf16 walk: contiguous ranges, one
    wave of K2_BLOCKS_PER_SM blocks per SM on ``sms`` SMs.  A block stages
    its kernel once and each run's input rows h0 - 1 .. h1 once, so the
    longest ranges stage the least.  A range is cut into runs of one
    segment's consecutive rows as B's are (``conv3d.k3_runs``, rows for
    slices)."""
    return _cdiv(items, max(1, sms * K2_BLOCKS_PER_SM))


# Kernel E's bf16 ring (csrc/conv2d_dk_k3.cu): kernel F's 32 -> 32 ring at
# KD = 1, so its segment positions, Co tile and blocks resident per SM
DK_TILE = DK_K3_TILES[32, 32]


def dk_rows(n: int, h: int, w: int) -> int:
    """Cotangent rows (n, w-segment, oh) that kernel E's bf16 walk sums."""
    return n * _cdiv(w, DK_TILE[0]) * h


def dk_chunks(rows: int, sms: int) -> int:
    """Partials of kernel E in bf16: one per block that runs at once (one
    block of all nine taps per chunk), as many as fill ``sms`` SMs, with no
    empty chunk.  (Its float32 tiles take one chunk per row, at most
    ``_build.DK_CHUNKS``.)"""
    _, cob, per_sm = DK_TILE
    per = _cdiv(rows, max(1, sms * per_sm // (32 // cob)))
    return _cdiv(rows, per)


def conv2d_k3_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version: x (N,H,W,C), k (3,3,C,Co) HWIO -> (N,H,W,Co)."""
    # a contiguous weight: at Cout = 1 the CPU conv's backward refuses a view
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous(), padding=1)
    return y.permute(0, 2, 3, 1)


def conv2d_dk_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient of the 3x3 SAME conv, one einsum per tap
    (JAX ``_dk_pertap``): x (N,H,W,C), g (N,H,W,Co) -> (3,3,C,Co) in float32
    (float64 for float64 operands)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    h, w = x.shape[1:3]
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    g = g.to(acc)
    return torch.stack([torch.einsum("nhwc,nhwo->co", xp[:, kh:kh + h, kw:kw + w], g)
                        for kh in range(3) for kw in range(3)]).reshape(3, 3, x.shape[-1],
                                                                       g.shape[-1])


def kernel_ok(x: torch.Tensor, k: torch.Tensor) -> bool:
    return x.dim() == 4 and x.shape[-1] == 32 and tuple(k.shape) == (3, 3, 32, 32)


def conv2d_k3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel A wrapper.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    _build.require_no_grad("conv2d_k3", x, k)
    if not config.launches_kernel("conv2d", x):
        return conv2d_k3_plain(x, k)
    _build.require_cuda("conv2d_k3", x, k)
    if not kernel_ok(x, k):
        raise ValueError(f"conv2d_k3 takes x (N,H,W,32), k (3,3,32,32); got "
                         f"{tuple(x.shape)}, {tuple(k.shape)}")
    n, h, w, c = x.shape
    y = torch.empty((n, h, w, 32), dtype=x.dtype, device=x.device)
    # the float32 tiles (conv_k3.cuh) take no range
    per = k2_run(k2_items(n, h, w), _build.sm_count(x.device.index)) \
        if x.dtype == torch.bfloat16 else 0
    _build.launch("conv2d_k3", x.device, x.data_ptr(), k.data_ptr(), y.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, h, w, c, 32, per)
    return y


def conv2d_dk_k3(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel E wrapper: dK (3,3,32,32) float32 from x (N,H,W,32) and the
    cotangent g (N,H,W,32)."""
    _build.require_no_grad("conv2d_dk_k3", x, g)
    if not config.launches_kernel("conv2d", x):
        return conv2d_dk_plain(x, g)
    _build.require_cuda("conv2d_dk_k3", x, g)
    if not (x.dim() == 4 and x.shape[-1] == 32 and g.shape == x.shape):
        raise ValueError(f"conv2d_dk_k3 takes x and g (N,H,W,32); got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    n, h, w, c = x.shape
    if x.dtype == torch.bfloat16:
        rows = dk_rows(n, h, w)
        chunks = dk_chunks(rows, _build.sm_count(x.device.index))
    else:
        rows, chunks = n * h, None
    return _build.launch_dk("conv2d_dk_k3", x, g, 9, (n, 1, h, w, c, 32), rows,
                            chunks).reshape(3, 3, 32, 32)


class _Conv2dK3(torch.autograd.Function):
    """Kernel A forward; A (dx) and E (dK) backward (JAX ``conv2d.py:52-62``)."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return conv2d_k3(x, k)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_k3(g, k.flip((0, 1)).transpose(2, 3).contiguous())
        if ctx.needs_input_grad[1]:
            dk = conv2d_dk_k3(x, g).to(k.dtype)
        return dx, dk


def conv2d_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """stride-1 SAME conv, x (N,H,W,C), k (3,3,C,Co)."""
    if config.impl["conv2d"] != "plain" and kernel_ok(x, k):
        return _Conv2dK3.apply(x.contiguous(), k.contiguous())
    return conv2d_k3_plain(x, k)
