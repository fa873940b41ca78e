"""1-D horizontal correlation (DispNetC's matching stage), with its gradient.

PyTorch counterpart of ``dsmnet_tpu/ops/corr.py``:

    corr[n, h, w, d] = sum_c fL[n, h, w, c] * fR[n, h, w - d*stride, c]

for w - d*stride >= 0, else 0, so channel d is all zero when d >= W.
``kernel_size > 1`` then applies a k x k average pool, stride 1, zero
padding k//2, whose divisor counts the padding (torch's default).

``corr1d`` is the autograd ``Function`` ``_Corr1d``: on a CUDA tensor the
forward is kernel I (``csrc/corr1d.cu``, replaces ``_corr1d_pallas_fwd``)
and the backward its VJP kernel (``csrc/corr1d_vjp.cu``, replaces the jnp
``_corr1d_vjp_bwd``); on a CPU tensor both take their plain versions.
Both kernels sum in float32 and return the inputs' dtype, as the Pallas
output does.  JAX keeps jnp by default, measured on a TPU; the port
launches its kernels for every CUDA tensor.

In bf16 both kernels are banded products on the tensor cores over tiles
of ``CORR_TILE`` columns of one (n, h) row; ``band_plan`` and
``vjp_plan`` mirror what each stages in shared memory (the wrappers
refuse a shape whose plan exceeds it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import _build

__all__ = ["corr1d", "corr1d_plain", "corr1d_reference", "corr1d_kernel", "corr1d_vjp",
           "corr1d_vjp_kernel", "band_plan", "vjp_plan"]

CORR_TILE = 64        # columns of one (n, h) row a block owns (both .cu files' kTile)
CORR_NB = 4           # n8 tiles of G a strip forms per pass (corr1d.cu kNB)
VJP_MAX_C = 128       # channels the bf16 VJP's accumulators hold (corr1d_vjp.cu kMaxC)
SMEM_LIMIT = 232448   # the H100's shared memory per block


def band_plan(c: int, D: int, stride: int) -> dict:
    """Kernel I's bf16 staging (``corr1d.cu`` ``band_plan``): ``cp`` channels
    per staged row (C rounded up to 16, zeros above C) at ``pitch``
    elements; strip i of 16 output columns meets G's columns 16 i .. 16 i +
    15 + (D-1) stride, ``ni`` n8 tiles, formed CORR_NB a pass (two warps a
    strip) in ``passes``; ``rows`` fR columns staged from w0 - (D-1)
    stride (the last strip's reach); ``smem`` bytes (the staged fL and fR
    rows, then the output tile of 64 D elements and up to 7 of alignment
    shift)."""
    cp = -(-c // 16) * 16
    ni = -(-((D - 1) * stride + 16) // 8)
    passes = -(-ni // CORR_NB)
    rows = 48 + 8 * CORR_NB * passes
    pitch = cp + 8
    smem = (CORR_TILE + rows) * pitch * 2 + (CORR_TILE * D + 8) * 2
    return dict(cp=cp, pitch=pitch, ni=ni, passes=passes, rows=rows, smem=smem)


def vjp_plan(c: int, D: int, stride: int) -> dict:
    """The bf16 VJP's staging (``corr1d_vjp.cu`` ``vjp_plan``): ``cp``
    channels per staged feature row at ``pitch`` elements; strip i of the
    64 x ``rows`` band reads its columns 16 i .. 16 i + 16 ``ks`` - 1 (``ks``
    k16 steps cover 16 + (D-1) stride); ``rows`` feature columns
    staged (the last strip's reach), the band's row pitch ``bpitch``;
    ``smem`` bytes (the features, then the band)."""
    cp = -(-c // 16) * 16
    ks = -(-((D - 1) * stride + 16) // 16)
    rows = 48 + 16 * ks
    pitch, bpitch = cp + 8, rows + 8
    return dict(cp=cp, pitch=pitch, ks=ks, rows=rows, bpitch=bpitch,
                smem=(rows * pitch + CORR_TILE * bpitch) * 2)


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
            or (fL.shape[-1] * fL.element_size()) % 16
            or (fL.dtype == torch.bfloat16 and band_plan(fL.shape[-1], D, stride)["smem"]
                > SMEM_LIMIT)):
        raise ValueError(f"corr1d takes fL, fR (N,H,W,C) of one shape, C * element size a "
                         f"multiple of 16 bytes, D >= 1 and stride >= 1, and in bf16 a "
                         f"band_plan within shared memory; got {tuple(fL.shape)}, "
                         f"{tuple(fR.shape)}, {fL.dtype}, D={D}, stride={stride}")
    n, h, w, c = fL.shape
    out = torch.empty((n, h, w, D), dtype=fL.dtype, device=fL.device)
    _build.launch("corr1d", fL.device, fL.data_ptr(), fR.data_ptr(), out.data_ptr(),
                  _build.DTYPE_CODES[fL.dtype], n, h, w, c, D, stride)
    return out


def corr1d_vjp_kernel(fL: torch.Tensor, fR: torch.Tensor, g: torch.Tensor,
                      stride: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel I's VJP wrapper: g (N,H,W,D) -> (dfL, dfR).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    C times the element size must be a multiple of 16 bytes; in bf16 C <=
    128 and the plan within shared memory."""
    _build.require_no_grad("corr1d_vjp", fL, fR, g)
    if not config.launches_kernel("corr1d", fL):
        return corr1d_vjp(fL, fR, g, stride)
    _build.require_cuda("corr1d_vjp", fL, fR, g)
    if (fL.dim() != 4 or fR.shape != fL.shape or g.shape[:3] != fL.shape[:3] or g.dim() != 4
            or stride < 1 or (fL.shape[-1] * fL.element_size()) % 16
            or (fL.dtype == torch.bfloat16 and (
                fL.shape[-1] > VJP_MAX_C
                or vjp_plan(fL.shape[-1], g.shape[-1], stride)["smem"] > SMEM_LIMIT))):
        raise ValueError(f"corr1d_vjp takes fL, fR (N,H,W,C) of one shape and g (N,H,W,D), "
                         f"C * element size a multiple of 16 bytes, stride >= 1, and in bf16 "
                         f"C <= {VJP_MAX_C} and a vjp_plan within shared memory; got "
                         f"{tuple(fL.shape)}, {tuple(fR.shape)}, {tuple(g.shape)}, {fL.dtype}, "
                         f"stride={stride}")
    n, h, w, c = fL.shape
    dfL, dfR = torch.empty_like(fL), torch.empty_like(fR)
    _build.launch("corr1d_vjp", fL.device, fL.data_ptr(), fR.data_ptr(), g.data_ptr(),
                  dfL.data_ptr(), dfR.data_ptr(), _build.DTYPE_CODES[fL.dtype], n, h, w, c,
                  g.shape[-1], stride)
    return dfL, dfR


def _dot_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Default similarity: the channel dot product (reference util_conv.py:64-66)."""
    return (a * b).sum(-1)


def corr1d_reference(fL: torch.Tensor, fR: torch.Tensor, D: int, stride: int = 1,
                     simfun=None) -> torch.Tensor:
    """The correlation with any similarity, (N,H,W,C) x2 -> (N,H,W,D)
    (``dsmnet_tpu/ops/corr.py:52``): ``simfun(a, b) -> (N,H,W')`` scores
    aligned feature vectors (e.g. a cosine similarity, as the reference's
    Corr1d accepts); the dot product by default."""
    simfun = simfun or _dot_sim
    n, h, w, _ = fL.shape
    outs = [simfun(fL, fR)]
    for d in range(1, D):
        idx = d * stride
        if idx >= w:
            outs.append(fL.new_zeros((n, h, w)))
            continue
        outs.append(F.pad(simfun(fL[:, :, idx:], fR[:, :, :w - idx]), (idx, 0)))
    return torch.stack(outs, dim=-1)


class _Corr1d(torch.autograd.Function):
    """Kernel I forward; its VJP kernel backward."""

    @staticmethod
    def forward(ctx, fL, fR, D, stride):
        ctx.save_for_backward(fL, fR)
        ctx.stride = stride
        return corr1d_kernel(fL, fR, D, stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        fL, fR = ctx.saved_tensors
        dfL, dfR = corr1d_vjp_kernel(fL, fR, g.contiguous(), ctx.stride)
        return dfL, dfR, None, None


def corr1d(fL: torch.Tensor, fR: torch.Tensor, D: int, stride: int = 1,
           kernel_size: int = 1, simfun=None) -> torch.Tensor:
    """1-D horizontal correlation, (N,H,W,C) x2 -> (N,H,W,D).  A custom
    ``simfun`` takes ``corr1d_reference`` on every device, as in JAX
    (``dsmnet_tpu/ops/corr.py:173-176``): the kernels compute the dot
    product only."""
    if simfun is not None:
        corr = corr1d_reference(fL, fR, D, stride, simfun)
    elif config.impl["corr1d"] == "plain":
        corr = corr1d_plain(fL, fR, D, stride)
    else:
        corr = _Corr1d.apply(fL.contiguous(), fR.contiguous(), D, stride)
    if kernel_size > 1:
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        corr = F.avg_pool2d(corr.permute(0, 3, 1, 2), kernel_size, stride=1,
                            padding=kernel_size // 2).permute(0, 2, 3, 1)
    return corr
