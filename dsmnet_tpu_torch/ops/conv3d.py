"""3-D convolutions of PSMNet's regularizer, channels-last.

PyTorch counterpart of ``dsmnet_tpu/ops/conv3d.py`` (with the Pallas
forward kernels of ``conv3d_pallas.py`` / ``conv3d_s2_pallas.py`` and the
folded deconv of ``folded.py``).  Three ops, each with a hand-written
kernel for the shapes the JAX package sends to Pallas and the plain
PyTorch version for the rest:

  * ``conv3d_same`` — 3x3x3 stride 1 SAME; kernel B (``csrc/conv3d_k3.cu``)
    for C, Co in {32, 64}.  The Cout=1 classifier head stays plain, as
    JAX computes it outside Pallas (``folded.py:170-194``).
  * ``conv3d_s2`` — 3x3x3 stride 2 pad 1, even D/H/W; kernel C
    (``csrc/conv3d_k3s2.cu``) for C in {32, 64}, Co = 64.
  * ``deconv3d_k3s2`` — ConvTranspose3d k3 s2 p1 op1 on the flax
    (3,3,3,Cout,Cin) kernel; kernel D (``csrc/deconv3d_k3s2.cu``) for
    Cin 64 -> Cout 32, the ``_fdc_eligible`` gate (``folded.py:302-316``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import _build

__all__ = [
    "conv3d_same", "conv3d_s2", "deconv3d_k3s2",
    "conv3d_k3", "conv3d_k3s2", "deconv3d_k3s2_kernel",
    "conv3d_plain", "conv3d_s2_plain", "deconv3d_k3s2_plain",
]


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y):
    return y.permute(0, 2, 3, 4, 1)


# ------------------------------------------------------------ plain versions

def conv3d_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv: x (N,D,H,W,C), k (kd,kh,kw,C,Co) odd -> (N,D,H,W,Co)."""
    pad = tuple((s - 1) // 2 for s in k.shape[:3])
    return _ndhwc(F.conv3d(_ncdhw(x), k.permute(4, 3, 0, 1, 2), padding=pad))


def conv3d_s2_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-2 pad-1 conv: x (N,D,H,W,C), k (3,3,3,C,Co) -> (N,D/2,H/2,W/2,Co)."""
    return _ndhwc(F.conv3d(_ncdhw(x), k.permute(4, 3, 0, 1, 2), stride=2, padding=1))


def deconv3d_k3s2_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact-2x transposed conv: x (N,D,H,W,Cin), k (3,3,3,Cout,Cin) in the
    flax transpose_kernel layout -> (N,2D,2H,2W,Cout).  lax's pads (1, 2)
    with transpose_kernel=True are torch's padding 1, output_padding 1 on
    the weight (Cin, Cout, kd, kh, kw), with no flip: y[2u+s-1] += k[s].x[u]."""
    w = k.permute(4, 3, 0, 1, 2)
    return _ndhwc(F.conv_transpose3d(_ncdhw(x), w, stride=2, padding=1, output_padding=1))


# ---------------------------------------------------------- kernel wrappers

def conv3d_k3_ok(x, k) -> bool:
    return (x.dim() == 5 and tuple(k.shape[:3]) == (3, 3, 3) and k.dim() == 5
            and x.shape[-1] == k.shape[3] and k.shape[3] in (32, 64) and k.shape[4] in (32, 64))


def conv3d_k3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel B wrapper (stride-1 SAME 3x3x3).  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if not config.launches_kernel("conv3d", x):
        return conv3d_plain(x, k)
    _build.require_cuda("conv3d_k3", x, k)
    if not conv3d_k3_ok(x, k):
        raise ValueError(f"conv3d_k3 takes C, Co in {{32, 64}}; got x {tuple(x.shape)}, "
                         f"k {tuple(k.shape)}")
    n, d, h, w, c = x.shape
    co = k.shape[4]
    y = torch.empty((n, d, h, w, co), dtype=x.dtype, device=x.device)
    _build.launch("conv3d_k3", x.device, x.data_ptr(), k.data_ptr(), y.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, d, h, w, c, co)
    return y


def conv3d_k3s2_ok(x, k) -> bool:
    return (x.dim() == 5 and k.dim() == 5 and tuple(k.shape[:3]) == (3, 3, 3)
            and x.shape[-1] == k.shape[3] and k.shape[3] in (32, 64) and k.shape[4] == 64
            and all(s % 2 == 0 for s in x.shape[1:4]))


def conv3d_k3s2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel C wrapper (stride-2 pad-1 3x3x3)."""
    if not config.launches_kernel("conv3d_s2", x):
        return conv3d_s2_plain(x, k)
    _build.require_cuda("conv3d_k3s2", x, k)
    if not conv3d_k3s2_ok(x, k):
        raise ValueError(f"conv3d_k3s2 takes even D/H/W, C in {{32, 64}}, Co 64; got "
                         f"x {tuple(x.shape)}, k {tuple(k.shape)}")
    n, d, h, w, c = x.shape
    y = torch.empty((n, d // 2, h // 2, w // 2, 64), dtype=x.dtype, device=x.device)
    _build.launch("conv3d_k3s2", x.device, x.data_ptr(), k.data_ptr(), y.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, d, h, w, c, 64)
    return y


def deconv3d_k3s2_ok(x, k) -> bool:
    return (x.dim() == 5 and tuple(k.shape) == (3, 3, 3, 32, 64) and x.shape[-1] == 64)


def deconv3d_k3s2_kernel(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel D wrapper (k3 s2 transposed conv, Cin 64 -> Cout 32)."""
    if not config.launches_kernel("deconv3d", x):
        return deconv3d_k3s2_plain(x, k)
    _build.require_cuda("deconv3d_k3s2", x, k)
    if not deconv3d_k3s2_ok(x, k):
        raise ValueError(f"deconv3d_k3s2 takes x (...,64), k (3,3,3,32,64); got "
                         f"x {tuple(x.shape)}, k {tuple(k.shape)}")
    n, d, h, w, c = x.shape
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, 32), dtype=x.dtype, device=x.device)
    _build.launch("deconv3d_k3s2", x.device, x.data_ptr(), k.data_ptr(), y.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, d, h, w, c, 32)
    return y


# --------------------------------------------------------------------- ops

def conv3d_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3-D conv, x (N,D,H,W,Ci), k (kd,kh,kw,Ci,Co), odd dims."""
    if config.impl["conv3d"] != "plain" and conv3d_k3_ok(x, k):
        return conv3d_k3(x.contiguous(), k.contiguous())
    return conv3d_plain(x, k)


def conv3d_s2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-2 SAME(p=1) 3x3x3 conv; x (N,D,H,W,Ci) with even D/H/W."""
    if config.impl["conv3d_s2"] != "plain" and conv3d_k3s2_ok(x, k):
        return conv3d_k3s2(x.contiguous(), k.contiguous())
    return conv3d_s2_plain(x, k)


def deconv3d_k3s2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact-2x transposed 3-D conv (k=3, s=2, torch geometry p=1 op=1);
    x (N,D,H,W,Ci), k (3,3,3,Co,Ci) — the flax transpose_kernel layout."""
    if config.impl["deconv3d"] != "plain" and deconv3d_k3s2_ok(x, k):
        return deconv3d_k3s2_kernel(x.contiguous(), k.contiguous())
    return deconv3d_k3s2_plain(x, k)
