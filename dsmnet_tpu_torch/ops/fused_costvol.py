"""Fused concat-cost-volume + first 3-D convolution (PSMNet's stem).

PyTorch counterpart of ``cost_volume_conv3x3`` in
``dsmnet_tpu/ops/fused_costvol.py``.  Every voxel of the concat volume is
a (masked, shifted) copy of a 2-D feature, so its 3x3x3 SAME convolution
collapses exactly into 2-D "tap maps" that do not depend on d:

    out[d,h,w,o] =   sum_{dd,dw} A_{dd,dw}[h,w,o]   * leftmask(d,w)
                   + sum_{dd,dw} B_{dd,dw}[h, w+dw-(d+dd), o] * extent(d,w)

with A / B the 3-tap H-convolutions of fL / fR against the kernel's left
/ right channel halves (A also shifted by dw in W).  The 2F-channel
volume is never built.  The assembly here is the JAX package's exact
``_assemble_jnp`` (:95); its XLA-specific skew and grouped assemblies
compute the same function and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv3d import conv3d_plain
from .cost_volume import concat_cost_volume_reference

__all__ = ["cost_volume_conv3x3", "cost_volume_conv3x3_reference"]

_TAPS = [(dd, dw) for dd in (-1, 0, 1) for dw in (-1, 0, 1)]


def cost_volume_conv3x3_reference(fL, fR, kernel, D: int, mask_left: bool = True):
    """Golden composition: build the volume, run the 3-D conv (SAME)."""
    return conv3d_plain(concat_cost_volume_reference(fL, fR, D, mask_left), kernel)


def _conv_dh(x, k):
    """3-tap conv over H contracting features: x (N,H,W,F), k (3,F,O)."""
    w = k.permute(2, 1, 0).unsqueeze(-1)  # (O, F, 3, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(1, 0))
    return y.permute(0, 2, 3, 1)


def _shift_w(x, s: int):
    """x shifted so out[..., w, :] = x[..., w+s, :], zero padded."""
    if s == 0:
        return x
    w = x.shape[2]
    if s > 0:
        return F.pad(x[:, :, s:, :], (0, 0, 0, s))
    return F.pad(x[:, :, :w + s, :], (0, 0, -s, 0))


def _tap_maps(fL, fR, kernel):
    """A/B tap maps keyed by (dd, dw).  The nine taps of each half run as
    one H-convolution with 9*O output channels."""
    f = fL.shape[-1]
    o = kernel.shape[-1]
    # (3 dd, 3 dh, 3 dw, F, O) -> (dh, F, (dd, dw, O))
    KL = kernel[..., :f, :].permute(1, 3, 0, 2, 4).reshape(3, f, 9 * o)
    KR = kernel[..., f:, :].permute(1, 3, 0, 2, 4).reshape(3, f, 9 * o)
    a_all = _conv_dh(fL, KL)
    b_all = _conv_dh(fR, KR)
    A, B = {}, {}
    for t, (dd, dw) in enumerate(_TAPS):
        A[(dd, dw)] = _shift_w(a_all[..., t * o:(t + 1) * o], dw)
        B[(dd, dw)] = b_all[..., t * o:(t + 1) * o]
    return A, B


def _assemble(A, B, D: int, mask_left: bool, dtype):
    """Exact assembly of the tap maps (``_assemble_jnp``)."""
    n, h, w, o = A[_TAPS[0]].shape
    dev = A[_TAPS[0]].device
    d_iota = torch.arange(D, device=dev).view(D, 1)
    w_iota = torch.arange(w, device=dev).view(1, w)
    zero = torch.zeros((), dtype=dtype, device=dev)
    out = torch.zeros((n, D, h, w, o), dtype=dtype, device=dev)
    for dd, dw in _TAPS:
        dval = (d_iota + dd >= 0) & (d_iota + dd <= D - 1)
        wext = (w_iota + dw >= 0) & (w_iota + dw <= w - 1)
        lmask = dval & (w_iota + dw >= d_iota + dd) if mask_left else dval.expand(D, w)
        out += torch.where(lmask.view(1, D, 1, w, 1), A[(dd, dw)].unsqueeze(1), zero)
        u = w_iota + dw - (d_iota + dd)
        uval = dval & wext & (u >= 0)
        bg = B[(dd, dw)][:, :, u.clamp(0, w - 1), :]  # (n, h, D, W, o)
        out += torch.where(uval.view(1, 1, D, w, 1), bg, zero).permute(0, 2, 1, 3, 4)
    return out


def cost_volume_conv3x3(fL, fR, kernel, D: int, mask_left: bool = True):
    """Fused volume+conv via the tap-map decomposition.

    fL/fR (N,H,W,F); kernel (3,3,3,2F,O) in DHWIO layout; returns
    (N,D,H,W,O) in fL's dtype — equal (up to float association) to
    ``cost_volume_conv3x3_reference``."""
    A, B = _tap_maps(fL, fR, kernel)
    return _assemble(A, B, D, mask_left, fL.dtype)
