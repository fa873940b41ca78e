"""Fused concat-cost-volume + first 3-D convolution (PSMNet's stem).

PyTorch counterpart of ``cost_volume_conv3x3`` in
``dsmnet_tpu/ops/fused_costvol.py``.  Every voxel of the concat volume is
a (masked, shifted) copy of a 2-D feature, so its 3x3x3 SAME convolution
collapses exactly into 2-D "tap maps" that do not depend on d:

    out[d,h,w,o] =   sum_{dd,dw} A_{dd,dw}[h,w,o]   * leftmask(d,w)
                   + sum_{dd,dw} B_{dd,dw}[h, w+dw-(d+dd), o] * extent(d,w)

with A / B the 3-tap H-convolutions of fL / fR against the kernel's left
/ right channel halves (A also shifted by dw in W).  The 2F-channel
volume is never built.

The forward is the JAX package's Pallas path (``_fused_pallas_fwd``
:510): the tap maps are two H-convolutions with 9*O output channels in
float32 (``tap_maps``), and on a CUDA tensor kernel J
(``csrc/fused_costvol.cu``, replaces ``_fused_pallas_fwd`` and its
boundary patches) assembles them, summing in float32 and rounding once to
the inputs' dtype.  Like the TPU kernel it groups the taps by e = dw - dd:
in the interior an output is one of five suffix sums of the left groups
plus G[w - d], a 5-tap sum of the grouped right maps; slices 0 and D - 1
are summed tap by tap.  A block owns one (n, h) row in chunks of
:func:`stem_columns` columns, G in a ring of :func:`stem_ring` columns.
Its plain version, taken for CPU tensors, is the
exact per-tap ``_assemble_jnp`` (:95); the XLA-specific skew and grouped
assemblies compute the same function and are not ported.  JAX keeps its
XLA assembly by default, measured on a TPU; the port launches its kernel
for every CUDA tensor.

The gradient is the JAX package's hand VJP (``_stem_bwd`` :142, the custom
VJP of ``_fused_jnp`` :435-452), in plain torch: autograd of the
assembly's gathers would scatter-add into volume-sized buffers nine
times, while ``_stem_bwd`` reads the cotangent volume in a few passes (a
prefix sum over D, one anti-diagonal sum, single rows and columns) and
works on 2-D maps from there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import _build
from .conv3d import conv3d_plain
from .cost_volume import concat_cost_volume_reference

__all__ = ["cost_volume_conv3x3", "cost_volume_conv3x3_reference", "cost_volume_conv3x3_kernel",
           "assemble_plain", "tap_maps"]

_TAPS = [(dd, dw) for dd in (-1, 0, 1) for dw in (-1, 0, 1)]

# Kernel J's block (csrc/fused_costvol.cu): threads, and the H100's shared
# memory a block may take
STEM_THREADS = 256
STEM_MAX_SMEM = 232448


def stem_columns(o: int) -> int:
    """Columns of a chunk of kernel J's row walk: one thread per column and
    four channels."""
    return STEM_THREADS // (o // 4)


def stem_ring(d: int, o: int) -> int:
    """Columns of kernel J's rings of G and of slice D - 1's right halves:
    D + 2 chunks, so no thread overwrites a column that a thread of the
    chunk before still reads."""
    return d + 2 * stem_columns(o)


def stem_smem(d: int, o: int) -> int:
    """Bytes of shared memory of kernel J's block: the two rings and the
    D columns of GW, O floats each."""
    return (2 * stem_ring(d, o) + d) * o * 4


def cost_volume_conv3x3_reference(fL, fR, kernel, D: int, mask_left: bool = True):
    """Golden composition: build the volume, run the 3-D conv (SAME)."""
    return conv3d_plain(concat_cost_volume_reference(fL, fR, D, mask_left), kernel)


def _conv_dh(x, k):
    """3-tap conv over H contracting features: x (N,H,W,F), k (3,F,O)."""
    w = k.permute(2, 1, 0).unsqueeze(-1)  # (O, F, 3, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(1, 0))
    return y.permute(0, 2, 3, 1)


def _shift_w(x, s: int):
    """x shifted so out[..., w, :] = x[..., w+s, :], zero padded.  A shift
    of W or more gives zeros of x's shape (the JAX helper would pad past
    W there, which only the backward's shifts by up to D + 1 reach)."""
    if s == 0:
        return x
    w = x.shape[2]
    if abs(s) >= w:
        return torch.zeros_like(x)
    if s > 0:
        return F.pad(x[:, :, s:, :], (0, 0, 0, s))
    return F.pad(x[:, :, :w + s, :], (0, 0, -s, 0))


def tap_maps(fL, fR, kernel):
    """The left and right tap maps, (N,H,W,9*O) each: the 3-tap
    H-convolutions of fL and fR against the kernel's left and right channel
    halves, tap (dd, dw) in channels [t*O, (t+1)*O), t = 3*(dd+1) + (dw+1),
    not shifted in W.  In float32 (float64 for float64 inputs): bf16 inputs
    are widened first, as the Pallas path does (:512-517)."""
    acc = torch.promote_types(fL.dtype, torch.float32)
    f = fL.shape[-1]
    o = kernel.shape[-1]
    k = kernel.to(acc)
    # (3 dd, 3 dh, 3 dw, F, O) -> (dh, F, (dd, dw, O))
    KL = k[..., :f, :].permute(1, 3, 0, 2, 4).reshape(3, f, 9 * o)
    KR = k[..., f:, :].permute(1, 3, 0, 2, 4).reshape(3, f, 9 * o)
    return _conv_dh(fL.to(acc), KL).contiguous(), _conv_dh(fR.to(acc), KR).contiguous()


def assemble_plain(a, b, D: int, mask_left: bool, dtype):
    """Plain version of kernel J: the exact per-tap assembly
    (``_assemble_jnp``) of the tap maps a, b (N,H,W,9*O) into (N,D,H,W,O),
    summed in the maps' dtype tap by tap, A before B, and cast to ``dtype``."""
    n, h, w, o9 = a.shape
    o = o9 // 9
    d_iota = torch.arange(D, device=a.device).view(D, 1)
    w_iota = torch.arange(w, device=a.device).view(1, w)
    zero = a.new_zeros(())
    out = a.new_zeros((n, D, h, w, o))
    for t, (dd, dw) in enumerate(_TAPS):
        at, bt = a[..., t * o:(t + 1) * o], b[..., t * o:(t + 1) * o]
        dval = (d_iota + dd >= 0) & (d_iota + dd <= D - 1)
        wext = (w_iota + dw >= 0) & (w_iota + dw <= w - 1)
        lmask = dval & (w_iota + dw >= d_iota + dd) if mask_left else dval.expand(D, w)
        out += torch.where(lmask.view(1, D, 1, w, 1), _shift_w(at, dw).unsqueeze(1), zero)
        u = w_iota + dw - (d_iota + dd)
        uval = dval & wext & (u >= 0)
        bg = bt[:, :, u.clamp(0, w - 1), :]  # (n, h, D, W, o)
        out += torch.where(uval.view(1, 1, D, w, 1), bg, zero).permute(0, 2, 1, 3, 4)
    return out.to(dtype)


def cost_volume_conv3x3_kernel(a, b, D: int, mask_left: bool, dtype):
    """Kernel J wrapper: the tap maps a, b (N,H,W,9*O) -> (N,D,H,W,O) in
    ``dtype``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises.  The kernel takes float32 maps, O a
    multiple of 4, and writes bf16 or float32."""
    _build.require_no_grad("fused_costvol", a, b)
    if not config.launches_kernel("fused_costvol", a):
        return assemble_plain(a, b, D, mask_left, dtype)
    _build.require_cuda("fused_costvol", a, b)
    if (a.dtype != torch.float32 or dtype not in _build.DTYPE_CODES or a.dim() != 4
            or b.shape != a.shape or a.shape[-1] % 36 or D < 1
            or stem_smem(D, a.shape[-1] // 9) > STEM_MAX_SMEM):
        raise ValueError(f"fused_costvol takes float32 maps (N,H,W,9*O) of one shape, O a "
                         f"multiple of 4, D >= 1 with its rings in shared memory, and writes "
                         f"bf16 or float32; got {tuple(a.shape)} {a.dtype}, {tuple(b.shape)}, "
                         f"D={D}, out {dtype}")
    n, h, w, o9 = a.shape
    out = torch.empty((n, D, h, w, o9 // 9), dtype=dtype, device=a.device)
    _build.launch("fused_costvol", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                  _build.DTYPE_CODES[dtype], n, h, w, o9 // 9, D, int(mask_left))
    return out


def _place_w(col, left: int, W: int):
    """(n, h, L, o) column -> (n, h, W, o) with out[v] = col[v - left]
    (zero outside); left may be negative."""
    L = col.shape[2]
    if left >= 0:
        seg = col[:, :, :max(0, min(L, W - left))]
    else:
        seg = col[:, :, -left:max(-left, min(L, W - left))]
        left = 0
    return F.pad(seg, (0, 0, left, W - left - seg.shape[2]))


def _stem_bwd(fL, fR, kernel, D: int, mask_left: bool, g):
    """Hand VJP of the fused volume+conv (JAX ``_stem_bwd``): returns
    (dfL, dfR, dkernel) in the inputs' dtypes, accumulated in float32
    (float64 for float64 inputs).

      * left taps: dA[(dd,dw)][w] = sum_{d <= w+dw-dd} g[d, w], a diagonal
        of ONE prefix sum over D (``cumsum``), with single-row corrections
        for the d-range exclusions;
      * right taps: dB[(dd,dw)][v] = sum_d g[d, v+d+dd-dw], a W-shift of ONE
        anti-diagonal sum T[u] = sum_d g[d, u+d] (skew view + one
        reduction), minus single-row terms and, for dw = +1, a flipped
        single-column term (the w-boundary of the assembly)."""
    acc = torch.promote_types(g.dtype, torch.float32)
    f = fL.shape[-1]
    n, h, W = fL.shape[:3]
    o = kernel.shape[-1]
    KL = kernel[..., :f, :].to(acc)
    KR = kernel[..., f:, :].to(acc)
    S = g.sum(dim=1, dtype=acc)                                  # (n,h,W,o)

    # H-shifted input stacks reused by every tap's kernel gradient
    fLp, fRp = (F.pad(t, (0, 0, 0, 0, 1, 1)).to(acc) for t in (fL, fR))
    fLs = torch.stack([fLp[:, kh:kh + h] for kh in range(3)])
    fRs = torch.stack([fRp[:, kh:kh + h] for kh in range(3)])

    gt = g.transpose(1, 2)                                       # (n,h,D,W,o)
    row0 = gt[:, :, 0].to(acc)
    rowN = gt[:, :, D - 1].to(acc)
    colW = gt[:, :, :, W - 1]                                    # (n,h,D,o)

    # ONE anti-diagonal sum: T[u] = sum_d g[d, u+d], u = j - 2
    Wp = W + D + 4
    gp = F.pad(gt, (0, 0, 2, D + 2))
    flat = F.pad(gp.reshape(n, h, D * Wp, o), (0, 0, 0, D))
    T = flat.reshape(n, h, D, Wp + 1, o).sum(dim=2, dtype=acc)   # (n,h,Wp+1,o)

    # ONE prefix sum over D + 5 diagonal extractions: E[e][w] = cum[w+e, w]
    # (0 for w+e < 0, S for w+e > D-1)
    if mask_left:
        cflat = torch.cumsum(gt, dim=2, dtype=acc).reshape(n, h, D * W, o)
        E = {}
        for e in range(-2, 3):
            lo = max(0, -e)
            hi = max(lo, min(W, D - e))
            s0 = (lo + e) * W + lo
            part = cflat[:, :, s0:s0 + (hi - lo - 1) * (W + 1) + 1:W + 1] if hi > lo \
                else cflat.new_zeros((n, h, 0, o))
            E[e] = torch.cat([cflat.new_zeros((n, h, lo, o)), part, S[:, :, hi:W]], dim=2)

    dfL = torch.zeros(fL.shape, dtype=acc, device=g.device)
    dfR = torch.zeros(fR.shape, dtype=acc, device=g.device)
    dKL = torch.zeros(KL.shape, dtype=acc, device=g.device)
    dKR = torch.zeros(KR.shape, dtype=acc, device=g.device)
    w_iota = torch.arange(W, device=g.device).view(1, 1, W, 1)
    zero = torch.zeros((), dtype=acc, device=g.device)

    for i, dd in enumerate((-1, 0, 1)):
        for k, dw in enumerate((-1, 0, 1)):
            # left cotangent map: dA = sum_{d in rows} g[d, w], d <= w + e
            e = dw - dd
            if mask_left:
                dA = E[e]
                if dd == -1:
                    dA = dA - torch.where(w_iota + e >= 0, row0, zero)
                elif dd == 1:
                    dA = torch.where(w_iota + e >= D - 1, S - rowN, dA)
            else:
                dA = S - row0 if dd == -1 else S - rowN if dd == 1 else S
            dC = _shift_w(dA, -dw)                                  # shift_w transpose
            dfL = dfL + _conv_dh(dC, KL[i, :, k].flip(0).transpose(1, 2))
            dKL[i, :, k] += torch.einsum("knhwf,nhwo->kfo", fLs, dC.to(fL.dtype).to(acc))

            # right cotangent map: dB[v] = sum_{d in rows} g[d, v+d+delta]
            # minus the w-boundary term
            delta = dd - dw
            dB = T[:, :, delta + 2:delta + 2 + W]
            if dd == -1:
                dB = dB - _shift_w(row0, delta)
            elif dd == 1:
                dB = dB - _shift_w(rowN, delta + D - 1)
            if dw == 1:
                # the skew counted g[d*, W-1] at d* = W-1-v-delta; the
                # assembly's wext zeroed that column for this tap
                col = colW
                if dd in (-1, 1):
                    col = col.clone()
                    col[:, :, 0 if dd == -1 else D - 1] = 0
                dB = dB - _place_w(col.flip(2), W - D - delta, W).to(acc)
            # dw == -1 hits g[d*, 0] only at (dd=-1, v=0, d*=0), which the
            # d-range exclusion already removed: no correction
            dfR = dfR + _conv_dh(dB, KR[i, :, k].flip(0).transpose(1, 2))
            dKR[i, :, k] += torch.einsum("knhwf,nhwo->kfo", fRs, dB.to(fR.dtype).to(acc))

    dkernel = torch.cat([dKL, dKR], dim=-2).to(kernel.dtype)
    return dfL.to(fL.dtype), dfR.to(fR.dtype), dkernel


class _CostVolumeConv(torch.autograd.Function):
    """Tap maps assembled by kernel J (the plain assembly under "plain"),
    with the hand backward ``_stem_bwd``."""

    @staticmethod
    def forward(ctx, fL, fR, kernel, D, mask_left):
        ctx.save_for_backward(fL, fR, kernel)
        ctx.D, ctx.mask_left = D, mask_left
        a, b = tap_maps(fL, fR, kernel)
        if config.impl["fused_costvol"] == "plain":
            return assemble_plain(a, b, D, mask_left, fL.dtype)
        return cost_volume_conv3x3_kernel(a, b, D, mask_left, fL.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        fL, fR, kernel = ctx.saved_tensors
        return (*_stem_bwd(fL, fR, kernel, ctx.D, ctx.mask_left, g.contiguous()), None, None)


def cost_volume_conv3x3(fL, fR, kernel, D: int, mask_left: bool = True):
    """Fused volume+conv via the tap-map decomposition.

    fL/fR (N,H,W,F); kernel (3,3,3,2F,O) in DHWIO layout; returns
    (N,D,H,W,O) in fL's dtype — equal (up to float association) to
    ``cost_volume_conv3x3_reference``; in bf16 the sums run in float32 and
    round once.  Inside a banded section (``parallel.context.banded``) fL
    and fR are this rank's bands of rows: the tap maps are 3-tap
    convolutions in H, so the op runs on the bands padded by a row of each
    neighbour (``parallel.halo.halo_pad``) and the volume's first and last
    rows are cropped; the result is the band of the whole volume
    (``parallel.context.shard_cost_volume``)."""
    from ..parallel import context
    from ..parallel.halo import halo_pad

    if context.in_band():
        f = fL.shape[-1]
        both = halo_pad(torch.cat([fL, fR], dim=-1), 1, 1, 1)  # one exchange for both views
        out = _CostVolumeConv.apply(both[..., :f], both[..., f:], kernel, D, mask_left)
        out = out[:, :, 1:out.shape[2] - 1]
    else:
        out = _CostVolumeConv.apply(fL, fR, kernel, D, mask_left)
    return context.shard_cost_volume(out)
