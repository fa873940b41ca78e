"""3-D convolutions of PSMNet's regularizer, channels-last, with their gradients.

PyTorch counterpart of ``dsmnet_tpu/ops/conv3d.py`` (with the Pallas
kernels of ``conv3d_pallas.py`` / ``conv3d_s2_pallas.py`` and the custom
VJPs of ``folded.py``).  Three ops; each takes the autograd ``Function``
below for the shapes the JAX package sends to Pallas, and the plain
PyTorch version with plain autograd for the rest:

  * ``conv3d_same`` — 3x3x3 stride 1 SAME, C, Co in {32, 64}, and 128 ->
    128 (GCNet's l31/l32) (``_Conv3dK3``, JAX ``_s1_bwd``
    ``folded.py:120-141``): forward and dx on kernel B
    (``csrc/conv3d_k3.cu``; dx with the flipped, channel-swapped kernel;
    bf16 on the D-walking ring of ``csrc/s1_fwd_ring.cuh``, its work items
    and runs planned by :func:`k3_items` and :func:`k3_run`, 128 -> 128 on
    its kd-split blocks with the partials of :func:`k3_split_partials`),
    dK on kernel F (``csrc/conv3d_dk_k3.cu``; bf16 on the row ring of
    ``csrc/s1_dk_ring.cuh``, its rows and partials planned by
    :func:`dk_k3_rows` and :func:`dk_k3_chunks`).
    The Cout=1 classifier head stays plain, as JAX computes it outside
    Pallas (``folded.py:170-206``).
  * ``conv3d_s2`` — 3x3x3 stride 2 pad 1, even D/H/W, C in {32, 64},
    Co = 64 (``_Conv3dK3S2``, JAX ``_s2f_bwd`` ``folded.py:245-280``):
    forward on kernel C (``csrc/conv3d_k3s2.cu``; bf16 on the D-walking
    ring of ``csrc/s2_ring.cuh``, its runs planned by :func:`s2_fwd_run`);
    dx, the k3s2 transposed
    conv of the cotangent with the forward kernel, on kernel D for C = 32
    and plain for C = 64 (JAX's gate ``s2_dx_pallas_ok``); dK on kernel G
    (``csrc/conv3d_dk_k3s2.cu``; bf16 on the row ring of
    ``csrc/s2_ring.cuh``, its partials planned by :func:`s2_dk_chunks`).
  * ``deconv3d_k3s2`` — ConvTranspose3d k3 s2 p1 op1 on the flax
    (3,3,3,Cout,Cin) kernel, Cin 64 -> Cout 32 (``_Deconv3dK3S2``, JAX
    ``_fdc_bwd`` ``folded.py:347-361``): forward on kernel D
    (``csrc/deconv3d_k3s2.cu``; bf16 on its D-walking ring, its runs
    planned by :func:`deconv_run`), d(input) on kernel C (the stride-2 conv of
    the cotangent), dW on kernel G with the roles swapped.  The 64 -> 64
    deconv is plain both ways, as in JAX.

Every weight gradient comes out of its kernel in float32 and is cast to
the kernel's dtype, as JAX's ``dk.astype(k.dtype)``.  Each op's backward
is also a function of its own (``conv3d_same_vjp``, ``conv3d_s2_vjp``,
``deconv3d_k3s2_vjp``), for a caller that keeps the op's input itself
(the banded convs of ``parallel/halo.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config
from . import _build

__all__ = [
    "conv3d_same", "conv3d_s2", "deconv3d_k3s2",
    "conv3d_k3", "conv3d_k3s2", "deconv3d_k3s2_kernel", "conv3d_dk_k3", "conv3d_s2_dk_k3",
    "conv3d_plain", "conv3d_s2_plain", "deconv3d_k3s2_plain", "conv3d_dk_plain",
    "conv3d_s2_dk_plain", "conv3d_same_vjp", "conv3d_s2_vjp", "deconv3d_k3s2_vjp",
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


def _dk_taps(xp, g, stride: int) -> torch.Tensor:
    """Per-tap weight gradient (JAX ``_dk_pertap``, ``conv3d.py:212``): xp is
    x zero-padded by 1 in D/H/W, tap (kd,kh,kw) pairs g[o] with
    xp[stride * o + (kd,kh,kw)]; (3,3,3,C,Co) in xp's dtype."""
    dg, hg, wg = g.shape[1:4]
    span = lambda k, n: slice(k, k + stride * (n - 1) + 1, stride)
    return torch.stack([
        torch.einsum("ndhwc,ndhwo->co",
                     xp[:, span(kd, dg), span(kh, hg), span(kw, wg)], g)
        for kd in range(3) for kh in range(3) for kw in range(3)
    ]).reshape(3, 3, 3, xp.shape[-1], g.shape[-1])


def conv3d_dk_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient of the stride-1 SAME 3x3x3 conv: x (N,D,H,W,C),
    g (N,D,H,W,Co) -> (3,3,3,C,Co) in float32 (float64 for float64)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return _dk_taps(F.pad(x.to(acc), (0, 0, 1, 1, 1, 1, 1, 1)), g.to(acc), 1)


def conv3d_s2_dk_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient of the stride-2 pad-1 3x3x3 conv: x
    (N,D,H,W,C), g (N,D/2,H/2,W/2,Co) -> (3,3,3,C,Co) in float32 (float64
    for float64).  With x the cotangent of a k3s2 deconv's output and g
    the deconv's input it is the deconv's dW (flax (3,3,3,Cout,Cin))."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return _dk_taps(F.pad(x.to(acc), (0, 0, 1, 1, 1, 1, 1, 1)), g.to(acc), 2)


# ------------------------------------------------------------ launch plans

# Kernel C's bf16 tiles (csrc/conv3d_k3s2.cu): input channels -> (output
# rows, output columns, blocks over the 64 output channels)
S2_FWD_TILES = {32: (4, 32, 1), 64: (4, 32, 2)}
# Kernel G's bf16 row segment (positions) and blocks resident per SM
S2_DK_SEGMENT = 48
S2_DK_BLOCKS_PER_SM = {32: 2, 64: 1}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def s2_fwd_run(n: int, do: int, ho: int, wo: int, c: int, sms: int) -> int:
    """Output D-slices per block of kernel C's bf16 walk.  One block fits an
    SM (227 KB of shared memory); a block of run r stages 2 r + 1 input
    slices and its resident kernel (2.8 slices' bytes at C = 32, 1.4 at
    C = 64), so a launch takes about ceil(blocks / sms) x (2 r + 1 +
    kernel) slice times: the run with the least, the longest on ties."""
    rh, tm, ncob = S2_FWD_TILES[c]
    cols = n * _cdiv(ho, rh) * _cdiv(wo, tm) * ncob
    kernel = 27 * c * 64 / ncob / ((2 * rh + 1) * 2 * (tm + 1) * c)
    cost = lambda r: (_cdiv(cols * _cdiv(do, r), sms) * (2 * r + 1 + kernel), -r)
    return min(range(1, do + 1), key=cost)


def s2_fwd_runs(do: int, run: int) -> list[tuple[int, int]]:
    """The output D-slices [d0, d1) of each run, as kernel C's blocks take them."""
    return [(d0, min(do, d0 + run)) for d0 in range(0, do, run)]


# Kernel B's bf16 ring (csrc/conv3d_k3.cu on csrc/s1_fwd_ring.cuh): output
# rows x columns of a tile; (C, Co) -> output channels per block (the Co
# tile) and blocks resident per SM.  128 -> 128 runs the kd-split blocks.
K3_TILE = (8, 16)
K3_COB = {(32, 32): 32, (32, 64): 64, (64, 32): 32, (64, 64): 32, (128, 128): 64}
K3_BLOCKS_PER_SM = {(32, 32): 2, (32, 64): 1, (64, 32): 1, (64, 64): 1}


def k3_items(n: int, d: int, h: int, w: int) -> int:
    """Work items (n, h tile, w tile, output slice d), d fastest, of kernel
    B's bf16 walk, per Co tile."""
    rh, tm = K3_TILE
    return n * _cdiv(h, rh) * _cdiv(w, tm) * d


def k3_run(items: int, c: int, co: int, sms: int) -> int:
    """Work items per block of kernel B's bf16 walk: contiguous ranges, so
    that the blocks of every Co tile run at once on ``sms`` SMs, each range
    its tiles' runs of output slices.  A block stages its 27 kernel taps
    once, whatever its range, and each run's input slices once, so one
    wave of long ranges stages the least and leaves no tail."""
    ncob = co // K3_COB[c, co]
    return _cdiv(items, max(1, sms * K3_BLOCKS_PER_SM[c, co] // ncob))


def k3_runs(items: int, d: int, per: int) -> list[list[tuple[int, int, int]]]:
    """Each block's runs (tile, d0, d1) of output slices, as kernel B's
    bf16 walk cuts its range of ``per`` items: a run stages the input slices
    max(d0 - 1, 0) .. min(d1, d - 1)."""
    blocks = []
    for lo in range(0, items, per):
        runs, s, hi = [], lo, min(items, lo + per)
        while s < hi:
            tile = s // d
            e = min(hi, (tile + 1) * d)
            runs.append((tile, s - tile * d, s - tile * d + e - s))
            s = e
        blocks.append(runs)
    return blocks


def k3_split_partials(n: int, d: int, h: int, w: int) -> int:
    """Floats of kernel B's 128 -> 128 partials: one f32 output per kd."""
    return 3 * n * d * h * w * 128


# Kernel F's bf16 ring (csrc/conv3d_dk_k3.cu on csrc/s1_dk_ring.cuh): (C, Co)
# -> (segment positions, Co tile, blocks resident per SM)
DK_K3_TILES = {(32, 32): (96, 32, 2), (32, 64): (64, 64, 2), (64, 32): (48, 32, 2),
               (64, 64): (48, 64, 1), (128, 128): (32, 16, 1)}


def dk_k3_rows(n: int, d: int, h: int, w: int, c: int, co: int) -> int:
    """Cotangent rows (n, od, w-segment, oh) that kernel F's bf16 walk sums
    for x (n, d, h, w, c) and a cotangent of co channels."""
    return n * d * _cdiv(w, DK_K3_TILES[c, co][0]) * h


def dk_k3_chunks(rows: int, c: int, co: int, sms: int) -> int:
    """Partials of kernel F in bf16: one per block that runs at once (3 kd
    x Co tiles a chunk), as many as fill ``sms`` SMs, with no empty chunk.
    (Its float32 tiles take one chunk per row, at most ``_build.DK_CHUNKS``.)"""
    _, cob, per_sm = DK_K3_TILES[c, co]
    per = _cdiv(rows, max(1, sms * per_sm // (3 * (co // cob))))
    return _cdiv(rows, per)


# Kernel D's bf16 ring (csrc/deconv3d_k3s2.cu): input rows x columns of a
# block's tile; a block's resident kernel (110.6 KB) costs about as much
# as DECONV_KERNEL_STEPS of its steps (one input slice, 21 KB with the
# halo, in and two output slices, 64 KB, out)
DECONV_TILE = (4, 32)
DECONV_KERNEL_STEPS = 1.3


def deconv_run(n: int, d: int, h: int, w: int, sms: int) -> int:
    """Input D-slices per block of kernel D's bf16 walk, for x (n, d, h, w,
    64).  One block fits an SM; a block of run r takes r steps, stages r + 1
    slices and its resident kernel, so a launch takes about ceil(blocks /
    sms) x (r + 1/4 + DECONV_KERNEL_STEPS) step times: the run with the
    least, the longest on ties."""
    rh, tm = DECONV_TILE
    cols = n * _cdiv(h, rh) * _cdiv(w, tm)
    cost = lambda r: (_cdiv(cols * _cdiv(d, r), sms) * (r + 0.25 + DECONV_KERNEL_STEPS), -r)
    return min(range(1, d + 1), key=cost)


def deconv_runs(d: int, run: int) -> list[tuple[int, int]]:
    """The input D-slices [u0, u1) of each run, as kernel D's blocks take
    them; a run writes output slices 2 u0 .. 2 u1 - 1."""
    return [(u0, min(d, u0 + run)) for u0 in range(0, d, run)]


def s2_dk_rows(n: int, d: int, h: int, w: int) -> int:
    """Cotangent rows (n, od, w-segment, oh) that kernel G's bf16 walk sums
    for x (n, d, h, w, C)."""
    return n * (d // 2) * _cdiv(w // 2, S2_DK_SEGMENT) * (h // 2)


def s2_dk_chunks(rows: int, c: int, sms: int) -> int:
    """Partials of kernel G: one per block that runs at once, 3 kd blocks
    each, as many as fill ``sms`` SMs, with no empty chunk."""
    per = _cdiv(rows, max(1, sms * S2_DK_BLOCKS_PER_SM[c] // 3))
    return _cdiv(rows, per)


# ---------------------------------------------------------- kernel wrappers

def conv3d_k3_ok(x, k) -> bool:
    return (x.dim() == 5 and tuple(k.shape[:3]) == (3, 3, 3) and k.dim() == 5
            and x.shape[-1] == k.shape[3]
            and (tuple(k.shape[3:]) == (128, 128)
                 or (k.shape[3] in (32, 64) and k.shape[4] in (32, 64))))


def conv3d_dk_k3_ok(x, g) -> bool:
    return (x.dim() == 5 and g.dim() == 5 and g.shape[:4] == x.shape[:4]
            and ((x.shape[-1] in (32, 64) and g.shape[-1] in (32, 64))
                 or (x.shape[-1], g.shape[-1]) == (128, 128)))


def conv3d_k3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel B wrapper (stride-1 SAME 3x3x3).  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    _build.require_no_grad("conv3d_k3", x, k)
    if not config.launches_kernel("conv3d", x):
        return conv3d_plain(x, k)
    _build.require_cuda("conv3d_k3", x, k)
    if not conv3d_k3_ok(x, k):
        raise ValueError(f"conv3d_k3 takes C, Co in {{32, 64}} or 128 -> 128; got "
                         f"x {tuple(x.shape)}, k {tuple(k.shape)}")
    n, d, h, w, c = x.shape
    co = k.shape[4]
    y = torch.empty((n, d, h, w, co), dtype=x.dtype, device=x.device)
    ws, per = 0, 0  # the float32 tiles (conv_k3.cuh) take neither
    if x.dtype == torch.bfloat16 and c == 128:
        part = torch.empty((k3_split_partials(n, d, h, w),), dtype=torch.float32,
                           device=x.device)
        ws = part.data_ptr()
    elif x.dtype == torch.bfloat16:
        per = k3_run(k3_items(n, d, h, w), c, co, _build.sm_count(x.device.index))
    _build.launch("conv3d_k3", x.device, x.data_ptr(), k.data_ptr(), y.data_ptr(), ws,
                  _build.DTYPE_CODES[x.dtype], n, d, h, w, c, co, per)
    return y


def conv3d_k3s2_ok(x, k) -> bool:
    return (x.dim() == 5 and k.dim() == 5 and tuple(k.shape[:3]) == (3, 3, 3)
            and x.shape[-1] == k.shape[3] and k.shape[3] in (32, 64) and k.shape[4] == 64
            and all(s % 2 == 0 for s in x.shape[1:4]))


def conv3d_k3s2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel C wrapper (stride-2 pad-1 3x3x3)."""
    _build.require_no_grad("conv3d_k3s2", x, k)
    if not config.launches_kernel("conv3d_s2", x):
        return conv3d_s2_plain(x, k)
    _build.require_cuda("conv3d_k3s2", x, k)
    if not conv3d_k3s2_ok(x, k):
        raise ValueError(f"conv3d_k3s2 takes even D/H/W, C in {{32, 64}}, Co 64; got "
                         f"x {tuple(x.shape)}, k {tuple(k.shape)}")
    n, d, h, w, c = x.shape
    y = torch.empty((n, d // 2, h // 2, w // 2, 64), dtype=x.dtype, device=x.device)
    run = s2_fwd_run(n, d // 2, h // 2, w // 2, c, _build.sm_count(x.device.index))
    _build.launch("conv3d_k3s2", x.device, x.data_ptr(), k.data_ptr(), y.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, d, h, w, c, 64, run)
    return y


def deconv3d_k3s2_ok(x, k) -> bool:
    return (x.dim() == 5 and tuple(k.shape) == (3, 3, 3, 32, 64) and x.shape[-1] == 64)


def deconv3d_k3s2_kernel(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel D wrapper (k3 s2 transposed conv, Cin 64 -> Cout 32)."""
    _build.require_no_grad("deconv3d_k3s2", x, k)
    if not config.launches_kernel("deconv3d", x):
        return deconv3d_k3s2_plain(x, k)
    _build.require_cuda("deconv3d_k3s2", x, k)
    if not deconv3d_k3s2_ok(x, k):
        raise ValueError(f"deconv3d_k3s2 takes x (...,64), k (3,3,3,32,64); got "
                         f"x {tuple(x.shape)}, k {tuple(k.shape)}")
    n, d, h, w, c = x.shape
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, 32), dtype=x.dtype, device=x.device)
    run = deconv_run(n, d, h, w, _build.sm_count(x.device.index))
    _build.launch("deconv3d_k3s2", x.device, x.data_ptr(), k.data_ptr(), y.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, d, h, w, c, 32, run)
    return y


def conv3d_dk_k3(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel F wrapper: dK (3,3,3,C,Co) float32 of the stride-1 SAME conv
    from x (N,D,H,W,C) and the cotangent g (N,D,H,W,Co), C, Co in {32, 64}
    or 128 -> 128."""
    _build.require_no_grad("conv3d_dk_k3", x, g)
    if not config.launches_kernel("conv3d", x):
        return conv3d_dk_plain(x, g)
    _build.require_cuda("conv3d_dk_k3", x, g)
    if not conv3d_dk_k3_ok(x, g):
        raise ValueError(f"conv3d_dk_k3 takes x (N,D,H,W,C), g (N,D,H,W,Co), C, Co in "
                         f"{{32, 64}} or 128 -> 128; got {tuple(x.shape)}, {tuple(g.shape)}")
    n, d, h, w, c = x.shape
    co = g.shape[-1]
    if x.dtype == torch.bfloat16:
        rows = dk_k3_rows(n, d, h, w, c, co)
        chunks = dk_k3_chunks(rows, c, co, _build.sm_count(x.device.index))
    else:
        rows, chunks = n * d * h, None
    return _build.launch_dk("conv3d_dk_k3", x, g, 27, (n, d, h, w, c, co), rows,
                            chunks).reshape(3, 3, 3, c, co)


def conv3d_s2_dk_k3(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel G wrapper: dK (3,3,3,C,64) float32 of the stride-2 pad-1 conv
    from x (N,D,H,W,C), even D/H/W, C in {32, 64}, and the cotangent g
    (N,D/2,H/2,W/2,64); with the roles swapped, the k3s2 deconv's dW."""
    _build.require_no_grad("conv3d_dk_k3s2", x, g)
    if not config.launches_kernel("conv3d_s2", x):
        return conv3d_s2_dk_plain(x, g)
    _build.require_cuda("conv3d_dk_k3s2", x, g)
    if not (x.dim() == 5 and x.shape[-1] in (32, 64) and all(s % 2 == 0 for s in x.shape[1:4])
            and tuple(g.shape) == (x.shape[0], x.shape[1] // 2, x.shape[2] // 2,
                                   x.shape[3] // 2, 64)):
        raise ValueError(f"conv3d_s2_dk_k3 takes x (N,D,H,W,C) with even D/H/W, C in "
                         f"{{32, 64}}, and g (N,D/2,H/2,W/2,64); got {tuple(x.shape)}, "
                         f"{tuple(g.shape)}")
    n, d, h, w, c = x.shape
    rows = s2_dk_rows(n, d, h, w)
    chunks = s2_dk_chunks(rows, c, _build.sm_count(x.device.index))
    return _build.launch_dk("conv3d_dk_k3s2", x, g, 27, (n, d, h, w, c, 64), rows,
                            chunks).reshape(3, 3, 3, c, 64)


# ------------------------------------------------------------------ VJPs

def _k3_route(x, k) -> bool:
    return config.impl["conv3d"] != "plain" and conv3d_k3_ok(x, k)


def _k3s2_route(x, k) -> bool:
    return config.impl["conv3d_s2"] != "plain" and conv3d_k3s2_ok(x, k)


def _deconv_route(x, k) -> bool:
    return config.impl["deconv3d"] != "plain" and deconv3d_k3s2_ok(x, k)


def _plain_vjp(x, k, g, stride: int, transposed: bool, needs):
    """(dx, dk) of the plain convolution (SAME for stride 1; pad 1, and
    output padding 1 when ``transposed``, for stride 2), by the backward
    that autograd of the plain version runs, None where ``needs`` is False."""
    pad = [(s - 1) // 2 for s in k.shape[:3]]
    w = k.permute(4, 3, 0, 1, 2).contiguous()
    dx, dw, _ = torch.ops.aten.convolution_backward(
        _ncdhw(g), _ncdhw(x), w, None, [stride] * 3, pad, [1, 1, 1], transposed,
        [1 if transposed else 0] * 3, 1, [bool(needs[0]), bool(needs[1]), False])
    return (None if dx is None else _ndhwc(dx),
            None if dw is None else dw.permute(2, 3, 4, 1, 0))


def _k3_vjp(x, k, g, needs):
    """Kernel B (dx, with the flipped, channel-swapped kernel) and F (dK)."""
    dx = conv3d_k3(g, k.flip((0, 1, 2)).transpose(3, 4).contiguous()) if needs[0] else None
    dk = conv3d_dk_k3(x, g).to(k.dtype) if needs[1] else None
    return dx, dk


def _k3s2_vjp(x, k, g, needs):
    """dx, the k3s2 transposed conv of the cotangent with the forward kernel
    read as (3,3,3,Cout=C,Cin=64): kernel D for C = 32, plain for C = 64;
    dK on kernel G."""
    dx = dk = None
    if needs[0]:
        dx = deconv3d_k3s2_kernel(g, k) if deconv3d_k3s2_ok(g, k) else deconv3d_k3s2_plain(g, k)
    if needs[1]:
        dk = conv3d_s2_dk_k3(x, g).to(k.dtype)
    return dx, dk


def _deconv_vjp(x, k, g, needs):
    """Kernel C (d(input)) and G with the roles swapped (dW)."""
    dx = conv3d_k3s2(g, k) if needs[0] else None
    dk = conv3d_s2_dk_k3(g, x).to(k.dtype) if needs[1] else None
    return dx, dk


def conv3d_same_vjp(x, k, g, needs):
    """(dx, dk) of ``conv3d_same`` at (x, k) for the cotangent g, None where
    ``needs`` is False, on the kernels its forward takes (B, F) or the
    plain backward: for a caller that keeps x itself (the banded convs of
    ``parallel/halo.py``)."""
    g = g.contiguous()
    return _k3_vjp(x, k, g, needs) if _k3_route(x, k) else _plain_vjp(x, k, g, 1, False, needs)


def conv3d_s2_vjp(x, k, g, needs):
    """(dx, dk) of ``conv3d_s2``, as :func:`conv3d_same_vjp` (D, G)."""
    g = g.contiguous()
    return _k3s2_vjp(x, k, g, needs) if _k3s2_route(x, k) \
        else _plain_vjp(x, k, g, 2, False, needs)


def deconv3d_k3s2_vjp(x, k, g, needs):
    """(dx, dk) of ``deconv3d_k3s2``, as :func:`conv3d_same_vjp` (C, G)."""
    g = g.contiguous()
    return _deconv_vjp(x, k, g, needs) if _deconv_route(x, k) \
        else _plain_vjp(x, k, g, 2, True, needs)


# ------------------------------------------------------ autograd Functions

class _Conv3dK3(torch.autograd.Function):
    """Kernel B forward; B (dx) and F (dK) backward."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return conv3d_k3(x, k)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        return _k3_vjp(x, k, g.contiguous(), ctx.needs_input_grad)


class _Conv3dK3S2(torch.autograd.Function):
    """Kernel C forward; D (dx, C = 32) or the plain deconv (C = 64) and
    G (dK) backward."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return conv3d_k3s2(x, k)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        return _k3s2_vjp(x, k, g.contiguous(), ctx.needs_input_grad)


class _Deconv3dK3S2(torch.autograd.Function):
    """Kernel D forward; C (d(input)) and G with the roles swapped (dW) backward."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        return deconv3d_k3s2_kernel(x, k)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        return _deconv_vjp(x, k, g.contiguous(), ctx.needs_input_grad)


# --------------------------------------------------------------------- ops

def conv3d_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3-D conv, x (N,D,H,W,Ci), k (kd,kh,kw,Ci,Co), odd dims."""
    if _k3_route(x, k):
        return _Conv3dK3.apply(x.contiguous(), k.contiguous())
    return conv3d_plain(x, k)


def conv3d_s2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-2 SAME(p=1) 3x3x3 conv; x (N,D,H,W,Ci) with even D/H/W."""
    if _k3s2_route(x, k):
        return _Conv3dK3S2.apply(x.contiguous(), k.contiguous())
    return conv3d_s2_plain(x, k)


def deconv3d_k3s2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact-2x transposed 3-D conv (k=3, s=2, torch geometry p=1 op=1);
    x (N,D,H,W,Ci), k (3,3,3,Co,Ci) — the flax transpose_kernel layout."""
    if _deconv_route(x, k):
        return _Deconv3dK3S2.apply(x.contiguous(), k.contiguous())
    return deconv3d_k3s2_plain(x, k)
