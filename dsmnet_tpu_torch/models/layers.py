"""Building blocks of the port's models, channels-last.

PyTorch counterpart of ``dsmnet_tpu/models/layers.py``.  Parameters keep
the flax names and layouts (``Conv_0.kernel`` in HWIO / DHWIO,
``BatchNorm_0.scale`` / ``bias`` with buffers ``mean`` / ``var``), so that a
flax variable tree maps onto ``named_parameters`` / ``named_buffers``
path for path (``interop.py``).  Initializers follow the reference
(``conv_kernel_init``, ``torch_fanin_uniform``) and draw from an explicit
``torch.Generator``.

Compute dtype: inside ``compute_dtype(torch.bfloat16)`` the convolutions,
their biases and BN normalization run in bf16 while parameters and BN
statistics stay float32, as in the JAX package (``layers.py:97-112``).
In train mode LeanBN backpropagates through its batch statistics without an f32 copy
of the activation (``_Moments``).

Under a spatial sharding context, inside a model's banded section
(``parallel.context.banded``), ``ConvBN`` and ``DeconvBN`` run their 3-D
convs on the band through the halo-exchanging wrappers of
``parallel/halo.py``, and LeanBN's moments reduce over the whole mesh;
outside it (the 2-D towers, which every ``model`` rank runs on the same
whole images) over the data group only.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.conv2d import conv2d_same
from ..ops.conv3d import conv3d_s2, conv3d_same, deconv3d_k3s2
from ..parallel import context as sharding
from ..parallel.halo import banded_conv3d_s2, banded_conv3d_same, banded_deconv3d_k3s2

__all__ = [
    "compute_dtype", "default_dtype", "conv_kernel_init", "scaled_conv_kernel_init",
    "torch_fanin_uniform", "fanin_uniform", "Kernel", "LeanBN", "ConvBN", "DeconvBN",
    "ResBlockPSM", "ResBlockGC", "ResStackGC", "siamese", "crop_add", "crop_cat",
    "reset_parameters", "calibrate_batch_stats", "remat",
]

_compute_dtype = contextvars.ContextVar("dsmnet_torch_compute_dtype", default=None)
# set while torch.utils.checkpoint recomputes a segment in the backward
_recomputing = contextvars.ContextVar("dsmnet_torch_recomputing", default=False)


@contextlib.contextmanager
def compute_dtype(dtype):
    """Run convs / BN of layers called inside the context in ``dtype``."""
    token = _compute_dtype.set(dtype)
    try:
        yield
    finally:
        _compute_dtype.reset(token)


def default_dtype():
    return _compute_dtype.get()


@contextlib.contextmanager
def _recompute(dtype, ctx):
    token, dtoken = _recomputing.set(True), _compute_dtype.set(dtype)
    try:
        with sharding.activate(ctx):
            yield
    finally:
        _compute_dtype.reset(dtoken)
        _recomputing.reset(token)


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward instead
    of kept (``torch.utils.checkpoint``, non-reentrant), as flax's
    ``nn.remat``.  The recomputation runs in the compute dtype and under the
    sharding context of the forward, its banded section included (the
    backward may run on another thread), so that it exchanges the same
    halos and reduces over the same groups, and, as the flax recomputation
    mutates nothing, leaves the BN running statistics alone."""
    dt, ctx = default_dtype(), sharding.current()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute(dt, ctx)))


def conv_kernel_init(shape, generator: torch.Generator) -> torch.Tensor:
    """N(0, sqrt(2/n)), n = prod(kernel) * out (flax kernel (*k, in, out))."""
    n = float(math.prod(shape[:-2]) * shape[-1])
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / n)


def _scaled_kernel(scale: float, shape, generator: torch.Generator) -> torch.Tensor:
    return conv_kernel_init(shape, generator) * scale


def scaled_conv_kernel_init(scale: float) -> Callable:
    """``conv_kernel_init`` times ``scale`` (DispNet's 0.1-scaled heads,
    ``layers.py:58``)."""
    return functools.partial(_scaled_kernel, scale)


def _uniform(bound: float, shape, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def fanin_uniform(fan_in: float) -> Callable:
    """U(-s, s), s = 1/sqrt(fan_in): the JAX package's conv biases and
    transposed-conv kernels (``_fanin_uniform_bias``, ``layers.py:75-87``)."""
    return functools.partial(_uniform, 1.0 / math.sqrt(fan_in))


def torch_fanin_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """U(-s, s), s = 1/sqrt(prod(shape[:-2]) * shape[-2]) — for the flax
    transpose kernel (*k, out, in) that fan counts the OUTPUT channels,
    as in the JAX package."""
    s = 1.0 / math.sqrt(float(math.prod(shape[:-2]) * shape[-2]))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * s


class Kernel(nn.Module):
    """Holder of one conv kernel parameter named ``kernel`` (flax ``Conv_0``
    or ``ConvTranspose_0``) and, given ``bias_features``, of a ``bias`` over
    that many output channels, drawn from ``fanin_uniform(bias_fan_in)``."""

    def __init__(self, shape: Sequence[int], init: Callable = conv_kernel_init,
                 bias_features: int | None = None, bias_fan_in: float = 1.0):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(tuple(shape)))
        self._init = init
        if bias_features is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.empty(bias_features))
            self._bias_init = fanin_uniform(bias_fan_in)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.kernel.copy_(self._init(tuple(self.kernel.shape), generator))
            if self.bias is not None:
                self.bias.copy_(self._bias_init(tuple(self.bias.shape), generator))

    def cast(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(x, kernel) in the compute dtype (or in x's dtype outside a context)."""
        dt = default_dtype() or x.dtype
        return x.to(dt), self.kernel.to(dt)

    def add_bias(self, y: torch.Tensor) -> torch.Tensor:
        """y plus the bias in y's dtype (the compute dtype), if there is one."""
        return y if self.bias is None else y + self.bias.to(y.dtype)


class _Moments(torch.autograd.Function):
    """(E[x], E[x^2]) over every axis but the last, accumulated in ``acc``,
    and over the ranks of ``group`` (``context.reduce_group``: the data
    axis, or the whole mesh for a banded tensor; each rank's moments of its
    shard, of M elements a channel on every rank, averaged in ``acc``), as
    XLA makes JAX's moments of a sharded batch global.

    The backward, dx = (g_mean + 2 x g_sq) / M, runs in x's dtype: autograd
    of ``x.mean(dtype=float32)`` would build the broadcast gradient as a
    float32 activation-sized tensor and cast it back.  This is the
    gradient JAX's ``jnp.mean(x, dtype=f32)`` transposes to (a bf16
    broadcast of the per-channel cotangent).  Over a group, g_mean and g_sq
    are first summed over the ranks (every rank's loss reads the global
    moments) and M is the global count: SyncBN's rule."""

    @staticmethod
    def forward(ctx, x, acc, group):
        ctx.save_for_backward(x)
        ctx.group = group
        axes = tuple(range(x.dim() - 1))
        mean, sq = x.mean(axes, dtype=acc), (x * x).mean(axes, dtype=acc)
        if group is None:
            return mean, sq
        both = sharding.all_reduce_sum(torch.stack([mean, sq]), group, "bn_moments")
        both /= dist.get_world_size(group)
        return both[0].clone(), both[1].clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_mean, g_sq):
        x, = ctx.saved_tensors
        m = x.numel() // x.shape[-1]
        if ctx.group is not None:
            both = sharding.all_reduce_sum(torch.stack([g_mean, g_sq]), ctx.group,
                                           "bn_moments_grad")
            g_mean, g_sq = both[0], both[1]
            m *= dist.get_world_size(ctx.group)
        return torch.addcmul((g_mean / m).to(x.dtype), x, (2 * g_sq / m).to(x.dtype)), None, None


class LeanBN(nn.Module):
    """BatchNorm with accumulate-dtype statistics and input-dtype math
    (``layers.py:115-162``): fast variance E[x^2]-E[x]^2, biased running
    variance, running = momentum * running + (1 - momentum) * batch with
    momentum 0.9, statistics in float32 (float64 for a float64 input),
    and normalization as x * inv + off with inv/off cast to x's dtype.
    In train mode the batch statistics carry the gradient; the running
    statistics update without one, and not again when :func:`remat`
    recomputes the layer in the backward.  Under a sharding context the
    batch statistics are those of the global batch (``_Moments``), so the
    running statistics agree on every rank."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, sq = _Moments.apply(x, torch.promote_types(x.dtype, torch.float32),
                                      sharding.reduce_group())
            var = sq - mean * mean
            if not _recomputing.get():
                self._update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        rs = torch.rsqrt(var + self.epsilon)
        inv = (rs * self.scale).to(x.dtype)
        off = (self.bias - mean * self.scale * rs).to(x.dtype)
        return x * inv + off

    @torch.no_grad()
    def _update_running(self, mean, var):
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class ConvBN(nn.Module):
    """Conv (2-D or 3-D by ``dims``) + optional bias + optional LeanBN +
    optional ReLU.

    Routing follows ``layers.py:498-518``: 3x3 stride-1 SAME 2-D convs go to
    ``conv2d_same``, stride-1 SAME undilated 3-D convs to ``conv3d_same``,
    3x3x3 stride-2 pad-1 3-D convs on even D/H/W to ``conv3d_s2``; the rest
    (strided or dilated 2-D convs, 1x1 convs) run as plain convolutions.
    Inside a banded section a 3-D conv runs on the band through
    ``banded_conv3d_same`` or ``banded_conv3d_s2`` (any other 3-D conv
    raises there).
    ``padding=None`` is torch's (k-1)//2; PSMNet passes padding=dilation,
    so its 1x1 SPP branch convs pad by 1.  ``use_bias`` adds ``Conv_0.bias``
    after the conv; it defaults to False, where the JAX default is True
    (``layers.py:473``), so GCNet and DispNet pass it.  ``kernel_scale``
    scales the kernel's init (DispNet's disparity heads).
    """

    def __init__(self, cin: int, features: int, kernel, stride=1, dims: int = 2,
                 bn: bool = False, relu: bool = True, dilation=1, padding=None,
                 use_bias: bool = False, kernel_scale: float = 1.0):
        super().__init__()
        self.dims = dims
        self.k = _tup(kernel, dims)
        self.s = _tup(stride, dims)
        self.dil = _tup(dilation, dims)
        self.pad = tuple((kk - 1) // 2 for kk in self.k) if padding is None \
            else _tup(padding, dims)
        self.relu = relu
        fan_in = math.prod(self.k) * cin
        init = conv_kernel_init if kernel_scale == 1.0 else scaled_conv_kernel_init(kernel_scale)
        self.Conv_0 = Kernel((*self.k, cin, features), init,
                             features if use_bias else None, fan_in)
        self.BatchNorm_0 = LeanBN(features) if bn else None
        same = self.pad == tuple((kk - 1) // 2 for kk in self.k)
        undilated = all(d == 1 for d in self.dil)
        self.fast3d = dims == 3 and all(s == 1 for s in self.s) and undilated and same
        self.fast3d_s2 = (dims == 3 and self.k == (3, 3, 3) and self.s == (2, 2, 2)
                          and undilated and self.pad == (1, 1, 1))
        self.fast2d = (dims == 2 and self.k == (3, 3) and self.s == (1, 1) and undilated
                       and self.pad == (1, 1))

    def _conv(self, x, kern):
        if self.dims == 3 and sharding.in_band():
            if self.fast3d:
                return banded_conv3d_same(x, kern)
            if self.fast3d_s2:
                return banded_conv3d_s2(x, kern)
            raise NotImplementedError(f"a banded 3-D conv takes stride 1 SAME or 3x3x3 "
                                      f"stride 2 pad 1; got k {self.k}, stride {self.s}, "
                                      f"pad {self.pad}, dilation {self.dil}")
        return self._conv_whole(x, kern)

    def _conv_whole(self, x, kern):
        if self.fast3d:
            return conv3d_same(x, kern)
        if self.fast3d_s2 and all(d % 2 == 0 for d in x.shape[1:4]):
            return conv3d_s2(x, kern)
        if self.fast2d:
            return conv2d_same(x, kern)
        # a contiguous weight: at Cout = 1 the CPU conv's backward refuses a view
        if self.dims == 2:
            y = F.conv2d(x.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1).contiguous(),
                         stride=self.s, padding=self.pad, dilation=self.dil)
            return y.permute(0, 2, 3, 1)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), kern.permute(4, 3, 0, 1, 2).contiguous(),
                     stride=self.s, padding=self.pad, dilation=self.dil)
        return y.permute(0, 2, 3, 4, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0.add_bias(self._conv(*self.Conv_0.cast(x)))
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        if self.relu:
            x = F.relu(x)
        return x


class ResBlockPSM(nn.Module):
    """PSMNet BasicBlock (``layers.py:629-653``): convbn+relu, convbn,
    residual add (1x1 convbn downsample when the shape changes), no final
    ReLU; the 3x3 convs pad by their dilation."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, planes, 3, stride, bn=True, relu=True,
                               dilation=dilation, padding=dilation)
        self.ConvBN_1 = ConvBN(planes, planes, 3, 1, bn=True, relu=False,
                               dilation=dilation, padding=dilation)
        self.ConvBN_2 = ConvBN(cin, planes, 1, stride, bn=True, relu=False) \
            if stride != 1 or cin != planes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBN_1(self.ConvBN_0(x))
        residual = self.ConvBN_2(x) if self.ConvBN_2 is not None else x
        return y + residual


class DeconvBN(nn.Module):
    """Transposed conv + bias + optional LeanBN + optional ReLU, with the
    torch geometry p = (k-1)//2, op = s - (k - 2p): an exact stride-x
    upsample (``layers.py:554-607``; every caller keeps JAX's
    ``use_bias=True``).  ``ConvTranspose_0`` holds the flax (k..., Cout,
    Cin) kernel and the bias, both drawn U(-s, s), s = 1/sqrt(prod(k) *
    Cin).  The 3-D k3 s2 deconv goes to
    ``deconv3d_k3s2`` (on a band inside a banded section,
    ``banded_deconv3d_k3s2``); every other shape (DispNet's 2-D k4 s2) runs
    as a plain transposed convolution."""

    def __init__(self, cin: int, features: int, kernel, stride=2, dims: int = 2,
                 bn: bool = False, relu: bool = True):
        super().__init__()
        self.dims = dims
        k, self.s = _tup(kernel, dims), _tup(stride, dims)
        self.pad = tuple((kk - 1) // 2 for kk in k)
        self.out_pad = tuple(ss - (kk - 2 * p) for kk, ss, p in zip(k, self.s, self.pad))
        fan_in = math.prod(k) * cin
        self.ConvTranspose_0 = Kernel((*k, features, cin), fanin_uniform(fan_in), features,
                                      fan_in)
        self.BatchNorm_0 = LeanBN(features) if bn else None
        self.relu = relu
        self.k3s2 = dims == 3 and k == (3, 3, 3) and self.s == (2, 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, kern = self.ConvTranspose_0.cast(x)
        if self.k3s2:
            y = banded_deconv3d_k3s2(x, kern) if sharding.in_band() else deconv3d_k3s2(x, kern)
        elif self.dims == 3 and sharding.in_band():
            raise NotImplementedError(f"a banded 3-D transposed conv takes k3 s2; got "
                                      f"k {tuple(kern.shape[:3])}, stride {self.s}")
        else:
            d = self.dims
            fn = F.conv_transpose2d if d == 2 else F.conv_transpose3d
            # (k..., Cout, Cin) -> torch's (Cin, Cout, k...), no flip
            y = fn(x.movedim(-1, 1), kern.permute(d + 1, d, *range(d)), stride=self.s,
                   padding=self.pad, output_padding=self.out_pad).movedim(1, -1)
        y = self.ConvTranspose_0.add_bias(y)
        if self.BatchNorm_0 is not None:
            y = self.BatchNorm_0(y)
        return F.relu(y) if self.relu else y


class ResBlockGC(nn.Module):
    """GCNet-family BasicBlock (``layers.py:610-626``): two 3x3 conv+BN
    without bias, ReLU after the first and after the residual add (1x1
    conv+BN downsample when the shape changes)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, planes, 3, stride, bn=True, relu=True)
        self.ConvBN_1 = ConvBN(planes, planes, 3, 1, bn=True, relu=False)
        self.ConvBN_2 = ConvBN(cin, planes, 1, stride, bn=True, relu=False) \
            if stride != 1 or cin != planes else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ConvBN_1(self.ConvBN_0(x))
        return F.relu(y + (self.ConvBN_2(x) if self.ConvBN_2 is not None else x))


class ResStackGC(nn.Module):
    """Stack of GCNet residual blocks of ``planes`` channels, stride 1,
    ``ResBlockGC_0`` .. ``_{blocks-1}`` (JAX ``res_stack_gc``,
    ``layers.py:656-668``)."""

    def __init__(self, planes: int, blocks: int):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            self.add_module(f"ResBlockGC_{i}", ResBlockGC(planes, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.blocks):
            x = getattr(self, f"ResBlockGC_{i}")(x)
        return x


def siamese(tower, imL: torch.Tensor, imR: torch.Tensor):
    """Run a weight-shared tower over both views as ONE batch-2N pass
    (``layers.py:671-684``); in train mode BN statistics pool over both views."""
    n = imL.shape[0]
    f = tower(torch.cat([imL, imR], dim=0))
    return f[:n], f[n:]


def crop_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Crop two channels-last operands to their common spatial size and add."""
    sl = (slice(None),) + tuple(slice(0, min(a.shape[i], b.shape[i]))
                                for i in range(1, a.dim() - 1))
    return a[sl] + b[sl]


def crop_cat(*xs: torch.Tensor) -> torch.Tensor:
    """Crop channels-last operands to their common spatial size and
    concatenate them on channels (``layers.py:687-696``)."""
    sl = (slice(None),) + tuple(slice(0, min(x.shape[i] for x in xs))
                                for i in range(1, xs[0].dim() - 1))
    return torch.cat([x[sl] for x in xs], dim=-1)


def reset_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` from ``generator``, in module order."""
    for m in model.modules():
        if isinstance(m, (Kernel, LeanBN)):
            m.reset_parameters(generator)
    return model


@torch.no_grad()
def calibrate_batch_stats(model: nn.Module, *inputs) -> None:
    """Set every LeanBN's running statistics to the batch statistics of one
    train-mode forward over ``inputs`` (momentum 0 for that pass), then
    return the model to eval mode."""
    bns = [m for m in model.modules() if isinstance(m, LeanBN)]
    saved = [bn.momentum for bn in bns]
    model.train()
    try:
        for bn in bns:
            bn.momentum = 0.0
        model(*inputs)
    finally:
        for bn, m in zip(bns, saved):
            bn.momentum = m
        model.eval()
