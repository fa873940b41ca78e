"""Gradients of the PyTorch port's ops (dsmnet_tpu_torch.ops) against the JAX package.

Every case feeds the same numpy inputs, made from a seed, to both sides
on the CPU:

  * dx and dK of each conv op through the port's autograd ``Function``
    (whose backward routes every role to a kernel wrapper, which takes its
    plain version for a CPU tensor) against ``jax.vjp`` of the JAX op, in
    float64 to rtol = atol = 1e-9: both compute the same sums up to float
    association.  The JAX 3-D ops' custom VJPs accumulate dK with
    ``preferred_element_type=float32`` (``conv3d.py:229,411``) even under
    x64, so their dK is held at 1e-5 and, to 1e-9, dK is held to
    ``jax.vjp`` of the plain lax convolution the op computes;
  * each weight-gradient plain version against the Pallas dK kernel it
    stands in for, run in interpret mode, in float32 to rtol = atol = 1e-4
    (the shapes of tests/test_ops.py; the sums run over a few hundred
    positions of N(0, 1) products, so float32 association moves them by
    ~1e-5);
  * the fused stem's hand backward against the JAX ``_stem_bwd`` and
    exact autodiff of the JAX tap-map decomposition, float64;
  * the routing of the 128 -> 128 dK to kernel F's wrapper, and the
    backward of the Cout = 1 3x3 conv against ``jax.vjp``, float64;
  * the graph rules: each op's output carries its ``Function``, and a
    kernel wrapper handed an operand that requires grad raises; a
    weight-gradient wrapper forced to its kernel refuses a CPU tensor;
  * ``torch_jax_dots`` (the float64 convolutions of the heavier JAX
    references lowered as matrix products) against XLA's convolution, the
    forward and both VJP operands, float64 to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import torch_jax_dots

from dsmnet_tpu.ops import conv2d as j_conv2d
from dsmnet_tpu.ops import conv3d as j_conv3d
from dsmnet_tpu.ops import fused_costvol as j_fused
from dsmnet_tpu_torch import config
from dsmnet_tpu_torch import ops as t_ops
from dsmnet_tpu_torch.ops import _build
from dsmnet_tpu_torch.ops import conv2d as t_conv2d
from dsmnet_tpu_torch.ops import conv3d as t_conv3d
from dsmnet_tpu_torch.ops import corr as t_corr
from dsmnet_tpu_torch.ops import cost_volume as t_cost_volume
from dsmnet_tpu_torch.ops import fused_costvol as t_fused


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rand(rng, *shape, scale=1.0):
    return rng.randn(*shape) * scale


def _lax_conv3d_same(x, k):
    return j_conv3d._conv(x, k, [(1, 1)] * 3)


# op name -> (JAX op, the lax convolution it computes, port op, x shape,
# kernel shape, port Function name)
VJP_CASES = {
    "conv2d_same_32to32": (j_conv2d.conv2d_same, j_conv2d._conv, t_ops.conv2d_same,
                           (2, 6, 10, 32), (3, 3, 32, 32), "_Conv2dK3"),
    "conv3d_same_32to32": (j_conv3d.conv3d_same, _lax_conv3d_same, t_ops.conv3d_same,
                           (1, 4, 6, 8, 32), (3, 3, 3, 32, 32), "_Conv3dK3"),
    "conv3d_same_64to64": (j_conv3d.conv3d_same, _lax_conv3d_same, t_ops.conv3d_same,
                           (1, 3, 5, 6, 64), (3, 3, 3, 64, 64), "_Conv3dK3"),
    "conv3d_same_32to64": (j_conv3d.conv3d_same, _lax_conv3d_same, t_ops.conv3d_same,
                           (1, 3, 4, 5, 32), (3, 3, 3, 32, 64), "_Conv3dK3"),
    # GCNet's l31/l32: forward and dx on kernel B, dK on kernel F
    "conv3d_same_128to128": (j_conv3d.conv3d_same, _lax_conv3d_same, t_ops.conv3d_same,
                             (1, 2, 3, 4, 128), (3, 3, 3, 128, 128), "_Conv3dK3"),
    "conv3d_s2_32to64": (j_conv3d.conv3d_s2, j_conv3d._conv_s2_native, t_ops.conv3d_s2,
                         (1, 4, 6, 8, 32), (3, 3, 3, 32, 64), "_Conv3dK3S2"),
    "conv3d_s2_64to64": (j_conv3d.conv3d_s2, j_conv3d._conv_s2_native, t_ops.conv3d_s2,
                         (2, 4, 4, 6, 64), (3, 3, 3, 64, 64), "_Conv3dK3S2"),
    "deconv3d_64to32": (j_conv3d.deconv3d_k3s2, j_conv3d._deconv_native, t_ops.deconv3d_k3s2,
                        (1, 2, 3, 5, 64), (3, 3, 3, 32, 64), "_Deconv3dK3S2"),
    "deconv3d_64to64_plain": (j_conv3d.deconv3d_k3s2, j_conv3d._deconv_native,
                              t_ops.deconv3d_k3s2, (1, 2, 3, 5, 64), (3, 3, 3, 64, 64), None),
}


@pytest.mark.parametrize("name", sorted(VJP_CASES))
def test_op_vjp_matches_jax_f64(name, rng):
    j_op, j_lax, t_op, xs, ks, fn_name = VJP_CASES[name]
    x = _rand(rng, *xs)
    k = _rand(rng, *ks, scale=0.1)
    with jax.enable_x64():
        y, vjp = jax.vjp(j_op, jnp.asarray(x), jnp.asarray(k))
        g = _rand(rng, *y.shape)
        ref_dx, op_dk = (np.asarray(a) for a in vjp(jnp.asarray(g)))
        ref_dk = np.asarray(jax.vjp(j_lax, jnp.asarray(x), jnp.asarray(k))[1](
            jnp.asarray(g))[1])
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    ty = t_op(tx, tk)
    # the op is either its kernel Function or plain autograd, never detached
    assert ty.grad_fn is not None
    if fn_name is not None:
        assert type(ty.grad_fn).__name__ == f"{fn_name}Backward", type(ty.grad_fn).__name__
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), ref_dx, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tk.grad.numpy(), ref_dk, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tk.grad.numpy(), op_dk, rtol=1e-5, atol=1e-5)


def _pallas_conv2d_dk(x, g):
    from dsmnet_tpu.ops.conv2d_pallas import conv2d_dk_pallas

    return conv2d_dk_pallas(x, g, interpret=True)


def _pallas_conv3d_dk(x, g):
    from dsmnet_tpu.ops.conv3d_pallas import conv3d_dk_pallas

    return conv3d_dk_pallas(x, g, interpret=True)


def _pallas_conv3d_s2_dk(x, g):
    from dsmnet_tpu.ops.conv3d_s2_pallas import conv3d_s2_dk_pallas

    return conv3d_s2_dk_pallas(x, g, interpret=True)


def _pallas_deconv_dw(gy, x):
    """The deconv's dW as the JAX package computes it: the stride-2 dK
    kernel with the roles swapped (tests/test_ops.py:812)."""
    from dsmnet_tpu.ops.conv3d_s2_pallas import conv3d_s2_dk_pallas_padded
    from dsmnet_tpu.ops.folded import _pad_dh, fold

    cout, cin = gy.shape[-1], x.shape[-1]
    return conv3d_s2_dk_pallas_padded(_pad_dh(fold(gy)), fold(x), (3, 3, 3, cout, cin),
                                      gy.shape[3], interpret=True)


# name -> (port dK wrapper, Pallas dK, x shape, cotangent shape): the shapes
# of tests/test_ops.py:515,630,792,913 that the port's kernels take
DK_CASES = {
    "conv2d_dk_2x8x64_32to32": (t_conv2d.conv2d_dk_k3, _pallas_conv2d_dk, (2, 8, 64, 32),
                                (2, 8, 64, 32)),
    "conv3d_dk_1x6x8x16_32to32": (t_conv3d.conv3d_dk_k3, _pallas_conv3d_dk, (1, 6, 8, 16, 32),
                                  (1, 6, 8, 16, 32)),
    "conv3d_dk_2x4x8x8_64to32": (t_conv3d.conv3d_dk_k3, _pallas_conv3d_dk, (2, 4, 8, 8, 64),
                                 (2, 4, 8, 8, 32)),
    # GCNet's l31/l32 (W = 8 passes the Pallas gate _s1_pallas_ok at 128)
    "conv3d_dk_1x4x8x8_128to128": (t_conv3d.conv3d_dk_k3, _pallas_conv3d_dk, (1, 4, 8, 8, 128),
                                   (1, 4, 8, 8, 128)),
    "conv3d_s2_dk_1x4x8x16_32to64": (t_conv3d.conv3d_s2_dk_k3, _pallas_conv3d_s2_dk,
                                     (1, 4, 8, 16, 32), (1, 2, 4, 8, 64)),
    "deconv_dw_1x3x4x32_64to32": (t_conv3d.conv3d_s2_dk_k3, _pallas_deconv_dw,
                                  (1, 6, 8, 64, 32), (1, 3, 4, 32, 64)),
}


@pytest.mark.parametrize("name", sorted(DK_CASES))
def test_dk_plain_matches_pallas_interpret_f32(name, rng):
    wrapper, pallas, xs, gs = DK_CASES[name]
    x = _rand(rng, *xs).astype(np.float32)
    g = _rand(rng, *gs).astype(np.float32)
    ref = np.asarray(pallas(jnp.asarray(x), jnp.asarray(g)))
    out = wrapper(torch.from_numpy(x), torch.from_numpy(g))
    assert out.dtype == torch.float32 and out.shape == ref.shape, (out.dtype, out.shape,
                                                                   ref.shape)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mask_left", [True, False])
@pytest.mark.parametrize("geom", [(1, 6, 12, 4, 5, 6), (2, 5, 10, 3, 4, 5), (1, 4, 5, 3, 4, 7)])
def test_stem_backward_matches_jax_f64(geom, mask_left, rng):
    """The fused stem's Function backward in float64, to 1e-9, against
    ``jax.vjp`` of the JAX raw tap-map decomposition (exact autodiff); and,
    for D < W, against the JAX hand VJP ``_stem_bwd`` itself, which
    accumulates in float32 under x64 (``fused_costvol.py:168-170``), to
    1e-5.  For D >= W ``_stem_bwd`` raises (its W-shift by up to D + 1
    pads past W); the port's is total there."""
    n, h, w, f, o, D = geom
    fL, fR = _rand(rng, n, h, w, f), _rand(rng, n, h, w, f)
    k = _rand(rng, 3, 3, 3, 2 * f, o, scale=0.1)
    g = _rand(rng, n, D, h, w, o)
    with jax.enable_x64():
        args = [jnp.asarray(a) for a in (fL, fR, k, g)]
        raw = lambda a, b, c: j_fused.cost_volume_conv3x3_raw(a, b, c, D, mask_left)
        # jitted: one compile instead of an eager dispatch per op
        ref = [np.asarray(a) for a in jax.jit(
            lambda a, b, c, ct: jax.vjp(raw, a, b, c)[1](ct))(*args)]
        hand = [np.asarray(a) for a in jax.jit(
            lambda a, b, c, ct: j_fused._stem_bwd(a, b, c, D, mask_left, ct))(*args)] \
            if D < w else None
    tL, tR, tk = (torch.from_numpy(a).requires_grad_() for a in (fL, fR, k))
    out = t_ops.cost_volume_conv3x3(tL, tR, tk, D, mask_left)
    assert type(out.grad_fn).__name__ == "_CostVolumeConvBackward"
    out.backward(torch.from_numpy(g))
    for i, t in enumerate((tL, tR, tk)):
        np.testing.assert_allclose(t.grad.numpy(), ref[i], rtol=1e-9, atol=1e-9)
        if hand is not None:
            np.testing.assert_allclose(t.grad.numpy(), hand[i], rtol=1e-5, atol=1e-5)


def test_stem_backward_matches_autograd_bf16(rng):
    """In bf16 the hand backward returns bf16 gradients, accumulated in
    float32: held to float32 autograd of the reference composition on the
    same bf16 inputs, at bf16 output rounding."""
    n, h, w, f, o, D = 1, 6, 12, 4, 5, 6
    fL, fR = (torch.from_numpy(_rand(rng, n, h, w, f)).to(torch.bfloat16) for _ in range(2))
    k = torch.from_numpy(_rand(rng, 3, 3, 3, 2 * f, o, scale=0.1)).to(torch.bfloat16)
    g = torch.from_numpy(_rand(rng, n, D, h, w, o)).to(torch.bfloat16)
    ins = [t.clone().requires_grad_() for t in (fL, fR, k)]
    t_ops.cost_volume_conv3x3(*ins, D).backward(g)
    refs = [t.float().requires_grad_() for t in (fL, fR, k)]
    t_ops.cost_volume_conv3x3_reference(*refs, D).backward(g.float())
    for a, r in zip(ins, refs):
        assert a.grad.dtype == torch.bfloat16
        scale = r.grad.abs().max().item()
        np.testing.assert_allclose(a.grad.float().numpy(), r.grad.numpy(), rtol=2 ** -7,
                                   atol=2 ** -7 * scale)


# kernel wrapper -> (x shape, second operand shape)
_WRAPPERS = {
    "conv2d_k3": (t_conv2d.conv2d_k3, (1, 4, 8, 32), (3, 3, 32, 32)),
    "conv2d_dk_k3": (t_conv2d.conv2d_dk_k3, (1, 4, 8, 32), (1, 4, 8, 32)),
    "conv3d_k3": (t_conv3d.conv3d_k3, (1, 2, 4, 8, 32), (3, 3, 3, 32, 32)),
    "conv3d_dk_k3": (t_conv3d.conv3d_dk_k3, (1, 2, 4, 8, 32), (1, 2, 4, 8, 32)),
    "conv3d_k3s2": (t_conv3d.conv3d_k3s2, (1, 2, 4, 8, 32), (3, 3, 3, 32, 64)),
    "conv3d_s2_dk_k3": (t_conv3d.conv3d_s2_dk_k3, (1, 2, 4, 8, 32), (1, 1, 2, 4, 64)),
    "deconv3d_k3s2": (t_conv3d.deconv3d_k3s2_kernel, (1, 2, 4, 8, 64), (3, 3, 3, 32, 64)),
    "cost_volume": (lambda a, b: t_cost_volume.cost_volume_kernel(a, b, 4), (1, 4, 8, 32),
                    (1, 4, 8, 32)),
    "corr1d": (lambda a, b: t_corr.corr1d_kernel(a, b, 5), (1, 4, 8, 32), (1, 4, 8, 32)),
    # the correlation's VJP takes the features and the cotangent (N,H,W,D)
    "corr1d_vjp": (lambda a, b: t_corr.corr1d_vjp_kernel(a, b, torch.zeros(1, 4, 8, 5)),
                   (1, 4, 8, 32), (1, 4, 8, 32)),
    # the stem's assembly takes the two tap maps (N,H,W,9*O)
    "fused_costvol": (lambda a, b: t_fused.cost_volume_conv3x3_kernel(a, b, 4, True, torch.float32),
                      (1, 4, 8, 288), (1, 4, 8, 288)),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrapper_refuses_operand_that_requires_grad(name):
    """A wrapper's result carries no history, so outside its Function it
    raises rather than return a detached tensor; under no_grad it runs."""
    wrapper, xs, ks = _WRAPPERS[name]
    x, k = torch.zeros(xs), torch.zeros(ks).requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad outside its autograd.Function"):
        wrapper(x, k)
    with torch.no_grad():
        wrapper(x, k)


@pytest.mark.parametrize("name", ["conv2d_dk_k3", "conv3d_dk_k3", "conv3d_s2_dk_k3"])
def test_dk_wrapper_refuses_cpu_tensor_when_forced(name, monkeypatch):
    """Forced to the kernel, a weight-gradient wrapper given a CPU tensor
    raises; it neither builds, loads nor counts a kernel."""
    wrapper, xs, gs = _WRAPPERS[name]
    op = "conv2d" if name.startswith("conv2d") else "conv3d_s2" if "s2" in name else "conv3d"
    monkeypatch.setattr(_build, "build", lambda: pytest.fail("built the kernels"))
    before = dict(_build.LAUNCHES)
    with config.implementation("kernel", ops=(op,)):
        with pytest.raises(RuntimeError, match="runs on CUDA tensors"):
            wrapper(torch.zeros(xs), torch.zeros(gs))
    assert _build.LAUNCHES == before


def test_conv3d_128to128_dk_routes_to_kernel_f(rng, monkeypatch):
    """At 128 -> 128 (GCNet's l31/l32) the backward of ``conv3d_same``
    hands dK to kernel F's wrapper, as JAX's ``_s1_bwd`` hands it to
    ``conv3d_dk_pallas_folded``, and the gate admits that shape set only."""
    x = torch.from_numpy(_rand(rng, 1, 2, 3, 8, 128)).requires_grad_()
    k = torch.from_numpy(_rand(rng, 3, 3, 3, 128, 128, scale=0.01)).requires_grad_()
    seen = []

    def spy(a, g, _orig=t_conv3d.conv3d_dk_k3):
        seen.append((tuple(a.shape), tuple(g.shape), t_conv3d.conv3d_dk_k3_ok(a, g)))
        return _orig(a, g)

    monkeypatch.setattr(t_conv3d, "conv3d_dk_k3", spy)
    t_ops.conv3d_same(x, k).sum().backward()
    assert seen == [((1, 2, 3, 8, 128), (1, 2, 3, 8, 128), True)]
    ref = t_conv3d.conv3d_dk_plain(x.detach(), torch.ones(1, 2, 3, 8, 128, dtype=x.dtype))
    np.testing.assert_allclose(k.grad.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    ok = t_conv3d.conv3d_dk_k3_ok
    z = lambda c: torch.zeros(1, 2, 3, 8, c)
    assert ok(z(128), z(128)) and ok(z(32), z(64))
    assert not ok(z(64), z(128)) and not ok(z(128), z(64)) and not ok(z(128), z(32))


@pytest.mark.parametrize("c", [32, 64, 1024])
def test_conv2d_same_cout1_backward_matches_jax_f64(c, rng):
    """The Cout = 1 3x3 conv of every DispNet/DispNetC/iResNet disparity head
    backpropagates on the CPU (the plain version passes a contiguous
    weight), and both gradients match ``jax.vjp`` of the JAX op to 1e-12."""
    x, k = _rand(rng, 1, 8, 16, c), _rand(rng, 3, 3, c, 1, scale=0.1)
    with jax.enable_x64():
        y, vjp = jax.vjp(j_conv2d.conv2d_same, jnp.asarray(x), jnp.asarray(k))
        g = _rand(rng, *y.shape)
        ref_dx, ref_dk = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx, tk = (torch.from_numpy(a).requires_grad_() for a in (x, k))
    ty = t_ops.conv2d_same(tx, tk)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-12, atol=1e-12)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), ref_dx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tk.grad.numpy(), ref_dk, rtol=1e-12, atol=1e-12)


# lhs, kernel, strides, padding, kernel dilation, layout: the forms of the
# models' large float64 convolutions; their VJPs add the input-dilated
# (stride-2 dx) and the kernel-gradient forms, whose output has fewer
# positions than taps
DOTS_CASES = {
    "2d_3x3": ((2, 9, 11, 4), (3, 3, 4, 5), (1, 1), ((1, 1), (1, 1)), (1, 1),
               ("NHWC", "HWIO", "NHWC")),
    "2d_3x3_s2": ((2, 9, 11, 4), (3, 3, 4, 5), (2, 2), ((1, 1), (1, 1)), (1, 1),
                  ("NHWC", "HWIO", "NHWC")),
    "2d_3x3_dilated": ((1, 12, 10, 4), (3, 3, 4, 5), (1, 1), ((2, 2), (2, 2)), (2, 2),
                       ("NHWC", "HWIO", "NHWC")),
    "2d_oihw_uneven_pad": ((2, 3, 9, 10), (5, 3, 3, 3), (1, 1), ((1, 0), (0, 1)), (1, 1),
                           ("NCHW", "OIHW", "NCHW")),
    "3d_3x3x3": ((1, 5, 7, 6, 4), (3, 3, 3, 4, 5), (1, 1, 1), ((1, 1),) * 3, (1, 1, 1),
                 ("NDHWC", "DHWIO", "NDHWC")),
    "3d_3x3x3_s2": ((1, 6, 8, 6, 4), (3, 3, 3, 4, 5), (2, 2, 2), ((1, 1),) * 3, (1, 1, 1),
                    ("NDHWC", "DHWIO", "NDHWC")),
}


@pytest.mark.parametrize("name", sorted(DOTS_CASES))
def test_f64_convs_as_dots_match_xla_conv(name, rng, monkeypatch):
    """Inside ``f64_convs_as_dots`` (every size admitted here) a float64
    convolution lowers to no HLO convolution, and its value and its VJP
    with respect to both operands equal XLA's convolution's to 1e-12 of
    their largest entry."""
    xs, ks, strides, padding, dilation, layout = DOTS_CASES[name]
    x, k = rng.randn(*xs), rng.randn(*ks)
    monkeypatch.setattr(torch_jax_dots, "MIN_MACS", 0)

    def conv_and_vjp(a, b):
        y, vjp = jax.vjp(lambda a, b: lax.conv_general_dilated(
            a, b, strides, padding, rhs_dilation=dilation, dimension_numbers=layout), a, b)
        return (y, *vjp(jnp.cos(y)))

    with jax.enable_x64():
        want = jax.jit(conv_and_vjp)(x, k)
        assert "convolution" in jax.jit(conv_and_vjp).lower(x, k).as_text()
        with torch_jax_dots.f64_convs_as_dots():
            dots = jax.jit(lambda a, b: conv_and_vjp(a, b))  # a new trace, lowered here
            assert "convolution" not in dots.lower(x, k).as_text()
            got = dots(x, k)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == jnp.float64
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-12 * np.abs(w).max())
