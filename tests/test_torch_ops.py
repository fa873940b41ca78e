"""Parity of the PyTorch port's ops (dsmnet_tpu_torch.ops) with the JAX package.

Every case feeds the same numpy inputs, made from a seed, to the JAX
function and to its port, on the CPU:

  * in float64 (``jax.enable_x64``), to rtol = atol = 1e-9: both sides
    compute the same function exactly up to float association;
  * in float32 against the Pallas kernel itself in interpret mode, for
    each op that carries a hand-written CUDA kernel in the port, to
    rtol = atol = 1e-4 (the shapes of tests/test_ops.py).

``imwarp``'s two sampling paths (the integer-origin 2-tap one and the
generic 4-tap one) must also give the same bits in the port.

On the CPU the port's kernel wrappers take their plain PyTorch versions;
the CUDA kernels are held against those on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dsmnet_tpu.ops import conv2d as j_conv2d
from dsmnet_tpu.ops import conv3d as j_conv3d
from dsmnet_tpu.ops import cost_volume as j_cost_volume
from dsmnet_tpu.ops import fused_costvol as j_fused
from dsmnet_tpu.ops import regression as j_regression
from dsmnet_tpu.ops import resize as j_resize
from dsmnet_tpu.ops import warp as j_warp
from dsmnet_tpu_torch import ops as t_ops
from dsmnet_tpu_torch.ops import warp as t_warp


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rand(rng, *shape, scale=1.0):
    return rng.randn(*shape) * scale


def _run_f64(jax_fn, torch_fn, *arrays):
    """Run both sides in float64 on the same numpy inputs."""
    with jax.enable_x64():
        ref = np.asarray(jax_fn(*[jnp.asarray(a, jnp.float64) for a in arrays]))
    out = torch_fn(*[torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]).numpy()
    return out, ref


def _stem_inputs(rng, n, h, w, f, o):
    return (_rand(rng, n, h, w, f), _rand(rng, n, h, w, f),
            _rand(rng, 3, 3, 3, 2 * f, o, scale=0.1))


# (name, builder(rng) -> (port output, JAX output))
F64_CASES = {
    "conv2d_same_c32": lambda rng: _run_f64(
        j_conv2d.conv2d_same, t_ops.conv2d_same,
        _rand(rng, 2, 6, 10, 32), _rand(rng, 3, 3, 32, 32, scale=0.1)),
    "conv2d_same_c64": lambda rng: _run_f64(
        j_conv2d.conv2d_same, t_ops.conv2d_same,
        _rand(rng, 1, 5, 9, 64), _rand(rng, 3, 3, 64, 64, scale=0.1)),
    "conv3d_same_c32": lambda rng: _run_f64(
        j_conv3d.conv3d_same, t_ops.conv3d_same,
        _rand(rng, 1, 4, 6, 8, 32), _rand(rng, 3, 3, 3, 32, 32, scale=0.1)),
    "conv3d_same_co1_head": lambda rng: _run_f64(
        j_conv3d.conv3d_same, t_ops.conv3d_same,
        _rand(rng, 1, 4, 6, 8, 32), _rand(rng, 3, 3, 3, 32, 1, scale=0.1)),
    "conv3d_s2_c32_co64": lambda rng: _run_f64(
        j_conv3d.conv3d_s2, t_ops.conv3d_s2,
        _rand(rng, 1, 4, 6, 8, 32), _rand(rng, 3, 3, 3, 32, 64, scale=0.1)),
    "deconv3d_k3s2_64to32": lambda rng: _run_f64(
        j_conv3d.deconv3d_k3s2, t_ops.deconv3d_k3s2,
        _rand(rng, 1, 2, 3, 5, 64), _rand(rng, 3, 3, 3, 32, 64, scale=0.1)),
    "deconv3d_k3s2_64to64": lambda rng: _run_f64(
        j_conv3d.deconv3d_k3s2, t_ops.deconv3d_k3s2,
        _rand(rng, 1, 2, 3, 5, 64), _rand(rng, 3, 3, 3, 64, 64, scale=0.1)),
    "resize_bilinear": lambda rng: _run_f64(
        lambda x: j_resize.resize_bilinear(x, (9, 13)),
        lambda x: t_ops.resize_bilinear(x, (9, 13)),
        _rand(rng, 2, 5, 7, 3)),
    "upsample2x": lambda rng: _run_f64(j_resize.upsample2x, t_ops.upsample2x,
                                       _rand(rng, 2, 3, 5, 2)),
    "concat_cost_volume_reference": lambda rng: _run_f64(
        lambda a, b: j_cost_volume.concat_cost_volume_reference(a, b, 7, True),
        lambda a, b: t_ops.concat_cost_volume_reference(a, b, 7, True),
        _rand(rng, 1, 3, 5, 2), _rand(rng, 1, 3, 5, 2)),
}
# imwarp: (source shape, disparity shape, fliplr, left_top, scale); the
# disparities span [-6, 12], so some samples leave the source on either side
WARP_CASES = {
    "h_path_scale2": ((2, 12, 30, 3), (2, 5, 12, 1), False, (2.0, 1.0), 2.0),
    "h_path_fliplr": ((1, 6, 10, 2), (1, 6, 10, 1), True, (0.0, 0.0), 1.0),
    # fractional origin and scale: the 4-tap path, bottom rows past the source
    "generic": ((2, 9, 20, 3), (2, 6, 10, 1), False, (1.5, 0.25), 1.7),
}
for _name, (_src, _disp, _flip, _lt, _s) in WARP_CASES.items():
    def _case(rng, src=_src, disp=_disp, flip=_flip, lt=_lt, s=_s):
        return _run_f64(lambda a, d: j_warp.imwarp(a, d, flip, lt, s),
                        lambda a, d: t_warp.imwarp(a, d, flip, lt, s),
                        _rand(rng, *src), rng.uniform(-6, 12, disp))
    F64_CASES[f"imwarp_{_name}"] = _case
F64_CASES["warp_disparity"] = lambda rng: _run_f64(
    j_warp.warp_disparity, t_warp.warp_disparity, rng.uniform(0, 8, (2, 5, 9, 1)),
    rng.uniform(-3, 12, (2, 5, 9, 1)))
for _ml in (True, False):
    for _target in ("cost_volume_conv3x3", "cost_volume_conv3x3_reference"):
        # (n, h, w, f, o, D): an interior case and one with D > W (zero slices)
        for _geom in ((1, 5, 12, 4, 5, 6), (2, 4, 5, 3, 4, 7)):
            def _case(rng, ml=_ml, target=_target, geom=_geom):
                n, h, w, f, o, D = geom
                return _run_f64(
                    lambda a, b, k: getattr(j_fused, target)(a, b, k, D, ml),
                    lambda a, b, k: t_ops.cost_volume_conv3x3(a, b, k, D, ml),
                    *_stem_inputs(rng, n, h, w, f, o))
            F64_CASES[f"stem_vs_{_target}_mask{int(_ml)}_D{_geom[-1]}"] = _case


@pytest.mark.parametrize("name", sorted(F64_CASES))
def test_op_matches_jax_f64(name, rng):
    out, ref = F64_CASES[name](rng)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)


# out (17, 33, 17) from (5, 3, 5): align-corners steps (n_in-1)/(n_out-1)
# are dyadic, so the float32 interpolation weights are exact in float64
_TRI_COST = (2, 5, 3, 5, 1)
_TRI_OUT = (17, 33, 17)


def test_trilinear_soft_argmin_f64_oracle(rng):
    """Chunked regression (33 rows = chunks of 16, 16, 1) against the
    unchunked float64 composition F.interpolate(trilinear, align_corners)
    + softmax expectation."""
    cost = torch.from_numpy(_rand(rng, *_TRI_COST, scale=3.0))
    out = t_ops.trilinear_soft_argmin(cost, _TRI_OUT, h_chunk=16)[..., 0]
    up = F.interpolate(cost.permute(0, 4, 1, 2, 3), _TRI_OUT, mode="trilinear",
                       align_corners=True)[:, 0]
    p = torch.softmax(up, dim=1)
    ref = (p * torch.arange(_TRI_OUT[0], dtype=p.dtype).view(1, -1, 1, 1)).sum(1)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-9, atol=1e-9)


def test_trilinear_soft_argmin_matches_jax(rng):
    """The JAX regression casts the cost to float32 (regression.py:52)
    whatever the input dtype, so this comparison holds at float32
    precision: softmax over 17 disparities, values < 17."""
    cost = _rand(rng, *_TRI_COST, scale=3.0).astype(np.float32)
    ref = np.asarray(j_regression.trilinear_soft_argmin(jnp.asarray(cost), _TRI_OUT))
    out = t_ops.trilinear_soft_argmin(torch.from_numpy(cost), _TRI_OUT).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _pallas_conv2d(x, k):
    from dsmnet_tpu.ops.conv2d_pallas import conv2d_fwd_pallas

    return conv2d_fwd_pallas(x, k, interpret=True)


def _pallas_conv3d(x, k):
    from dsmnet_tpu.ops.conv3d_pallas import conv3d_fwd_pallas

    return conv3d_fwd_pallas(x, k, interpret=True)


def _pallas_conv3d_s2(x, k):
    from dsmnet_tpu.ops.conv3d_s2_pallas import conv3d_s2_fwd_pallas

    return conv3d_s2_fwd_pallas(x, k, interpret=True)


def _pallas_deconv(x, kp):
    from dsmnet_tpu.ops.conv3d_s2_pallas import conv3d_s2_dx_pallas_folded
    from dsmnet_tpu.ops.folded import fold, unfold

    return unfold(conv3d_s2_dx_pallas_folded(fold(x), kp, interpret=True), kp.shape[3])


# (op, Pallas kernel, x shape, kernel shape): shapes of tests/test_ops.py
PALLAS_CASES = {
    "conv2d_2x8x64_32to32": (t_ops.conv2d_same, _pallas_conv2d, (2, 8, 64, 32), (3, 3, 32, 32)),
    "conv2d_1x6x64_64to32": (t_ops.conv2d_same, _pallas_conv2d, (1, 6, 64, 64), (3, 3, 64, 32)),
    "conv2d_1x4x32_64to64": (t_ops.conv2d_same, _pallas_conv2d, (1, 4, 32, 64), (3, 3, 64, 64)),
    "conv3d_1x6x8x16_32to32": (t_ops.conv3d_same, _pallas_conv3d, (1, 6, 8, 16, 32),
                               (3, 3, 3, 32, 32)),
    "conv3d_2x4x8x8_64to32": (t_ops.conv3d_same, _pallas_conv3d, (2, 4, 8, 8, 64),
                              (3, 3, 3, 64, 32)),
    "conv3d_s2_1x6x8x32_32to16": (t_ops.conv3d_s2, _pallas_conv3d_s2, (1, 6, 8, 32, 32),
                                  (3, 3, 3, 32, 16)),
    "conv3d_s2_1x4x8x16_32to64": (t_ops.conv3d_s2, _pallas_conv3d_s2, (1, 4, 8, 16, 32),
                                  (3, 3, 3, 32, 64)),
    "deconv3d_1x3x4x32_64to32": (t_ops.deconv3d_k3s2, _pallas_deconv, (1, 3, 4, 32, 64),
                                 (3, 3, 3, 32, 64)),
}


@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_kernel_op_matches_pallas_interpret_f32(name, rng):
    op, pallas, xs, ks = PALLAS_CASES[name]
    x = _rand(rng, *xs).astype(np.float32)
    k = _rand(rng, *ks, scale=0.1).astype(np.float32)
    ref = np.asarray(pallas(jnp.asarray(x), jnp.asarray(k)))
    out = op(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16],
                         ids=["f64", "f32", "bf16"])
def test_imwarp_horizontal_path_matches_generic_bits(dtype, rng):
    """At an integer origin and scale imwarp takes its 2-tap path; the
    generic 4-tap gather on the same sample grid gives the same bits."""
    src = torch.from_numpy(_rand(rng, 2, 12, 30, 3)).to(dtype)
    disp = torch.from_numpy(rng.uniform(-6, 12, (2, 5, 12, 1))).to(dtype)
    out = t_warp.imwarp(src, disp, left_top=(2.0, 1.0), scale_factor=2.0)
    px = 2.0 + torch.arange(12, dtype=torch.float32).view(1, 1, 12) * 2.0 - disp[..., 0]
    py = (1.0 + torch.arange(5, dtype=torch.float32).view(1, 5, 1) * 2.0).expand_as(px)
    generic = t_warp._bilinear_gather_zero_pad(src + torch.tensor(5.5e-5, dtype=dtype), px, py)
    assert out.dtype == dtype
    assert torch.equal(out, generic)


# kernel J's plain version (the whole op on the CPU) against the Pallas
# interior kernel with its XLA boundary patches: (n, h, w, f, o, D, mask_left)
STEM_PALLAS_CASES = {
    "masked": (2, 8, 12, 4, 8, 6, True),
    "d_gt_w": (1, 4, 5, 4, 8, 9, True),
    "d2_dense": (1, 4, 10, 4, 8, 2, False),
}


@pytest.mark.parametrize("name", sorted(STEM_PALLAS_CASES))
def test_stem_matches_pallas_interpret_f32(name, rng):
    n, h, w, f, o, D, ml = STEM_PALLAS_CASES[name]
    fL, fR, k = (a.astype(np.float32) for a in _stem_inputs(rng, n, h, w, f, o))
    ref = np.asarray(j_fused.cost_volume_conv3x3(
        jnp.asarray(fL), jnp.asarray(fR), jnp.asarray(k), D, ml, use_pallas=True, interpret=True))
    out = t_ops.cost_volume_conv3x3(torch.from_numpy(fL), torch.from_numpy(fR),
                                    torch.from_numpy(k), D, ml)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (n, D, h, w, o)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
