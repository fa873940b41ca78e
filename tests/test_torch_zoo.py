"""Parity of the port's GCNet, PSMNet-basic and DispNet(C) slice with the JAX package.

Every case feeds the same numpy inputs, made from a seed, to the JAX
function and to its port, on the CPU, where the port's kernel wrappers
take their plain versions (chip_smoke.py holds kernels H and I against
those on the card):

  * ``concat_cost_volume`` and ``corr1d`` in float64, forward and the
    VJP of their autograd ``Function``s against ``jax.vjp``; the volume is
    a copy, so it must be equal, the correlation to 1e-12;
  * both against the Pallas kernels they replace, in interpret mode, in
    float32: the volume equal, the correlation to 1e-5 (sums of 8
    products of N(0, 1) in another order);
  * ``soft_argmin`` against a float64 numpy oracle to 1e-12, and against
    JAX, which casts the cost to float32 (``softargmin.py:27``), to 1e-5;
  * whole models in eval mode with the same weights (the port's seeded
    weights and BN statistics calibrated by one train-mode forward,
    carried into the flax tree and back by ``interop``);
  * which ops reach which kernel wrapper, as the launch counters show it
    on the card, by shims around the wrappers, in a forward and in a train
    step (the tables ``chip_smoke.py`` holds the card to);
  * DispNetC with another ``corr_d`` against JAX, float64, and every
    model's ``count_levels``, as the JAX factory takes it.
"""

import collections

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.models import dispnet as j_dispnet
from dsmnet_tpu.ops import corr as j_corr
from dsmnet_tpu.ops import cost_volume as j_cost_volume
from dsmnet_tpu.ops import softargmin as j_softargmin
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.models.layers import calibrate_batch_stats
from dsmnet_tpu_torch.ops import conv2d, conv3d
from dsmnet_tpu_torch.ops import corr as t_corr
from dsmnet_tpu_torch.ops import cost_volume as t_cost_volume
from dsmnet_tpu_torch.ops import fused_costvol as t_fused
from dsmnet_tpu_torch.ops.softargmin import soft_argmin
from dsmnet_tpu_torch.serve import Predictor
from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step
from test_torch_train_zoo import _NoFloat32


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _vjp_f64(j_fn, t_fn, grad_fn_name, a, b, g_seed):
    """Forward and VJP of ``t_fn`` against ``jax.vjp`` of ``j_fn`` in float64;
    returns ((port out, JAX out), (port grads, JAX grads))."""
    with jax.enable_x64():
        ref, vjp = jax.vjp(jax.jit(j_fn), jnp.asarray(a), jnp.asarray(b))
        g = np.random.RandomState(g_seed).randn(*ref.shape)
        ref_grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    out = t_fn(ta, tb)
    assert type(out.grad_fn).__name__ == grad_fn_name, type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    return (out.detach().numpy(), np.asarray(ref)), ([ta.grad.numpy(), tb.grad.numpy()],
                                                     ref_grads)


# name -> (N, H, W, F, D)
CV_CASES = {"d4": (2, 3, 6, 4, 4), "d_ge_w": (1, 2, 3, 5, 6)}


@pytest.mark.parametrize("mask_left", [True, False], ids=["masked", "dense"])
@pytest.mark.parametrize("case", sorted(CV_CASES))
def test_cost_volume_and_vjp_match_jax_f64(case, mask_left, rng):
    n, h, w, f, D = CV_CASES[case]
    fL, fR = rng.randn(n, h, w, f), rng.randn(n, h, w, f)
    (out, ref), (grads, ref_grads) = _vjp_f64(
        lambda a, b: j_cost_volume.concat_cost_volume_reference(a, b, D, mask_left),
        lambda a, b: t_cost_volume.concat_cost_volume(a, b, D, mask_left),
        "_CostVolumeBackward", fL, fR, 1)
    assert out.shape == ref.shape == (n, D, h, w, 2 * f)
    np.testing.assert_array_equal(out, ref)
    for t, r in zip(grads, ref_grads):
        np.testing.assert_allclose(t, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mask_left", [True, False], ids=["masked", "dense"])
def test_cost_volume_matches_pallas_interpret_f32(mask_left, rng):
    fL, fR = (rng.randn(1, 5, 12, 8).astype(np.float32) for _ in range(2))
    ref = np.asarray(j_cost_volume.concat_cost_volume(
        jnp.asarray(fL), jnp.asarray(fR), 7, mask_left, use_pallas=True, interpret=True))
    out = t_cost_volume.concat_cost_volume(torch.from_numpy(fL), torch.from_numpy(fR), 7,
                                           mask_left)
    np.testing.assert_array_equal(out.numpy(), ref)


# name -> (N, H, W, C, D, stride, kernel_size)
CORR_CASES = {
    "s1": (2, 3, 9, 8, 4, 1, 1),
    "s2": (1, 2, 11, 4, 5, 2, 1),
    "k3": (1, 4, 7, 8, 4, 1, 3),
    "d_ge_w": (1, 2, 5, 4, 7, 1, 1),
}


@pytest.mark.parametrize("case", sorted(CORR_CASES))
def test_corr1d_and_vjp_match_jax_f64(case, rng):
    n, h, w, c, D, s, k = CORR_CASES[case]
    fL, fR = rng.randn(n, h, w, c), rng.randn(n, h, w, c)
    (out, ref), (grads, ref_grads) = _vjp_f64(
        lambda a, b: j_corr.corr1d(a, b, D, s, k, use_pallas=False),
        lambda a, b: t_corr.corr1d(a, b, D, s, k),
        "PermuteBackward0" if k > 1 else "_Corr1dBackward", fL, fR, 2)
    assert out.shape == ref.shape == (n, h, w, D)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    for t, r in zip(grads, ref_grads):
        np.testing.assert_allclose(t, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("stride", [1, 2])
def test_corr1d_matches_pallas_interpret_f32(stride, rng):
    fL, fR = (rng.randn(2, 5, 16, 8).astype(np.float32) for _ in range(2))
    ref = np.asarray(j_corr.corr1d(jnp.asarray(fL), jnp.asarray(fR), 6, stride,
                                   use_pallas=True, interpret=True))
    out = t_corr.corr1d(torch.from_numpy(fL), torch.from_numpy(fR), 6, stride)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("negate", [True, False])
def test_soft_argmin_matches_jax(negate, rng):
    cost = rng.randn(2, 9, 3, 4) * 3
    out = soft_argmin(torch.from_numpy(cost), negate).numpy()
    logits = -cost if negate else cost
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    oracle = np.einsum("ndhw,d->nhw", p, np.arange(9.0))[..., None]
    np.testing.assert_allclose(out, oracle, rtol=1e-12, atol=1e-12)
    ref = np.asarray(j_softargmin.soft_argmin(jnp.asarray(cost, jnp.float32), negate))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _flax_variables(jm, tm, h, w):
    """The flax tree of ``jm`` (its structure from ``jax.eval_shape`` of
    ``init``) filled with the port model's parameters and buffers, leaf by
    leaf, in float32: a flax leaf the port lacks raises here, a port
    tensor flax lacks raises in ``load_flax_variables``."""
    img = jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda a, b: jm.init(jax.random.PRNGKey(0), a, b, train=False), img, img)
    tensors = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}

    def leaf(path, s):
        t = tensors[".".join(k.key for k in path[1:])].detach().numpy()
        assert t.shape == s.shape, (path, t.shape, s.shape)
        return t.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, flax.core.unfreeze(shapes))


# name -> (maxdisparity, H, W, dtype, relative tolerance).  GCNet at 64x96
# takes the odd-size routes (l27's input is 3x8x12: plain stride-2 conv,
# and crop_add crops l34's output).  JAX's soft-argmin runs in float32,
# which sets GCNet's tolerance; DispNet casts its heads to float32, as the
# port does.  PSMNet-basic needs 256x256 (the SPP's 64x64 pool at 1/4),
# where a float64 pass through XLA:CPU is too slow, so it runs in float32,
# held to 1e-4 of the disparity range.
MODEL_CASES = {
    "gcnet": (24, 64, 96, torch.float64, 1e-5),
    "dispnet": (192, 64, 128, torch.float64, 1e-6),
    "dispnetcorr": (192, 64, 128, torch.float64, 1e-6),
    "iresnet": (192, 64, 128, torch.float64, 1e-6),
    "psmnet_basic": (16, 256, 256, torch.float32, 1e-4),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_model_eval_matches_jax(name, rng):
    maxdisp, h, w, dtype, rtol = MODEL_CASES[name]
    imL, imR = rng.rand(1, h, w, 3), rng.rand(1, h, w, 3)
    tm = t_create_model(name, maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    calibrate_batch_stats(tm, torch.from_numpy(imL).float(), torch.from_numpy(imR).float())
    jm = j_create_model(name, maxdisparity=maxdisp)
    variables = _flax_variables(jm, tm, h, w)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        jv = jax.tree.map(lambda a: jnp.asarray(a, jdt), variables)
        # one XLA program: op by op, the JAX side alone takes 20-30 s here
        apply = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False, clamp=True)[1])
        ref = [np.asarray(d, np.float64) for d in apply(jv, jnp.asarray(imL, jdt),
                                                         jnp.asarray(imR, jdt))]

    tm = t_create_model(name, maxdisp).to(dtype)  # fresh: every leaf comes from flax
    interop.load_flax_variables(tm, variables["params"], variables.get("batch_stats"))
    tm.eval()
    with torch.no_grad():
        _, outs = tm(torch.from_numpy(imL).to(dtype), torch.from_numpy(imR).to(dtype),
                     clamp=True)
    assert len(outs) == len(ref)
    for i, (o, r) in enumerate(zip(outs, ref)):
        o = o.double().numpy()
        assert o.shape == r.shape, (i, o.shape, r.shape)
        scale = max(np.abs(r).max(), 1e-3)
        assert np.abs(o - r).max() <= rtol * scale, (i, np.abs(o - r).max(), scale)


# wrappers a shim counts: (module, attribute, launch-counter name)
_WRAPPERS = [
    (conv2d, "conv2d_k3", "conv2d_k3"), (conv2d, "conv2d_dk_k3", "conv2d_dk_k3"),
    (conv3d, "conv3d_k3", "conv3d_k3"), (conv3d, "conv3d_k3s2", "conv3d_k3s2"),
    (conv3d, "deconv3d_k3s2_kernel", "deconv3d_k3s2"), (conv3d, "conv3d_dk_k3", "conv3d_dk_k3"),
    (conv3d, "conv3d_s2_dk_k3", "conv3d_dk_k3s2"),
    (t_cost_volume, "cost_volume_kernel", "cost_volume"), (t_corr, "corr1d_kernel", "corr1d"),
    (t_corr, "corr1d_vjp_kernel", "corr1d_vjp"),
    (t_fused, "cost_volume_conv3x3_kernel", "fused_costvol"),
]


# name -> (maxdisparity, H, W, wrapper calls of one forward): the launches
# per request that chip_smoke.py expects at 384x768, maxdisparity 192,
# at a size where GCNet's volume stays even down to l30's input (PSMNet's
# at 256x256, where every SPP pool has a window)
ROUTES = {
    "psmnet": (32, 256, 256, {"conv2d_k3": 8, "conv3d_k3": 12, "conv3d_k3s2": 6,
                              "deconv3d_k3s2": 3, "fused_costvol": 1}),
    "gcnet": (32, 64, 128, {"conv2d_k3": 17, "conv3d_k3": 10, "conv3d_k3s2": 3,
                            "deconv3d_k3s2": 1, "cost_volume": 1}),
    "psmnet_basic": (16, 256, 256, {"conv2d_k3": 16, "conv3d_k3": 11, "cost_volume": 1}),
    "dispnetcorr": (192, 64, 128, {"corr1d": 1}),
    "dispnet": (192, 64, 128, {}),
    "iresnet": (192, 64, 128, {"corr1d": 2}),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_model_routes_ops_to_kernel_wrappers(name, monkeypatch):
    """On the CPU the wrappers take their plain versions, so the routing is
    checked by counting the calls that reach them."""
    maxdisp, h, w, expected = ROUTES[name]
    calls = {}

    def shim(fn, key):
        def counted(*args, **kwargs):
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for module, attr, key in _WRAPPERS:
        monkeypatch.setattr(module, attr, shim(getattr(module, attr), key))
    tm = t_create_model(name, maxdisp).reset_parameters(torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        tm(torch.rand(1, h, w, 3, generator=gen), torch.rand(1, h, w, 3, generator=gen))
    assert calls == expected


# name -> (maxdisparity, H, W, create_model kwargs, wrapper calls of one
# train step): chip_smoke.py's TRAIN_LAUNCHES (REMAT_LAUNCHES with remat),
# which its train phases hold every step to on the card
TRAIN_ROUTES = {
    "psmnet": (32, 256, 256, {}, chip_smoke.TRAIN_LAUNCHES["psmnet"]),
    "gcnet": (32, 64, 128, {}, chip_smoke.TRAIN_LAUNCHES["gcnet"]),
    "gcnet_remat": (32, 64, 128, {"remat": True}, chip_smoke.REMAT_LAUNCHES["gcnet"]),
    "psmnet_basic": (16, 256, 256, {}, chip_smoke.TRAIN_LAUNCHES["psmnet_basic"]),
    "dispnet": (192, 64, 128, {}, chip_smoke.TRAIN_LAUNCHES["dispnet"]),
    "dispnetcorr": (192, 64, 128, {}, chip_smoke.TRAIN_LAUNCHES["dispnetcorr"]),
    "iresnet": (192, 64, 128, {}, chip_smoke.TRAIN_LAUNCHES["iresnet"]),
}


@pytest.mark.parametrize("case", sorted(TRAIN_ROUTES))
def test_train_step_routes_ops_to_kernel_wrappers(case, monkeypatch):
    """One supervised step's forward and backward reach each wrapper as
    often as the card's launch counters must show it, and at the shapes of
    chip_smoke.py's rows for the model's train path at this size and batch
    (GCNet's l31/l32 hand their dK to kernel F at 128 -> 128): every shape
    the step launches is one that the card's check holds against its plain
    version.  Remat launches the same shapes."""
    maxdisp, h, w, kwargs, expected = TRAIN_ROUTES[case]
    name = case.split("_remat")[0]
    calls, shapes = {}, {}

    def shim(fn, key):
        def counted(*args, **kw):
            calls[key] = calls.get(key, 0) + 1
            sig = tuple(tuple(a.shape) if torch.is_tensor(a) else a for a in args
                        if not isinstance(a, torch.dtype))
            shapes.setdefault(key, collections.Counter())[sig] += 1
            return fn(*args, **kw)
        return counted

    for module, attr, key in _WRAPPERS:
        monkeypatch.setattr(module, attr, shim(getattr(module, attr), key))
    tm = t_create_model(name, maxdisp, **kwargs).reset_parameters(
        torch.Generator().manual_seed(1))
    state, opt = create_train_state(tm, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = torch.rand(1, h, w, 7, generator=gen)
    batch[..., 6] = batch[..., 6] * (maxdisp - 2) + 1
    out = make_supervised_train_step(tm, opt)(state, batch, 1e-3,
                                              chip_smoke.loss_weights(tm))
    assert np.isfinite(out["loss"].item())
    assert calls == expected

    for attr, v in (("H", h), ("W", w), ("MAXDISP", maxdisp), ("TRAIN_RUNS", {
            k: (path, 1, steps, lr) for k, (path, _, steps, lr) in chip_smoke.TRAIN_RUNS.items()})):
        monkeypatch.setattr(chip_smoke, attr, v)
    path = chip_smoke.TRAIN_RUNS[name][0]
    rows = {}
    for spec in chip_smoke.kernel_specs():
        for a, b, n, *args in spec["paths"].get(path, []):
            rows.setdefault(spec["name"], collections.Counter())[(a, b, *args)] += n
    if kwargs:
        assert {k: set(c) for k, c in shapes.items()} == {k: set(c) for k, c in rows.items()}
    else:
        assert shapes == rows


@pytest.mark.parametrize("name", ["gcnet", "dispnetcorr", "iresnet"])
def test_predictor_serves_model_on_cpu(name, rng):
    server = Predictor(net=name, maxdisparity=32, device="cpu", dtype=torch.bfloat16)
    disp = server.predict(rng.rand(64, 128, 3), rng.rand(64, 128, 3))
    assert disp.shape == (1, 64, 128) and disp.dtype == np.float32
    assert np.isfinite(disp).all() and disp.min() >= 1e-6 and disp.max() <= 128


def test_dispnetc_corr_d_matches_jax(rng, monkeypatch):
    """DispNetC with ``corr_d`` = 21 (the JAX constructor field,
    ``dispnet.py:112``): conv3a takes 21 + 64 channels, and the eval-mode
    forward matches the JAX model's in float64 to 1e-9 (the JAX heads'
    float32 cast read as float64, as in ``test_torch_train_zoo.py``)."""
    h, w = 64, 128
    imL, imR = rng.rand(1, h, w, 3), rng.rand(1, h, w, 3)
    tm = t_create_model("dispnetcorr", 192, corr_d=21).reset_parameters(
        torch.Generator().manual_seed(0))
    assert tuple(tm.conv3a.Conv_0.kernel.shape) == (5, 5, 85, 256)
    jm = j_create_model("dispnetcorr", maxdisparity=192, corr_d=21)
    variables = _flax_variables(jm, tm, h, w)
    monkeypatch.setattr(j_dispnet, "jnp", _NoFloat32())
    with jax.enable_x64():
        jv = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        apply = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False)[1])
        ref = [np.asarray(d) for d in apply(jv, jnp.asarray(imL), jnp.asarray(imR))]
    tm = t_create_model("dispnetcorr", 192, corr_d=21).double()
    interop.load_flax_variables(tm, variables["params"])
    with torch.no_grad():
        _, outs = tm.eval()(torch.from_numpy(imL), torch.from_numpy(imR))
    assert len(outs) == len(ref) == 7
    for o, r in zip(outs, ref):
        assert o.shape == r.shape and o.dtype == torch.float64
        assert np.linalg.norm(o.numpy() - r) <= 1e-9 * np.linalg.norm(r)


@pytest.mark.parametrize("name", sorted(chip_smoke.TRAIN_LAUNCHES))
def test_count_levels_as_jax_factory(name):
    """``count_levels`` defaults to the JAX model's field and is taken as a
    keyword by the factory, as JAX's is (it sets the loss levels only)."""
    assert t_create_model(name, 32).count_levels == j_create_model(name, 32).count_levels
    assert t_create_model(name, 32, count_levels=3).count_levels == 3 == \
        j_create_model(name, 32, count_levels=3).count_levels


def test_psmnet_without_fused_stem_routes_to_volume_kernel(monkeypatch):
    """PSMNet with ``fused_stem=False`` reaches H (the volume) and B for
    dres0_0 (64 -> 32), never J, as often as chip_smoke.py's
    ``serve_psmnet_volume`` path expects per request."""
    calls = {}

    def shim(fn, key):
        def counted(*args, **kwargs):
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for module, attr, key in _WRAPPERS:
        monkeypatch.setattr(module, attr, shim(getattr(module, attr), key))
    tm = t_create_model("psmnet", 32, fused_stem=False).reset_parameters(
        torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        tm(torch.rand(1, 256, 256, 3, generator=gen), torch.rand(1, 256, 256, 3, generator=gen))
    assert calls == chip_smoke.SERVE_LAUNCHES["psmnet_volume"]
