"""Parity of the PyTorch port's layers (dsmnet_tpu_torch.models.layers) with
the flax modules of dsmnet_tpu.models.layers, in float64 on the CPU.

Each case builds the flax module and its port, gives every BN non-trivial
affine parameters and running statistics and every conv bias non-zero
values, carries the variables across
with ``interop.load_flax_variables`` and compares the outputs in eval and
in train mode, and in train mode also the updated running statistics
(flax's biased running variance, momentum 0.9).
"""

from typing import Callable

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsmnet_tpu.models import layers as j_layers
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.models import layers as t_layers


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class _FlaxCase(fnn.Module):
    build: Callable  # train -> flax submodule named "m"
    call: Callable   # (module, inputs, train) -> output(s)

    @fnn.compact
    def __call__(self, *xs, train: bool):
        return self.call(self.build(train), xs, train)


class _TorchCase(torch.nn.Module):
    def __init__(self, m, call):
        super().__init__()
        self.m = m
        self._call = call

    def forward(self, *xs):
        return self._call(self.m, *xs)


def _one(m, xs, train):
    return m(xs[0], train)


# name -> (flax builder, flax call, torch module, torch call, input shapes)
CASES = {
    "leanbn": (
        lambda train: j_layers.make_bn(train, name="m"), lambda m, xs, t: m(xs[0]),
        lambda: t_layers.LeanBN(6), lambda m, x: m(x), [(2, 4, 5, 6)]),
    "convbn_1x1_padding_eq_dilation": (
        lambda train: j_layers.ConvBN(32, 1, 1, use_bias=False, bn=True, padding=1, name="m"),
        _one, lambda: t_layers.ConvBN(16, 32, 1, 1, bn=True, padding=1), lambda m, x: m(x),
        [(1, 5, 6, 16)]),
    "convbn3d_s2_odd_dims": (
        lambda train: j_layers.ConvBN(8, 3, 2, dims=3, use_bias=False, bn=True, name="m"),
        _one, lambda: t_layers.ConvBN(4, 8, 3, 2, dims=3, bn=True), lambda m, x: m(x),
        [(1, 5, 6, 7, 4)]),
    "resblock_stride2": (
        lambda train: j_layers.ResBlockPSM(16, 2, 1, name="m"), _one,
        lambda: t_layers.ResBlockPSM(8, 16, 2, 1), lambda m, x: m(x), [(2, 8, 10, 8)]),
    "resblock_dilation2": (
        lambda train: j_layers.ResBlockPSM(16, 1, 2, name="m"), _one,
        lambda: t_layers.ResBlockPSM(16, 16, 1, 2), lambda m, x: m(x), [(1, 9, 11, 16)]),
    "convbn_5x5_s2_bias": (
        lambda train: j_layers.ConvBN(8, 5, 2, bn=True, name="m"), _one,
        lambda: t_layers.ConvBN(3, 8, 5, 2, bn=True, use_bias=True), lambda m, x: m(x),
        [(1, 9, 10, 3)]),
    # iResNet's deconv2_s (its 7x7 s2 and biased 1x1 convs are DispNetC's,
    # held in the whole-model tests)
    "deconvbn_2d_k8s4": (
        lambda train: j_layers.DeconvBN(6, 8, 4, bn=True, name="m"), _one,
        lambda: t_layers.DeconvBN(5, 6, 8, 4, bn=True), lambda m, x: m(x), [(1, 3, 4, 5)]),
    "convbn3d_bias": (
        lambda train: j_layers.ConvBN(8, 3, 1, dims=3, bn=True, name="m"), _one,
        lambda: t_layers.ConvBN(4, 8, 3, 1, dims=3, bn=True, use_bias=True), lambda m, x: m(x),
        [(1, 3, 5, 6, 4)]),
    "deconvbn_2d_k4s2": (
        lambda train: j_layers.DeconvBN(6, 4, 2, bn=True, name="m"), _one,
        lambda: t_layers.DeconvBN(5, 6, 4, 2, bn=True), lambda m, x: m(x), [(2, 3, 5, 5)]),
    "deconvbn_3d_k3s2_bn": (
        lambda train: j_layers.DeconvBN(8, 3, 2, dims=3, bn=True, name="m"), _one,
        lambda: t_layers.DeconvBN(4, 8, 3, 2, dims=3, bn=True), lambda m, x: m(x),
        [(1, 2, 3, 5, 4)]),
    "resblock_gc": (
        lambda train: j_layers.ResBlockGC(8, 1, name="m"), _one,
        lambda: t_layers.ResBlockGC(8, 8, 1), lambda m, x: m(x), [(2, 6, 7, 8)]),
    "resblock_gc_stride2": (
        lambda train: j_layers.ResBlockGC(8, 2, name="m"), _one,
        lambda: t_layers.ResBlockGC(4, 8, 2), lambda m, x: m(x), [(1, 7, 9, 4)]),
    "siamese_pooled_stats": (
        lambda train: j_layers.ConvBN(8, 3, 1, use_bias=False, bn=True, name="m"),
        lambda m, xs, t: j_layers.siamese(lambda x, tt: m(x, tt), xs[0], xs[1], t),
        lambda: t_layers.ConvBN(3, 8, 3, 1, bn=True),
        lambda m, a, b: t_layers.siamese(m, a, b), [(1, 6, 7, 3), (1, 6, 7, 3)]),
}


def _randomize(variables, rng):
    """Non-trivial BN parameters, statistics and conv biases (kernels keep
    their init)."""
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
    out = {}
    for path, v in flat.items():
        v = np.asarray(v, np.float64)
        if path[-1] == "mean":
            v = 0.1 * rng.randn(*v.shape)
        elif path[-1] == "var":
            v = 0.5 + rng.rand(*v.shape)
        elif path[-1] == "scale":
            v = 1 + 0.1 * rng.randn(*v.shape)
        elif path[-1] == "bias":
            v = 0.1 * rng.randn(*v.shape)
        out[path] = v
    return flax.traverse_util.unflatten_dict(out)


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_flax_f64(name, train, rng):
    fbuild, fcall, tbuild, tcall, shapes = CASES[name]
    xs = [rng.randn(*s) for s in shapes]
    fmod = _FlaxCase(fbuild, fcall)
    with jax.enable_x64():
        variables = fmod.init(jax.random.PRNGKey(0),
                              *[jnp.asarray(x, jnp.float32) for x in xs], train=False)
        variables = _randomize(variables, rng)
        jv = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jxs = [jnp.asarray(x) for x in xs]
        if train:
            ref, upd = fmod.apply(jv, *jxs, train=True, mutable=["batch_stats"])
            ref_stats = interop.flatten(upd["batch_stats"])
        else:
            ref = fmod.apply(jv, *jxs, train=False)
        ref = [np.asarray(r) for r in _as_list(ref)]

    tm = _TorchCase(tbuild(), tcall).double()
    interop.load_flax_variables(tm, variables["params"], variables["batch_stats"])
    tm.train(train)
    with torch.no_grad():
        out = [o.numpy() for o in _as_list(tm(*[torch.from_numpy(x) for x in xs]))]

    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == r.shape, (o.shape, r.shape)
        np.testing.assert_allclose(o, r, rtol=1e-9, atol=1e-9)
    if train:
        buffers = {k: v.numpy() for k, v in tm.named_buffers()}
        assert sorted(buffers) == sorted(ref_stats)
        for k, v in ref_stats.items():
            np.testing.assert_allclose(buffers[k], v, rtol=1e-9, atol=1e-12, err_msg=k)
