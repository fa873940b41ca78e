"""Whole-model parity: the PyTorch port's PSMNet against the JAX package's.

Both sides run create_model("psmnet", maxdisparity=16) at 1x256x320 in
float64 on the CPU with the same weights: the port's seeded weights laid
onto the flax tree, and the flax tree carried back into a fresh port
model by ``interop.load_flax_variables``.  BatchNorm statistics are harvested from
one train-mode pass of the port (which ``test_torch_train.py`` holds to
JAX's), which keeps the ~50 BN layers of a random network at O(1)
activations.  All three heads must agree to 1e-6 relative; the JAX
regression runs in float32 (regression.py:52), which is what sets that
tolerance.  The JAX side is one eval-mode ``jax.jit`` (JAX's train-mode
pass and eval op by op took ~75 s at 256x320 in a full test run on an
8-CPU machine), its float64 convolutions lowered as matrix products
(``torch_jax_dots``).

``test_torch_psmnet_small.py`` holds PSMNet and PSMNet-basic below 256
pixels with the same check.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.models.layers import ResBlockPSM as JResBlockPSM
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.models.layers import ResBlockPSM as TResBlockPSM
from dsmnet_tpu_torch.models.layers import reset_parameters
from test_torch_train import NO_FOLDING
from test_torch_trainer import _flax_tree
from torch_jax_dots import f64_convs_as_dots


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _randomize_bn(variables, rng):
    """Variance-preserving BN perturbations (tests/test_golden_torch_psmnet.py)."""
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
    out = {}
    for path, v in flat.items():
        v = np.asarray(v)
        if path[-1] == "mean":
            v = rng.randn(*v.shape).astype(np.float32) * 0.02
        elif path[-1] == "var":
            v = (0.95 + 0.1 * rng.rand(*v.shape)).astype(np.float32)
        elif path[-1] == "scale":
            v = (1 + 0.03 * rng.randn(*v.shape)).astype(np.float32)
        elif path[-1] == "bias" and v.ndim == 1:
            v = (0.02 * rng.randn(*v.shape)).astype(np.float32)
        out[path] = v
    return flax.traverse_util.unflatten_dict(out)


def _seeded_flax_variables(model, tm, h, w):
    """The flax variable tree of ``model`` (its structure from
    ``jax.eval_shape`` of ``init``, which computes nothing), filled with the
    port's seeded weights leaf by leaf: a flax leaf the port lacks raises
    here, a port parameter flax lacks raises in ``load_flax_variables``."""
    img = jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda a, b: model.init(jax.random.PRNGKey(0), a, b, train=False), img, img)
    tensors = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}

    def leaf(path, s):
        t = tensors[".".join(k.key for k in path[1:])].detach().numpy()
        assert t.shape == s.shape, (path, t.shape, s.shape)
        return t.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, flax.core.unfreeze(shapes))


def test_psmnet_eval_matches_jax_f64():
    eval_matches_jax_f64("psmnet", 256, 320, np.random.RandomState(0))


def eval_matches_jax_f64(name, h, w, rng):
    """The port's ``name`` (maxdisparity 16) in eval mode against JAX's on
    one pair, float64: the port's seeded weights, BN perturbed, the running
    statistics those of one train-mode pass of the port (from zeros,
    divided by the momentum's 0.1; PSMNet-basic's tower updates them once a
    view), which keeps the ~50 BN layers of a random network at O(1)
    activations; the JAX side one jit; every head to 1e-6 of its largest
    value."""
    maxdisp = 16
    imL, imR = rng.rand(1, h, w, 3), rng.rand(1, h, w, 3)
    tm = t_create_model(name, maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    model = j_create_model(name, maxdisparity=maxdisp)
    variables = _randomize_bn(_seeded_flax_variables(model, tm, h, w), rng)
    tm = t_create_model(name, maxdisp).double()  # fresh: every leaf comes from flax
    interop.load_flax_variables(tm, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        for b in tm.buffers():
            b.zero_()
        tm.train()(torch.from_numpy(imL), torch.from_numpy(imR))
        for b in tm.buffers():
            b /= 0.1
    with jax.enable_x64(), f64_convs_as_dots():
        args = ({"params": jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                        variables["params"]),
                 "batch_stats": _flax_tree(tm)["batch_stats"]}, imL, imR)
        # one jit, without XLA's constant folding (test_torch_train.NO_FOLDING)
        evaluate = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))
        _, disps = evaluate.lower(*args).compile(NO_FOLDING)(*args)
        ref = [np.asarray(d, np.float64) for d in disps]

    tm.eval()
    with torch.no_grad():
        _, outs = tm(torch.from_numpy(imL), torch.from_numpy(imR))
    assert len(outs) == len(ref) == {"psmnet": 3, "psmnet_basic": 1}[name]
    for i, (o, r) in enumerate(zip(outs, ref)):
        o = o.numpy()
        assert o.shape == r.shape == (1, h, w, 1), (i, o.shape, r.shape)
        assert np.isfinite(r).all()
        err = np.max(np.abs(o - r))
        scale = max(np.max(np.abs(r)), 1e-3)
        assert err / scale < 1e-6, f"head {i}: max err {err} (scale {scale})"


def _resblock_trees():
    fm = JResBlockPSM(16, 2, 1)
    v = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8)), False)
    return flax.core.unfreeze(v["params"]), flax.core.unfreeze(v["batch_stats"])


def test_interop_loads_matching_tree():
    params, stats = _resblock_trees()
    tm = interop.load_flax_variables(TResBlockPSM(8, 16, 2, 1), params, stats)
    np.testing.assert_array_equal(tm.ConvBN_2.Conv_0.kernel.detach().numpy(),
                                  np.asarray(params["ConvBN_2"]["Conv_0"]["kernel"]))


@pytest.mark.parametrize("fault", ["missing", "unused", "misshaped"])
def test_interop_rejects_mismatched_tree(fault):
    params, stats = _resblock_trees()
    if fault == "missing":
        del params["ConvBN_1"]["BatchNorm_0"]["scale"]
    elif fault == "unused":
        params["ConvBN_1"]["extra"] = {"kernel": np.zeros((3,))}
    else:
        params["ConvBN_0"]["Conv_0"]["kernel"] = np.zeros((3, 3, 8, 8))
    tm = reset_parameters(TResBlockPSM(8, 16, 2, 1), torch.Generator().manual_seed(0))
    before = tm.ConvBN_0.Conv_0.kernel.detach().clone()
    with pytest.raises(ValueError if fault == "misshaped" else KeyError):
        interop.load_flax_variables(tm, params, stats)
    assert torch.equal(tm.ConvBN_0.Conv_0.kernel.detach(), before)
