"""The PyTorch port's supervised training step against the JAX package's.

Same numpy inputs, made from a seed, on both sides, on the CPU:

  * one whole PSMNet ``make_supervised_train_step`` in float64 at 256x256
    (where every SPP pool, up to 64x64 at 1/4 resolution, has a window;
    ``check_psmnet_step_f64`` also runs below it, in
    ``test_torch_psmnet_small.py``), maxdisparity 16, against the JAX step on the same weights
    carried by ``interop`` (its float64 convolutions lowered as matrix
    products, ``torch_jax_dots``): loss, D1/EPE, every parameter's
    gradient, the parameters after the step and the BN running statistics;
  * the loss falls over a few steps on one fixed batch;
  * under bf16 the weight-gradient kernels get bf16 cotangents.

The loss, metrics, schedule and Adam alone are in ``test_torch_losses.py``.
This file keeps few, heavy tests: pytest-xdist's ``--dist loadfile``
queues files by their number of tests, so a file of three or fewer
queues behind the repo's longest file (``test_train_zoo.py``, four tests)
instead of delaying its start.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.train import state as j_state
from dsmnet_tpu.train import steps as j_steps
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.models.layers import compute_dtype
from dsmnet_tpu_torch.train import (
    create_train_state,
    make_supervised_eval_step,
    make_supervised_train_step,
)
from torch_jax_dots import f64_convs_as_dots
from torch_parallel_ranks import worker_cpus


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    with worker_cpus():
        yield
    torch.set_num_threads(old)


def _recording_adam():
    """optax scale_by_adam whose state also keeps the last gradient, so the
    JAX step itself reports the gradients it applied."""
    adam = j_state.make_optimizer()

    def init(p):
        return adam.init(p), jax.tree.map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, a = adam.update(g, s[0], p)
        return u, (a, g)

    return optax.GradientTransformation(init, update)


def _seeded_flax_variables(model, tm, h, w, rng):
    """The flax tree of ``model`` (structure from ``jax.eval_shape``)
    holding the port's seeded weights; BN scale/bias perturbed so their
    gradients are not those of the identity."""
    img = jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda a, b: model.init(jax.random.PRNGKey(0), a, b, train=False), img, img)
    tensors = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}

    def leaf(path, s):
        t = tensors[".".join(k.key for k in path[1:])].detach().numpy().astype(np.float64)
        assert t.shape == s.shape, (path, t.shape, s.shape)
        if path[-1].key == "scale":
            t = t + 0.03 * rng.randn(*t.shape)
        elif path[-1].key == "bias" and t.ndim == 1:
            t = t + 0.02 * rng.randn(*t.shape)
        return jnp.asarray(t)

    return jax.tree_util.tree_map_with_path(leaf, flax.core.unfreeze(shapes))


def _flat(tree):
    return {".".join(k): np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        flax.core.unfreeze(tree)).items()}


def _relerr(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_psmnet_train_step_matches_jax_f64(rng):
    """One supervised step of the port against the JAX step, float64, at
    256x256, where every SPP pool has a window."""
    check_psmnet_step_f64(rng, 256, 256)


# XLA:CPU's constant folding evaluates an empty SPP pool's constant branch
# (and its gradient) on the host: minutes of compilation below 256 pixels,
# against seconds with the pass off, which changes no result
NO_FOLDING = {"xla_disable_hlo_passes": "constant_folding"}


def check_psmnet_step_f64(rng, h, w, still=()):
    """One supervised PSMNet step of the port against the JAX step, float64,
    at ``h`` x ``w``; returns the port's model after the step.  Every
    running statistic moves but those named in ``still``.

    The JAX regression casts its cost to float32 whatever the dtype
    (``ops/regression.py:52``), so the JAX loss and every gradient carry
    float32 rounding: the loss is held at 1e-6 relative and each
    parameter's gradient at 1e-4 relative norm.  Adam's first step is
    lr * g / (|g| + 1e-8): the port's parameters are held to that update
    of its own gradient at 1e-12, and to the JAX step's parameters at
    lr * 1e-3 where |g| >= 1e-6: a gradient error dg moves the step by
    lr * 1e-8 * dg / |g|^2, and for |g| ~ 1e-6 the float32 rounding of the
    JAX gradient is ~1e-8.  Below 1e-6 (about 8% of the elements of this
    random network) the normalised step follows that rounding, so there it
    is only held to its size, lr.
    The running statistics, which do not see the regression, are held at
    1e-9 relative."""
    maxdisp, lr = 16, 1e-3
    batch = rng.rand(1, h, w, 7)
    batch[..., 6] = batch[..., 6] * 14 + 1
    batch[0, :8, :, 6] = 0.0  # invalid ground truth
    tm = t_create_model("psmnet", maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    with jax.enable_x64(), f64_convs_as_dots():
        model = j_create_model("psmnet", maxdisparity=maxdisp)
        v = _seeded_flax_variables(model, tm, h, w, rng)
        v_np = jax.tree.map(np.asarray, v)  # the step donates (deletes) its state
        tx = _recording_adam()
        state = j_state.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                                   jnp.zeros((), jnp.int32))
        args = (state, jnp.asarray(batch), lr, jnp.asarray([1.0]))
        step = j_steps.make_supervised_train_step(model, tx).lower(*args).compile(NO_FOLDING)
        new, jm = step(*args)
        ref = {k: float(jm[k]) for k in ("loss", "d1", "epe")}
        ref_grads = _flat(new.opt_state[1])
        ref_params = _flat(new.params)
        ref_stats = _flat(new.batch_stats)
    params0, stats0 = _flat(v_np["params"]), _flat(v_np["batch_stats"])

    tm = t_create_model("psmnet", maxdisp).double()  # fresh: every leaf from flax
    interop.load_flax_variables(tm, v_np["params"], v_np["batch_stats"])
    tstate, opt = create_train_state(tm, device="cpu")
    tstep = make_supervised_train_step(tm, opt)
    out = tstep(tstate, torch.from_numpy(batch), lr, np.array([1.0], np.float32))
    assert tstate.step == 1

    np.testing.assert_allclose(out["loss"].item(), ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(out["epe"].item(), ref["epe"], rtol=1e-5)
    np.testing.assert_allclose(out["d1"].item(), ref["d1"], atol=0.02)  # a pixel of 65536 is 0.0015
    named = dict(tm.named_parameters())
    assert set(named) == set(ref_grads) == set(params0)
    bad = {p: _relerr(t.grad.numpy(), ref_grads[p]) for p, t in named.items()
           if _relerr(t.grad.numpy(), ref_grads[p]) > 1e-4}
    assert not bad, bad
    for p, t in named.items():
        new_p, g = t.detach().numpy(), t.grad.numpy()
        # the port's Adam applied its own gradient: p - lr * g / (|g| + 1e-8)
        np.testing.assert_allclose(new_p, params0[p] - lr * g / (np.abs(g) + 1e-8), rtol=1e-12,
                                   atol=1e-15, err_msg=p)
        # where the step is well conditioned, the JAX step moved the
        # parameter the same way
        firm = np.abs(ref_grads[p]) >= 1e-6
        np.testing.assert_allclose(new_p[firm], ref_params[p][firm], rtol=0, atol=lr * 1e-3,
                                   err_msg=p)
        assert np.all(np.abs(new_p - params0[p]) <= lr * (1 + 1e-9)), p
    buffers = dict(tm.named_buffers())
    assert set(buffers) == set(ref_stats)
    for p, t in buffers.items():
        assert np.array_equal(t.numpy(), stats0[p]) == (p in still), p
        np.testing.assert_allclose(t.numpy(), ref_stats[p], rtol=1e-9, atol=1e-12, err_msg=p)
    return tm


def test_train_steps_lower_the_loss(rng):
    """Four float32 steps on one fixed batch lower the loss; the eval step
    runs on the running statistics and returns the full-resolution map.
    At 128x192 the SPP's 64-pool is empty (JAX's constant branch)."""
    h, w = 128, 192
    batch = rng.rand(1, h, w, 7).astype(np.float32)
    batch[..., 6] = batch[..., 6] * 14 + 1
    batch = torch.from_numpy(batch)
    tm = t_create_model("psmnet", 16).reset_parameters(torch.Generator().manual_seed(0))
    state, opt = create_train_state(tm, device="cpu")
    step = make_supervised_train_step(tm, opt)
    losses = [step(state, batch, 1e-3, np.ones(1))["loss"].item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    ev = make_supervised_eval_step(tm)(state, batch, np.ones(1))
    assert ev["disp"].shape == (1, h, w, 1) and np.isfinite(ev["loss"].item())


def test_bf16_step_keeps_bf16_cotangents(rng, monkeypatch):
    """Under the bf16 compute dtype the step runs and every conv kernel
    reaches its backward with a bf16 cotangent (no float32 volume copies
    feed the kernels), while the parameter gradients stay float32."""
    from dsmnet_tpu_torch.ops import conv2d, conv3d

    seen = []
    for mod, name in ((conv2d, "conv2d_dk_k3"), (conv3d, "conv3d_dk_k3"),
                      (conv3d, "conv3d_s2_dk_k3")):
        def spy(x, g, _orig=getattr(mod, name), _name=name):
            seen.append((_name, x.dtype, g.dtype))
            return _orig(x, g)

        monkeypatch.setattr(mod, name, spy)
    batch = rng.rand(1, 256, 256, 7).astype(np.float32)
    batch[..., 6] = batch[..., 6] * 14 + 1
    tm = t_create_model("psmnet", 16).reset_parameters(torch.Generator().manual_seed(0))
    state, opt = create_train_state(tm, device="cpu")
    with compute_dtype(torch.bfloat16):
        out = make_supervised_train_step(tm, opt)(state, torch.from_numpy(batch), 1e-3,
                                                  np.ones(1))
    assert np.isfinite(out["loss"].item())
    assert {n for n, _, _ in seen} == {"conv2d_dk_k3", "conv3d_dk_k3", "conv3d_s2_dk_k3"}
    assert all(xd == gd == torch.bfloat16 for _, xd, gd in seen), seen
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
