"""One supervised train step of GCNet, DispNet and DispNetC against the JAX step.

Same numpy batch, made from a seed, and the same weights (the port's
seeded weights, BN scale and bias perturbed, carried into the flax tree
and back by ``interop``) on both sides, in float64 on the CPU, where the
port's kernel wrappers take their plain versions (``chip_smoke.py`` holds
the kernels against those on the card).  The port's
``make_supervised_train_step`` against the JAX ``make_supervised_train_step``
(one ``jax.jit``, Adam recording the gradients it applied): the loss,
D1/EPE, every parameter's gradient, the parameters after the step and
the BN running statistics, each to 1e-9 relative.

The JAX package casts to float32 in a few places whatever the input dtype:
the soft-argmin and the trilinear regression (``ops/softargmin.py:27``,
``ops/regression.py:52,78``), the 3-D convs' custom VJPs
(``preferred_element_type``, ``ops/conv3d.py``), the warp's grid
(``ops/warp.py:51-52``) and the DispNet/iResNet heads
(``models/dispnet.py:74``, ``models/iresnet.py:147``); the port keeps
float64 there for a float64 model.  So the JAX step runs with
``jnp.float32`` read as ``jnp.float64`` in those modules (``_NoFloat32``):
the same code and sums at the test's precision.  Those ops' float32
behaviour is held against the port elsewhere (``test_torch_zoo.py``,
``test_torch_grads.py``, ``test_torch_train.py``).

Two kinds of gradient are 0 in exact arithmetic, so they are held in
absolute terms, at 1e-12 on both sides: the bias of a conv that feeds a
BN (the BN subtracts it again) and GCNet's l37 bias (the soft-argmin is
shift-invariant).

This file keeps three heavy tests (``--dist loadfile`` queues files by
their number of tests: a file of three or fewer queues behind the repo's
longest file, ``test_train_zoo.py``); PSMNet-basic and iResNet are in
``test_torch_train_spp_iresnet.py``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.models import dispnet as j_dispnet
from dsmnet_tpu.models import iresnet as j_iresnet
from dsmnet_tpu.ops import conv3d as j_conv3d
from dsmnet_tpu.ops import regression as j_regression
from dsmnet_tpu.ops import softargmin as j_softargmin
from dsmnet_tpu.ops import warp as j_warp
from dsmnet_tpu.train import state as j_state
from dsmnet_tpu.train import steps as j_steps
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.losses import parse_loss_name
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step
from test_torch_train import _flat, _recording_adam, _relerr, _seeded_flax_variables
from torch_jax_dots import f64_convs_as_dots
from torch_parallel_ranks import worker_cpus

LR = 1e-3
REL, ZERO_ATOL = 1e-9, 1e-12


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    with worker_cpus():
        yield
    torch.set_num_threads(old)


class _NoFloat32:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


_F32_CASTS = (j_softargmin, j_regression, j_conv3d, j_warp, j_dispnet, j_iresnet)


def check_train_step_f64(name, maxdisp, n, h, w, rng, monkeypatch, convs_as_dots=False,
                         **kwargs):
    """One float64 supervised step of the port's ``name`` against the JAX
    step on the same batch and weights; returns the port's model.  With
    ``convs_as_dots`` the JAX step's large float64 convolutions run as
    matrix products (``torch_jax_dots``), which pays for PSMNet's 3-D
    convolutions and costs the smaller models more compilation than it
    saves."""
    batch = rng.rand(n, h, w, 7)
    batch[..., 6] = batch[..., 6] * (maxdisp - 2) + 1
    batch[0, :4, :, 6] = 0.0  # invalid ground truth
    tm = t_create_model(name, maxdisp, **kwargs).reset_parameters(
        torch.Generator().manual_seed(0))
    # the curriculum mid-sweep: two neighbouring scales weighted, 0.01 elsewhere
    weights = parse_loss_name("supervised", tm.count_levels, 10).weights(3).astype(np.float64)
    for mod in _F32_CASTS:
        monkeypatch.setattr(mod, "jnp", _NoFloat32())
    with jax.enable_x64(), (f64_convs_as_dots() if convs_as_dots else contextlib.nullcontext()):
        model = j_create_model(name, maxdisparity=maxdisp, **kwargs)
        v = _seeded_flax_variables(model, tm, h, w, rng)
        v_np = jax.tree.map(np.asarray, v)  # the step donates (deletes) its state
        tx = _recording_adam()
        state = j_state.TrainState(v["params"], v.get("batch_stats", {}), tx.init(v["params"]),
                                   jnp.zeros((), jnp.int32))
        new, jm = j_steps.make_supervised_train_step(model, tx)(
            state, jnp.asarray(batch), LR, jnp.asarray(weights))
        ref = {k: float(jm[k]) for k in ("loss", "d1", "epe")}
        ref_grads, ref_params = _flat(new.opt_state[1]), _flat(new.params)
        ref_stats = _flat(new.batch_stats) if new.batch_stats else {}
    params0, stats0 = _flat(v_np["params"]), _flat(v_np.get("batch_stats", {}))

    tm = t_create_model(name, maxdisp, **kwargs).double()  # fresh: every leaf from flax
    interop.load_flax_variables(tm, v_np["params"], v_np.get("batch_stats", {}))
    tstate, opt = create_train_state(tm, device="cpu")
    out = make_supervised_train_step(tm, opt)(tstate, torch.from_numpy(batch), LR, weights)
    assert tstate.step == 1

    for k in ("loss", "d1", "epe"):
        np.testing.assert_allclose(out[k].item(), ref[k], rtol=REL, err_msg=k)
    named = dict(tm.named_parameters())
    assert set(named) == set(ref_grads) == set(params0)
    zero = chip_smoke.zero_gradient_params(tm)
    assert zero <= set(named)
    for p, t in named.items():
        g, new_p = t.grad.numpy(), t.detach().numpy()
        if p in zero:
            assert np.abs(g).max() <= ZERO_ATOL and np.abs(ref_grads[p]).max() <= ZERO_ATOL, p
        else:
            assert _relerr(g, ref_grads[p]) <= REL, (p, _relerr(g, ref_grads[p]))
            assert _relerr(new_p, ref_params[p]) <= REL, (p, _relerr(new_p, ref_params[p]))
        # the port's Adam applied its own gradient: p - lr * g / (|g| + 1e-8)
        np.testing.assert_allclose(new_p, params0[p] - LR * g / (np.abs(g) + 1e-8),
                                   rtol=1e-12, atol=1e-15, err_msg=p)
    buffers = dict(tm.named_buffers())
    assert set(buffers) == set(ref_stats)
    for p, t in buffers.items():
        assert not np.array_equal(t.numpy(), stats0[p]), p
        assert _relerr(t.numpy(), ref_stats[p]) <= REL, (p, _relerr(t.numpy(), ref_stats[p]))
    return tm


def test_gcnet_train_step_matches_jax_f64(rng, monkeypatch):
    """GCNet at 64x96, maxdisparity 24 (a 12-slice volume, even down to l30's
    input), batch 2: BN statistics pooled over both views by the batch-2N
    tower pass, the 3-D hourglass and its deconvs, the l31/l32 128 -> 128
    convs whose dK kernel F computes on the card."""
    tm = check_train_step_f64("gcnet", 24, 2, 64, 96, rng, monkeypatch)
    assert len(chip_smoke.zero_gradient_params(tm)) == 20  # conv1, l19..l36, l37


def test_dispnet_train_step_matches_jax_f64(rng, monkeypatch):
    """DispNet at 64x128, batch 2: the seven-scale pyramid loss with the
    curriculum's weights, the Cout = 1 heads' backward."""
    check_train_step_f64("dispnet", 24, 2, 64, 128, rng, monkeypatch)


def test_dispnetc_train_step_matches_jax_f64(rng, monkeypatch):
    """DispNetC at 64x128, batch 2: the correlation's backward, as JAX's
    jnp VJP, through the siamese conv1/conv2."""
    check_train_step_f64("dispnetcorr", 24, 2, 64, 128, rng, monkeypatch)
