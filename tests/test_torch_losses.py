"""The pieces of the PyTorch port's train step around the model, against
the JAX package's, on the CPU with the same numpy inputs (made from a
seed) on both sides, in float64:

  * the supervised pyramid loss, ``d1_epe``, the loss-name parser (its
    photometric names field by field), the level curriculum and the LR
    schedule;
  * one Adam update of ``make_optimizer`` against optax ``scale_by_adam``
    followed by ``-lr * u``.

The whole step is in ``test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsmnet_tpu import losses as j_losses
from dsmnet_tpu.train import metrics as j_metrics
from dsmnet_tpu.train import state as j_state
from dsmnet_tpu_torch import losses as t_losses
from dsmnet_tpu_torch.train import d1_epe, lr_for_epoch, make_optimizer


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _disparities(rng, n, h, w):
    """A prediction and a ground truth with some invalid (0) pixels."""
    pred = rng.rand(n, h, w, 1) * 20
    gt = rng.rand(n, h, w, 1) * 20
    gt[rng.rand(n, h, w, 1) < 0.2] = 0.0
    return pred, gt


@pytest.mark.parametrize("flag_smooth", [True, False])
def test_supervised_loss_matches_jax_f64(flag_smooth, rng):
    """Three heads at scales [0, 0, 0] (PSMNet) and a pyramid at [0, 1]:
    the weights are indexed by scale, a level > 0 is upsampled."""
    gt = _disparities(rng, 2, 8, 12)[1]
    heads = [rng.rand(2, 8, 12, 1) * 20 for _ in range(3)]
    pyramid = [rng.rand(2, 8, 12, 1) * 20, rng.rand(2, 4, 6, 1) * 20]
    for disps, scales, weights in ((heads, [0, 0, 0], np.array([0.7])),
                                   (pyramid, [0, 1], np.array([0.3, 0.9]))):
        with jax.enable_x64():
            ref = float(j_losses.supervised_pyramid_loss(
                jnp.asarray(gt), [jnp.asarray(d) for d in disps], scales, jnp.asarray(weights),
                flag_smooth))
        out = t_losses.supervised_pyramid_loss(
            torch.from_numpy(gt), [torch.from_numpy(d) for d in disps], scales, weights,
            flag_smooth)
        np.testing.assert_allclose(out.item(), ref, rtol=1e-12, atol=1e-12)


def test_d1_epe_matches_jax_f64(rng):
    pred, gt = _disparities(rng, 2, 16, 20)
    with jax.enable_x64():
        ref = [float(v) for v in j_metrics.d1_epe(jnp.asarray(pred), jnp.asarray(gt))]
    out = [v.item() for v in d1_epe(torch.from_numpy(pred), torch.from_numpy(gt))]
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    # no valid pixel: (0, 0), not NaN
    zero = [v.item() for v in d1_epe(torch.from_numpy(pred), torch.zeros_like(
        torch.from_numpy(gt)))]
    assert zero == [0.0, 0.0]


def test_loss_names_curriculum_and_lr_schedule():
    for levels, maxepoch in ((1, 1), (4, 10), (6, 7)):
        for epoch in range(12):
            np.testing.assert_array_equal(
                t_losses.weight_adjust_levels(epoch, levels, maxepoch),
                j_losses.weight_adjust_levels(epoch, levels, maxepoch))
    spec = t_losses.parse_loss_name("supervised", 4, 10)
    assert spec.supervised and spec.count_levels == 4
    np.testing.assert_array_equal(spec.weights(3), j_losses.parse_loss_name(
        "supervised", 4, 10).weights(3))
    for name in ("depthmono-mask", "SsSMnet", "Cap_ds_lr", "common"):
        t, j = t_losses.parse_loss_name(name, 4, 10), j_losses.parse_loss_name(name, 4, 10)
        assert (t.name, t.supervised, t.flag_mask) == (j.name, j.supervised, j.flag_mask)
        assert dataclasses.asdict(t.photo) == dataclasses.asdict(j.photo), name
        np.testing.assert_array_equal(t.weights(3), j.weights(3))
    with pytest.raises(ValueError, match="unknown loss"):
        t_losses.parse_loss_name("nonsense")
    for epoch in range(0, 30, 3):
        assert lr_for_epoch(epoch, 1e-3, 10, 5) == j_state.lr_for_epoch(epoch, 1e-3, 10, 5)


def test_adam_update_matches_optax_f64(rng):
    """Two steps with the learning rate set per step, as the train step
    sets it: p <- p - lr * scale_by_adam(eps=1e-8)(g)."""
    shapes = [(3, 3, 4), (5,)]
    params = [rng.randn(*s) for s in shapes]
    grads = [[rng.randn(*s) for s in shapes] for _ in range(2)]
    lrs = [1e-3, 5e-4]
    with jax.enable_x64():
        tx = j_state.make_optimizer()
        p = [jnp.asarray(a) for a in params]
        s = tx.init(p)
        for g, lr in zip(grads, lrs):
            u, s = tx.update([jnp.asarray(a) for a in g], s, p)
            p = [a - lr * b for a, b in zip(p, u)]
        ref = [np.asarray(a) for a in p]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = make_optimizer(tp)
    for g, lr in zip(grads, lrs):
        for t, a in zip(tp, g):
            t.grad = torch.from_numpy(a)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    for t, r in zip(tp, ref):
        np.testing.assert_allclose(t.detach().numpy(), r, rtol=1e-12, atol=1e-15)
