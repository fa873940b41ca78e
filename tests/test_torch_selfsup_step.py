"""The port's self-supervised train and eval steps against JAX's, and the
self-supervised ``Trainer``, on the CPU.

  * One ``Cap_ds-mask`` train step of DispNetC (a 192x256 batch, so the
    64-pixel border leaves 64x128 for the model; batch 1, maxdisparity
    24) in float64: the same batch and weights (the port's seeded weights
    carried into the flax tree by ``interop``) and JAX's draws (recomputed
    from its key as its step splits it) injected into the port's step.
    The loss, every gradient and every parameter after Adam to 1e-9
    relative.  The JAX step runs with ``jnp.float32`` read as float64 in
    the modules that cast (``test_torch_train_zoo._NoFloat32``).
  * The BN running statistics of the double forward: a small model with
    one BN (DispNetC has none), ``depthmono-mask``: the second forward
    starts from the statistics the first left, as JAX threads them
    (``steps.py:138-145``); statistics, gradients and parameters against
    JAX's step at 1e-9 (a conv bias feeding the BN, 0 in exact
    arithmetic, at 1e-12 absolute), then the eval step's loss and
    disparity on the running statistics.  (JAX's eval step of DispNetC
    would take another ~17 s of compilation here.)
  * A self-supervised ``Trainer`` (DispNetC, ``Cap_ds-mask``, 192x256
    synthetic samples): an epoch of one step, then a resumed one that
    restarts the step counter where it stopped and draws from the
    generator of (seed + 1, step), as an unbroken run would; ``submit``
    writes its uint16 PNGs from 6-channel batches.

Three tests: ``--dist loadfile`` queues a file of three or fewer behind
the repo's longest file.
"""

import os
import shutil

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.models import layers as j_layers
from dsmnet_tpu.train import state as j_state
from dsmnet_tpu.train import steps as j_steps
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.data import BatchLoader, SyntheticStereoDataset, selfsup_eval_transform
from dsmnet_tpu_torch.images import read_png16
from dsmnet_tpu_torch.losses import parse_loss_name
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.models import layers as t_layers
from dsmnet_tpu_torch.train import trainer as trainer_module
from dsmnet_tpu_torch.train import (
    TrainConfig,
    Trainer,
    create_train_state,
    make_selfsup_eval_step,
    make_selfsup_train_step,
)
import chip_smoke
from test_torch_photometric import jax_step_draws
from test_torch_train import _flat, _recording_adam, _relerr, _seeded_flax_variables
from test_torch_train_zoo import _F32_CASTS, _NoFloat32
from torch_parallel_ranks import worker_cpus

LR, REL = 1e-3, 1e-9


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    with worker_cpus():
        yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _no_checkpoints_left(tmp_path):
    """The test's files go with it: the trainers' checkpoints (DispNet's are
    ~1 GB each) would fill the disk, since pytest keeps the temporary
    directories of the last three runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_selfsup_step(model, variables, batch, weights, cfg, nedge, key, evaluate):
    """JAX's train step from ``variables`` at step 0, then, if ``evaluate``,
    its eval step: (loss, grads, params, batch_stats, eval metrics or
    None), as numpy."""
    tx = _recording_adam()
    state = j_state.TrainState(variables["params"], variables.get("batch_stats", {}),
                               tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    new, m = j_steps.make_selfsup_train_step(model, tx, cfg, nedge)(
        state, jnp.asarray(batch), LR, jnp.asarray(weights), key)
    ev = None
    if evaluate:
        ev = {k: np.asarray(v) for k, v in j_steps.make_selfsup_eval_step(model, cfg)(
            new, jnp.asarray(batch), jnp.asarray(weights), key).items()}
    return (float(m["loss"]), _flat(new.opt_state[1]), _flat(new.params),
            _flat(new.batch_stats) if new.batch_stats else {}, ev)


def _check_against_jax(tm, loss_name, nedge, batch, jax_out, draws):
    """The port's step (and eval step) on ``tm`` against JAX's results."""
    ref_loss, ref_grads, ref_params, ref_stats, ref_eval = jax_out
    spec = parse_loss_name(loss_name, tm.count_levels, 10)
    weights = spec.weights(3).astype(np.float64)
    state, opt = create_train_state(tm, device="cpu")
    out = make_selfsup_train_step(tm, opt, spec.photo, nedge)(
        state, torch.from_numpy(batch), LR, weights, draws)
    assert state.step == 1
    np.testing.assert_allclose(out["loss"].item(), ref_loss, rtol=REL)
    assert out["d1"].item() == out["epe"].item() == -1.0  # a 6-channel batch
    named = dict(tm.named_parameters())
    assert set(named) == set(ref_grads)
    zero = chip_smoke.zero_gradient_params(tm)
    for p, t in named.items():
        g = t.grad.numpy()
        if p in zero:
            assert max(np.abs(g).max(), np.abs(ref_grads[p]).max()) <= 1e-12, p
        else:
            assert _relerr(g, ref_grads[p]) <= REL, (p, _relerr(g, ref_grads[p]))
            assert _relerr(t.detach().numpy(), ref_params[p]) <= REL, p
    buffers = dict(tm.named_buffers())
    assert set(buffers) == set(ref_stats)
    for p, t in buffers.items():
        assert _relerr(t.numpy(), ref_stats[p]) <= REL, (p, _relerr(t.numpy(), ref_stats[p]))
    if ref_eval is not None:
        ev = make_selfsup_eval_step(tm, spec.photo)(state, torch.from_numpy(batch), weights)
        np.testing.assert_allclose(ev["loss"].item(), ref_eval["loss"], rtol=REL)
        assert _relerr(ev["disp"].numpy(), ref_eval["disp"]) <= REL


def test_dispnetc_selfsup_step_matches_jax_f64(rng, monkeypatch):
    h, w, maxdisp = 192, 256, 24
    batch = rng.rand(1, h, w, 6)
    tm = t_create_model("dispnetcorr", maxdisp).reset_parameters(
        torch.Generator().manual_seed(0))
    spec = parse_loss_name("Cap_ds-mask", tm.count_levels, 10)
    for mod in _F32_CASTS:
        monkeypatch.setattr(mod, "jnp", _NoFloat32())
    with jax.enable_x64():
        model = j_create_model("dispnetcorr", maxdisparity=maxdisp)
        v = _seeded_flax_variables(model, tm, h - 128, w - 128, rng)
        params = jax.tree.map(np.asarray, v["params"])
        key = jax.random.PRNGKey(11)
        draws = jax_step_draws(key, 0, 1)
        jax_out = _jax_selfsup_step(model, v, batch, spec.weights(3).astype(np.float64),
                                    j_steps.PhotoLossConfig("cap", True, True, False), 64, key,
                                    evaluate=False)
    tm = t_create_model("dispnetcorr", maxdisp).double()
    interop.load_flax_variables(tm, params)
    _check_against_jax(tm, "Cap_ds-mask", 64, batch, jax_out, draws)


class _JaxBNModel(nn.Module):
    """Both views on channels, a 5x5 ConvBN (BN on batch statistics in
    train mode) and a 5x5 head: a one-level disparity."""

    count_levels: int = 1

    @nn.compact
    def __call__(self, imL, imR, train: bool = True):
        x = j_layers.ConvBN(4, 5, bn=True)(jnp.concatenate([imL, imR], -1), train)
        x = j_layers.ConvBN(1, 5, relu=False)(x, train)
        return [0], [3.0 + x]


class _TorchBNModel(torch.nn.Module):
    count_levels = 1

    def __init__(self):
        super().__init__()
        self.ConvBN_0 = t_layers.ConvBN(6, 4, 5, bn=True, use_bias=True)
        self.ConvBN_1 = t_layers.ConvBN(4, 1, 5, relu=False, use_bias=True)

    def forward(self, imL, imR):
        x = self.ConvBN_1(self.ConvBN_0(torch.cat([imL, imR], -1)))
        return [0], [3.0 + x]


def test_selfsup_step_threads_bn_statistics_as_jax_f64(rng):
    h, w = 160, 192
    batch = rng.rand(2, h, w, 6)
    jm = _JaxBNModel()
    with jax.enable_x64():
        v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 3)), jnp.zeros((1, 32, 64, 3)))
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) + 0.05 * rng.randn(*a.shape), v)
        v_np = jax.tree.map(np.asarray, v)
        key = jax.random.PRNGKey(4)
        draws = jax_step_draws(key, 0, 2)
        jax_out = _jax_selfsup_step(jm, v, batch, np.ones(1),
                                    j_steps.PhotoLossConfig("depthmono", True), 64, key,
                                    evaluate=True)
    tm = _TorchBNModel().double()
    interop.load_flax_variables(tm, v_np["params"], v_np["batch_stats"])
    stats0 = {k: t.clone() for k, t in tm.named_buffers()}
    _check_against_jax(tm, "depthmono-mask", 64, batch, jax_out, draws)
    # two momentum updates: from the first forward's batch statistics, then
    # from the second's, not two updates from the initial statistics
    for k, t in tm.named_buffers():
        assert not torch.equal(t, stats0[k]), k


def _loader(n, hw, with_gt=True):
    ds = SyntheticStereoDataset(n=n, hw=hw, max_disp=12, with_gt=with_gt,
                                transform=selfsup_eval_transform())
    return BatchLoader(ds, batch_size=1, shuffle=False, num_workers=1)


def test_selfsup_trainer_resume_and_submit(tmp_path, monkeypatch):
    """One epoch of one step and a validation, then a resumed epoch: each
    step draws from the generator of (seed + 1, its step), the resumed one
    too; then submit."""
    seeds = []
    draw = trainer_module.draw_selfsup_params
    monkeypatch.setattr(trainer_module, "draw_selfsup_params",
                        lambda g, n: (seeds.append(g.initial_seed()), draw(g, n))[1])
    base = dict(net="dispnetcorr", maxdisparity=24, loss_name="Cap_ds-mask", lr=1e-4,
                print_freq=100, batchsize=1, dataset="synthetic", device="cpu", seed=3,
                output=str(tmp_path / "out"))
    train, val = (lambda: _loader(1, (192, 256), False)), (lambda: _loader(1, (64, 96)))
    first = Trainer(TrainConfig(**base, epochs=1), loader_train=train(), loader_val=val())
    assert not first.spec.supervised and first.spec.flag_mask
    hist = first.start()
    assert first.state.step == 1 and np.isfinite(hist["loss"] + hist["loss_val"]).all()
    trained = {k: v.clone() for k, v in first.model.state_dict().items()}
    resumed = Trainer(TrainConfig(**base, epochs=2), loader_train=train(), loader_val=val())
    assert resumed.epoch == 1 and resumed.state.step == 1
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    hist = resumed.start()
    assert resumed.state.step == 2 and len(hist["loss"]) == 2
    assert seeds == [(4 << 32) + 0, (4 << 32) + 1]
    assert not any(torch.equal(v, trained[k]) for k, v in resumed.model.named_parameters())

    weights = os.path.join(resumed.dirpath, "weight_best.pt")
    sub = Trainer(TrainConfig(**{**base, "mode": "submit", "flag_model": "s",
                                 "path_weight": weights}), loader_val=_loader(2, (64, 96), False))
    res = sub.submit(out_dir=str(tmp_path / "submit"))
    assert res["filename"] == ["synthetic_000000.png", "synthetic_000001.png"]
    assert res["D1"] == [] and res["epe"] == []
    for i, (b, _) in enumerate(_loader(2, (64, 96), False)):
        b7 = torch.cat([torch.from_numpy(b), torch.zeros(b.shape[:-1] + (1,))], -1)
        disp = sub._eval_step(sub.state, b7, sub._weights(0))["disp"]
        png = read_png16(str(tmp_path / "submit" / "synthetic_s" / f"synthetic_{i:06d}.png"))
        np.testing.assert_array_equal(
            png, np.clip(disp[0, :, :, 0].numpy() * 256.0, 0, 65535).astype(np.uint16))
