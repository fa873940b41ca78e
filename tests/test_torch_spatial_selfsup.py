"""The self-supervised path under spatial (H) sharding, on gloo ranks
(processes: ``torch_parallel_ranks.py``), float64 unless stated.

  * GCNet ``Cap_ds-mask`` on a (1, 2) mesh: one banded train step on a
    192x224 batch (64x96 crops, the thinnest the band rule allows: one row
    a rank at l30's output) against JAX's single-device
    ``make_selfsup_train_step`` with the same weights, batch and draws:
    the loss, D1/EPE, the gradients summed over the ranks, the parameters
    after Adam and the BN running statistics at 1e-9 relative, every rank
    the same bits; first, the eval step's loss, D1/EPE and its gathered
    disparity against one process's eval step (``test_torch_selfsup_step.py``
    holds that to JAX's).  JAX's own (2, 2) partition on
    XLA:CPU is not its single-device step at small GCNet sizes
    (``test_torch_spatial_steps.py``), so the single-device step is the
    reference.
  * The ``Trainer`` (GCNet ``Cap_ds-mask``, float32, one step of batch 2
    and a validation) on a (1, 2) mesh against one process's ``Trainer``.
  * DispNetC ``Cap_ds-mask``, which does not band, on a (1, 2) mesh: both
    ranks run the whole step, no halo and no per-image reduction, the
    bucket over the data group of one, against one process's step.

The ranks start before the reference is computed.  Three tests.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsmnet_tpu import losses as j_losses
from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.train import state as j_state
from dsmnet_tpu.train import steps as j_steps
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.data import BatchLoader, SyntheticStereoDataset, selfsup_eval_transform
from dsmnet_tpu_torch.losses import parse_loss_name
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.train import (TrainConfig, Trainer, create_train_state,
                                    draw_selfsup_params, selfsup_generator)
from dsmnet_tpu_torch.train import make_selfsup_eval_step, make_selfsup_train_step
from test_torch_parallel_steps import _check_ranks
from test_torch_photometric import jax_step_draws
from test_torch_train import _flat, _recording_adam, _relerr, _seeded_flax_variables
from test_torch_train_zoo import _F32_CASTS, LR, REL, _NoFloat32
from torch_parallel_ranks import Ranks, worker_cpus

LOSS = "Cap_ds-mask"
NEDGE = 64


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


def _batch(rng, n, h, w, maxdisp):
    batch = rng.rand(n, h, w, 7)
    batch[..., 6] = batch[..., 6] * (maxdisp - 2) + 1
    batch[0, : h // 2, :, 6] = 0.0  # the top of sample 0 invalid: unequal band counts
    return batch


def test_gcnet_selfsup_banded_step_matches_jax_f64(rng, monkeypatch, tmp_path):
    n, h, w, maxdisp = 1, 192, 224, 24
    batch, eval_batch = _batch(rng, n, h, w, maxdisp), _batch(rng, n, 64, 96, maxdisp)
    tm = t_create_model("gcnet", maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    weights = parse_loss_name(LOSS, tm.count_levels, 10).weights(3).astype(np.float64)
    for mod in _F32_CASTS:
        monkeypatch.setattr(mod, "jnp", _NoFloat32())
    with jax.enable_x64():
        model = j_create_model("gcnet", maxdisparity=maxdisp)
        v = _seeded_flax_variables(model, tm, h - 2 * NEDGE, w - 2 * NEDGE, rng)
        v_np = jax.tree.map(np.asarray, v)  # the step donates (deletes) its state
        key = jax.random.PRNGKey(11)
        cfg = j_losses.parse_loss_name(LOSS, 1, 10).photo
        with Ranks("selfsup_step", 2, tmp_path, {
                "net": "gcnet", "maxdisp": maxdisp, "params": v_np["params"],
                "batch_stats": v_np["batch_stats"], "batch": batch, "eval_batch": eval_batch,
                "weights": weights, "lr": LR, "loss_name": LOSS, "nedge": NEDGE,
                "draws": jax_step_draws(key, 0, n), "mesh": (1, 2)}, timeout=240) as ranks:
            tx = _recording_adam()
            state = j_state.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                                       jnp.zeros((), jnp.int32))
            new, m = j_steps.make_selfsup_train_step(model, tx, cfg, NEDGE)(
                state, jnp.asarray(batch), LR, jnp.asarray(weights), key)
            jax_out = ({k: float(m[k]) for k in ("loss", "d1", "epe")},
                       _flat(new.opt_state[1]), _flat(new.params), _flat(new.batch_stats))
            tm = t_create_model("gcnet", maxdisp).double()
            interop.load_flax_variables(tm, v_np["params"], v_np["batch_stats"])
            ev = {k: a.numpy() for k, a in make_selfsup_eval_step(tm, parse_loss_name(
                LOSS, 1, 10).photo)(None, torch.from_numpy(eval_batch), weights).items()}
            r = ranks.results()
    assert jax_out[0]["d1"] > 0 and ev["d1"] > 0  # the views' ground truth gives D1/EPE
    _check_ranks(r, jax_out, _flat(v_np["params"]), chip_smoke.zero_gradient_params(tm))
    stats0 = _flat(v_np["batch_stats"])
    assert all(not np.array_equal(b, stats0[p]) for p, b in r[0]["buffers"].items())
    for o in r:
        c = o["collectives"]  # halos exchanged, one bucket over the whole mesh
        assert c["halo_exchange"] > 0 and c["grad_bucket"] == 1 and o["grad_group_size"] == 2
        e = o["eval"]
        for k in ("loss", "d1", "epe"):
            np.testing.assert_allclose(e[k], ev[k], rtol=REL, err_msg=k)
        assert e["disp"].shape == ev["disp"].shape == (n, 64, 96, 1)
        assert _relerr(e["disp"], ev["disp"]) <= REL


def _loader(hw, shuffle):
    ds = SyntheticStereoDataset(n=2, hw=hw, max_disp=16, transform=selfsup_eval_transform())
    return BatchLoader(ds, batch_size=2, shuffle=shuffle, num_workers=1, seed=0)


def test_trainer_selfsup_on_model_mesh_matches_one_process(tmp_path):
    """One float32 step (two 192x224 samples, 64x96 crops) and a validation
    at 64x96; GCNet bands both, so the ranks' float32 sums run in another
    order than the one process's: its histories at 1e-4, its weights within
    ``test_torch_trainer.py``'s bounds of Adam's first step (lr times the
    gradient's sign: only a sign that rounding flips moves a weight).  A
    gradient that is 0 in exact arithmetic (a bias that feeds a BN) is
    rounding noise on both sides, whose sign is either: those parameters
    are held by the bound on the largest difference alone."""
    cfg = dict(mode="train", epochs=1, net="gcnet", maxdisparity=24, loss_name=LOSS, lr=1e-4,
               val_freq=1, print_freq=100, batchsize=2, dataset="synthetic")
    payload = {"n": 2, "hw": (192, 224), "val_hw": (64, 96), "batch": 2, "selfsup": True,
               "cfg": {**cfg, "output": str(tmp_path / "ranks")}, "mesh": (1, 2)}
    with Ranks("trainer", 2, tmp_path, payload, timeout=240) as ranks:  # beside one process's
        one = Trainer(TrainConfig(**cfg, output=str(tmp_path / "one"), device="cpu"),
                      loader_train=_loader((192, 224), True), loader_val=_loader((64, 96), False))
        hist = one.start()
        r = ranks.results()
    after = {k: v.numpy() for k, v in one.model.state_dict().items()}
    o = r[0]
    for rank_out in r:
        assert (rank_out["epoch0"], rank_out["step0"], rank_out["step"]) == (0, 0, 1)
        assert rank_out["hist"] == o["hist"] and rank_out["digest"] == o["digest"]
        assert rank_out["spatial_axis"] == "model" and rank_out["grad_group_size"] == 2
    assert o["hist"]["epochs_val"] == hist["epochs_val"] == [0]
    for key in ("loss", "epe", "loss_val", "epe_val"):
        np.testing.assert_allclose(o["hist"][key], hist[key], rtol=1e-4, err_msg=key)
    for key in ("d1", "d1_val"):
        np.testing.assert_allclose(o["hist"][key], hist[key], atol=0.05, err_msg=key)
    lr = cfg["lr"]
    params = dict(one.model.named_parameters())
    diff = {k: np.abs(o["state"][k] - after[k]).ravel() for k in params}
    assert max(d.max() for d in diff.values()) <= 4 * lr
    zero = chip_smoke.zero_gradient_params(one.model)
    diffs = np.concatenate([d for k, d in diff.items() if k not in zero])
    assert np.quantile(diffs, 0.99) <= 0.05 * lr, np.quantile(diffs, 0.99) / lr
    for k in set(after) - set(params):  # the BN running statistics
        np.testing.assert_allclose(o["state"][k], after[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_dispnetc_selfsup_runs_whole_on_model_mesh_f64(rng, tmp_path):
    n, h, w, maxdisp = 1, 192, 256, 24
    batch = _batch(rng, n, h, w, maxdisp)
    draws = draw_selfsup_params(selfsup_generator(5, 0), n)
    weights = parse_loss_name(LOSS, 7, 10).weights(3)  # DispNetC's 7 levels, mid-sweep
    with Ranks("selfsup_step", 2, tmp_path, {
            "net": "dispnetcorr", "maxdisp": maxdisp, "batch": batch, "lr": LR,
            "weights": weights, "loss_name": LOSS, "nedge": NEDGE, "draws": draws,
            "mesh": (1, 2)}, timeout=240) as ranks:
        tm = t_create_model("dispnetcorr", maxdisp).reset_parameters(
            torch.Generator().manual_seed(0)).double()  # the ranks' seed-0 weights
        state, opt = create_train_state(tm, device="cpu")
        ref = make_selfsup_train_step(tm, opt, parse_loss_name(LOSS).photo, NEDGE)(
            state, torch.from_numpy(batch), LR, weights, draws)
        r = ranks.results()
    for o in r:
        for k in ("loss", "d1", "epe"):
            np.testing.assert_allclose(o[k], ref[k].item(), rtol=REL, err_msg=k)
        # the whole step on both ranks: no halo, no per-image sum over model
        assert "halo_exchange" not in o["collectives"] and "model_sum" not in o["collectives"]
        assert o["grad_group_size"] == 1 and o["digest"] == r[0]["digest"]
    for k, p in tm.named_parameters():
        assert _relerr(r[0]["grads"][k], p.grad.numpy()) <= REL, k
        assert _relerr(r[0]["params"][k], p.detach().numpy()) <= REL, k
