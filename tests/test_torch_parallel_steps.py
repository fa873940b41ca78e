"""Data-parallel training of the port on 2 ranks (gloo, processes: see
``torch_parallel_ranks.py``) against the JAX package's data-parallel run on
a 2-device mesh of ``conftest.py``'s CPU devices.

In JAX the data-parallel step is the single-device step on the global
batch, sharded by GSPMD; each rank of the port steps on its own sample, so
every reduction over the batch must be global for the two to agree: BN's
moments (one sample per rank: per-rank statistics would differ at once),
the loss's mask count (half of sample 0's ground truth is 0, so the
shards' counts differ), D1/EPE and the summed gradients.

  * GCNet (maxdisparity 24, 64x96, global batch 2): the port's supervised
    step on each rank against JAX's step on ``parallel.make_mesh(data=2)``
    with ``shard_batch`` and ``replicate``, float64: the loss, D1/EPE,
    the applied gradients, the parameters after Adam and the BN running
    statistics at 1e-9 relative (gradients 0 in exact arithmetic at 1e-12
    absolute), as ``test_torch_train_zoo.check_train_step_f64``; both
    ranks' parameters the same bits.
  * DispNetC ``Cap_ds-mask`` (192x256 pairs, global batch 2 with ground
    truth): the same against JAX's self-supervised step, JAX's draws of
    the global batch injected, each rank taking its rows.
  * The ``Trainer`` on 2 ranks (loaders cut by ``rank_slice``) against
    JAX's ``Trainer(cfg, mesh=make_mesh(data=2))`` for one epoch and its
    validation, float32, with ``test_torch_trainer.py``'s configuration and
    tolerances; then a ``Trainer`` resumed on both ranks from rank 0's
    checkpoint.

Three tests (``--dist loadfile`` queues a file of three or fewer behind
the repo's longest file).
"""

import json
import os
import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsmnet_tpu import parallel as j_parallel
from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.train import TrainConfig as JTrainConfig
from dsmnet_tpu.train import Trainer as JTrainer
from dsmnet_tpu.train import state as j_state
from dsmnet_tpu.train import steps as j_steps
from dsmnet_tpu.train import trainer as j_trainer
from dsmnet_tpu_torch.interop import flatten
from dsmnet_tpu_torch.losses import parse_loss_name
from dsmnet_tpu_torch.models import create_model as t_create_model
from test_torch_photometric import jax_step_draws
from test_torch_train import _flat, _recording_adam, _relerr, _seeded_flax_variables
from test_torch_train_zoo import _F32_CASTS, LR, REL, ZERO_ATOL, _NoFloat32
from test_torch_trainer import MAXDISP, NET, _cfg, _flax_tree, _loader
from torch_parallel_ranks import Ranks, worker_cpus


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


def _jax_dp_step(make_step, model, variables, batch, *args):
    """JAX's step from ``variables`` at step 0 on a 2-device data mesh
    (state replicated, batch sharded): metrics, applied gradients, params
    and BN statistics, as numpy."""
    tx = _recording_adam()
    state = j_state.TrainState(variables["params"], variables.get("batch_stats", {}),
                               tx.init(variables["params"]), jnp.zeros((), jnp.int32))
    mesh = j_parallel.make_mesh(data=2)
    state = j_parallel.replicate(state, mesh)
    new, m = make_step(model, tx)(state, j_parallel.shard_batch(jnp.asarray(batch), mesh),
                                  LR, *args)
    return ({k: float(m[k]) for k in ("loss", "d1", "epe")}, _flat(new.opt_state[1]),
            _flat(new.params), _flat(new.batch_stats) if new.batch_stats else {})


def _check_ranks(r, jax_out, params0, zero):
    """Rank 0's step against JAX's, and every rank's metrics, gradients,
    parameters and buffers against rank 0's, to the bit."""
    ref, ref_grads, ref_params, ref_stats = jax_out
    o = r[0]
    for k in ("loss", "d1", "epe"):
        np.testing.assert_allclose(o[k], ref[k], rtol=REL, err_msg=k)
    assert set(o["grads"]) == set(ref_grads) == set(params0)
    for p, g in o["grads"].items():
        new_p = o["params"][p]
        if p in zero:
            assert np.abs(g).max() <= ZERO_ATOL and np.abs(ref_grads[p]).max() <= ZERO_ATOL, p
        else:
            assert _relerr(g, ref_grads[p]) <= REL, (p, _relerr(g, ref_grads[p]))
            assert _relerr(new_p, ref_params[p]) <= REL, (p, _relerr(new_p, ref_params[p]))
        # Adam applied the summed gradient: p - lr * g / (|g| + 1e-8)
        np.testing.assert_allclose(new_p, params0[p] - LR * g / (np.abs(g) + 1e-8),
                                   rtol=1e-12, atol=1e-15, err_msg=p)
    assert set(o["buffers"]) == set(ref_stats)
    for p, b in o["buffers"].items():
        assert _relerr(b, ref_stats[p]) <= REL, (p, _relerr(b, ref_stats[p]))
    for other in r[1:]:
        assert other["digest"] == o["digest"]
        assert [other[k] for k in ("loss", "d1", "epe")] == [o[k] for k in ("loss", "d1", "epe")]


def test_gcnet_dp_step_matches_jax_mesh_f64(rng, monkeypatch, tmp_path):
    n, h, w, maxdisp = 2, 64, 96, 24
    batch = rng.rand(n, h, w, 7)
    batch[..., 6] = batch[..., 6] * (maxdisp - 2) + 1
    batch[0, : h // 2, :, 6] = 0.0  # half of sample 0 invalid: unequal mask counts
    tm = t_create_model("gcnet", maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    weights = parse_loss_name("supervised", tm.count_levels, 10).weights(3).astype(np.float64)
    zero = chip_smoke.zero_gradient_params(tm)
    for mod in _F32_CASTS:
        monkeypatch.setattr(mod, "jnp", _NoFloat32())
    with jax.enable_x64():
        model = j_create_model("gcnet", maxdisparity=maxdisp)
        v = _seeded_flax_variables(model, tm, h, w, rng)
        v_np = jax.tree.map(np.asarray, v)  # the step donates (deletes) its state
        # the ranks step while JAX does
        with Ranks("supervised_step", 2, tmp_path, {
                "net": "gcnet", "maxdisp": maxdisp, "params": v_np["params"],
                "batch_stats": v_np["batch_stats"], "batch": batch, "weights": weights,
                "lr": LR}, timeout=240) as ranks:
            jax_out = _jax_dp_step(j_steps.make_supervised_train_step, model, v, batch,
                                   jnp.asarray(weights))
            r = ranks.results()
    assert [o["step"] for o in r] == [1, 1]
    _check_ranks(r, jax_out, _flat(v_np["params"]), zero)
    # the running statistics moved (from the global batch's moments)
    stats0 = _flat(v_np["batch_stats"])
    assert all(not np.array_equal(b, stats0[p]) for p, b in r[0]["buffers"].items())


def test_dispnetc_selfsup_dp_step_matches_jax_mesh_f64(rng, monkeypatch, tmp_path):
    n, h, w, maxdisp, nedge = 2, 192, 256, 24, 64
    batch = rng.rand(n, h, w, 7)
    batch[..., 6] = batch[..., 6] * (maxdisp - 2) + 1
    batch[0, : h // 2, :, 6] = 0.0
    tm = t_create_model("dispnetcorr", maxdisp).reset_parameters(
        torch.Generator().manual_seed(0))
    weights = parse_loss_name("Cap_ds-mask", tm.count_levels, 10).weights(3).astype(np.float64)
    for mod in _F32_CASTS:
        monkeypatch.setattr(mod, "jnp", _NoFloat32())
    with jax.enable_x64():
        model = j_create_model("dispnetcorr", maxdisparity=maxdisp)
        v = _seeded_flax_variables(model, tm, h - 2 * nedge, w - 2 * nedge, rng)
        params = jax.tree.map(np.asarray, v["params"])
        key = jax.random.PRNGKey(11)
        draws = jax_step_draws(key, 0, n)  # the global batch's draws
        cfg = j_steps.PhotoLossConfig("cap", True, True, False)
        make = lambda m, tx: j_steps.make_selfsup_train_step(m, tx, cfg, nedge)
        with Ranks("selfsup_step", 2, tmp_path, {
                "net": "dispnetcorr", "maxdisp": maxdisp, "params": params, "batch": batch,
                "weights": weights, "lr": LR, "loss_name": "Cap_ds-mask", "nedge": nedge,
                "draws": draws}, timeout=240) as ranks:
            jax_out = _jax_dp_step(make, model, v, batch, jnp.asarray(weights), key)
            r = ranks.results()
    assert jax_out[0]["d1"] > 0  # the views' ground truth gives D1/EPE
    _check_ranks(r, jax_out, _flat(params), chip_smoke.zero_gradient_params(tm))


def test_trainer_on_two_ranks_matches_jax_mesh_and_resumes(tmp_path, monkeypatch):
    """DispNet, maxdisparity 32, 64x96 (``test_torch_trainer.py``'s
    configuration): two float32 steps of global batch 2 and a validation of
    two batches."""
    tree = _flax_tree(t_create_model(NET, MAXDISP).reset_parameters(
        torch.Generator().manual_seed(0)))

    def create_train_state(model, rng, beta1=0.9, beta2=0.999):
        tx = j_state.make_optimizer(beta1, beta2)
        params = jax.tree.map(jnp.asarray, tree["params"])
        return j_state.TrainState(params, {}, tx.init(params), jnp.zeros((), jnp.int32)), tx

    monkeypatch.setattr(j_trainer, "create_train_state", create_train_state)
    # JAX's checkpoints (~1 GB of DispNet) are not compared: only its history
    monkeypatch.setattr(j_trainer, "save_checkpoint", lambda *a, **k: None)
    w0 = str(tmp_path / "w0.msgpack")
    with open(w0, "wb") as f:  # as JAX's save_checkpoint writes weight_best.msgpack
        f.write(flax.serialization.msgpack_serialize({"params": tree["params"]}))
    # the same loaders (4 samples, global batches of 2), each rank its slice;
    # then a Trainer resumed on both ranks from rank 0's checkpoint
    payload = {"n": 4, "hw": (64, 96), "batch": 2,
               "cfg": _cfg(tmp_path / "torch", path_weight=w0),
               "resume_cfg": _cfg(tmp_path / "torch", path_weight=w0, epochs=2, lr_epoch0=1,
                                  lr_stride=1)}
    with Ranks("trainer", 2, tmp_path, payload, timeout=240) as ranks:  # beside JAX's
        jt = JTrainer(JTrainConfig(**_cfg(tmp_path / "jax")), loader_train=_loader(shuffle=True),
                      loader_val=_loader(), mesh=j_parallel.make_mesh(data=2))
        jt.start()
        r = ranks.results()
    with open(os.path.join(jt.dirpath, "loss_history.json")) as f:
        j_hist = json.load(f)
    after = flatten(jax.device_get(jt.state.params))

    lr = payload["cfg"]["lr"]
    o = r[0]
    for rank_out in r:
        assert (rank_out["epoch0"], rank_out["step0"], rank_out["step"]) == (0, 0, 2)
        assert rank_out["hist"] == o["hist"] and rank_out["digest"] == o["digest"]
        # rank 0 wrote the files before any rank went on
        assert rank_out["files"] == ["loss_history.json", "model_best.pt",
                                     "model_checkpoint.pt", "weight_best.pt"]
        # the resume: the next epoch and step, this rank's state and moments
        res = rank_out["resumed"]
        assert (res["epoch0"], res["step0"]) == (1, 2)
        assert res["same_state"] and res["same_moments"] and res["moments_nonzero"]
    t_hist = o["hist"]
    assert t_hist["epochs_val"] == j_hist["epochs_val"] == [0]
    for key in ("loss", "epe", "loss_val", "epe_val"):
        np.testing.assert_allclose(t_hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    for key in ("d1", "d1_val"):
        np.testing.assert_allclose(t_hist[key], j_hist[key], atol=0.05, err_msg=key)
    # Adam's first steps move a weight by about lr whatever its gradient's
    # size: test_torch_trainer.py's bounds
    assert set(o["state"]) == set(after)
    diffs = np.concatenate([np.abs(o["state"][k] - after[k]).ravel() for k in after])
    assert diffs.max() <= 4 * lr, diffs.max() / lr
    assert np.quantile(diffs, 0.99) <= 0.05 * lr, np.quantile(diffs, 0.99) / lr
    assert np.quantile(diffs, 0.9) <= 1e-3 * lr, np.quantile(diffs, 0.9) / lr
