"""Spatially sharded training of the port (H split over the ``model`` mesh
axis) on gloo ranks (processes: ``torch_parallel_ranks.py``).

  * GCNet (maxdisparity 24, 128x96, global batch 2), float64, on a (2, 2)
    mesh of 4 ranks: each rank steps on its data index's sample and its
    band of rows, against JAX's step on ``make_mesh(data=2, model=2)``
    under ``ShardingContext(spatial_axis="model")`` (GSPMD's halos): the
    loss, D1/EPE, the applied gradients, the parameters after Adam and the
    BN running statistics at 1e-9 relative (gradients 0 in exact
    arithmetic at 1e-12 absolute); every rank ends with the same bits.
    Half of sample 0's ground truth is invalid, so one rank's band holds
    no valid pixel.  On the same ranks, the same step at 64x96, the
    thinnest band the band rule allows (one row a rank at l30's output),
    against JAX's single-device step on the global batch; at that size
    XLA:CPU's partition of JAX's own (2, 2) step is not its single-device
    step (71 of 108 gradients off, some by whole factors of 4 and 8), so
    JAX's mesh is the reference at 128x96 only.  And GCNetLR's float64
    eval forward at 64x96 (maxdisparity 16) on the (2, 2) mesh, its bands
    gathered, against its forward in one process.
  * PSMNet (fused stem; 256x256, every SPP pool non-empty; maxdisparity 16),
    float64, on a (1, 2) mesh, a plain and a ``remat`` step, against the
    port's single-process step on the same batch and weights, which
    ``test_torch_train.py`` holds to JAX.
  * The ``Trainer`` (``test_torch_trainer.py``'s DispNet configuration) on
    a (1, 2) mesh against JAX's ``Trainer(mesh=make_mesh(data=1,
    model=2))``: DispNet does not band, so it runs whole on both ranks,
    each gradient counted once (the bucket sums over the data group).

The ranks start before the reference is computed.  Three tests.
"""

import json
import os
import shutil

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
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.interop import flatten
from dsmnet_tpu_torch.losses import parse_loss_name
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.models.gcnet import GCNetLR
from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step
from test_torch_parallel_steps import _check_ranks
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


def _batch(rng, n, h, w, maxdisp):
    batch = rng.rand(n, h, w, 7)
    batch[..., 6] = batch[..., 6] * (maxdisp - 2) + 1
    batch[0, : h // 2, :, 6] = 0.0  # the top band of sample 0 invalid
    return batch


def test_gcnet_spatial_step_matches_jax_mesh_f64(rng, monkeypatch, tmp_path):
    n, h, w, maxdisp = 2, 128, 96, 24
    batch = _batch(rng, n, h, w, maxdisp)
    tm = t_create_model("gcnet", maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    weights = parse_loss_name("supervised", tm.count_levels, 10).weights(3).astype(np.float64)
    for mod in _F32_CASTS:
        monkeypatch.setattr(mod, "jnp", _NoFloat32())
    with jax.enable_x64():
        model = j_create_model("gcnet", maxdisparity=maxdisp)
        v = _seeded_flax_variables(model, tm, h, w, rng)
        v_np = jax.tree.map(np.asarray, v)  # the step donates (deletes) its state
        thin = _batch(rng, n, 64, w, maxdisp)
        with Ranks("supervised_step", 4, tmp_path, {
                "net": "gcnet", "maxdisp": maxdisp, "params": v_np["params"],
                "batch_stats": v_np["batch_stats"], "batch": batch, "weights": weights,
                "lr": LR, "mesh": (2, 2), "thin_batch": thin, "gcnet_lr": 16},
                timeout=240) as ranks:
            jax_outs = []
            for mesh, b in ((j_parallel.make_mesh(data=2, model=2), batch), (None, thin)):
                tx = _recording_adam()
                params = jax.tree.map(jnp.asarray, v_np["params"])
                state = j_state.TrainState(params, jax.tree.map(jnp.asarray, v_np["batch_stats"]),
                                           tx.init(params), jnp.zeros((), jnp.int32))
                step = j_steps.make_supervised_train_step(model, tx)
                if mesh is None:  # one device: the semantics the mesh's step must meet
                    new, m = step(state, jnp.asarray(b), LR, jnp.asarray(weights))
                else:
                    state = j_parallel.replicate(state, mesh)
                    with j_parallel.activate(j_parallel.ShardingContext(mesh, "data", "model")):
                        new, m = step(state, j_parallel.shard_batch(jnp.asarray(b), mesh), LR,
                                      jnp.asarray(weights))
                jax_outs.append(({k: float(m[k]) for k in ("loss", "d1", "epe")},
                                 _flat(new.opt_state[1]), _flat(new.params),
                                 _flat(new.batch_stats)))
            lr_model = GCNetLR(16).reset_parameters(torch.Generator().manual_seed(0))
            with torch.no_grad():
                t = torch.from_numpy(thin)
                lr_maps = [d.numpy() for d in lr_model.double().eval()(t[..., :3], t[..., 3:6])]
            r = ranks.results()
    params0, zero = _flat(v_np["params"]), chip_smoke.zero_gradient_params(tm)
    for rs, jax_out in ((r, jax_outs[0]), ([o["thin"] for o in r], jax_outs[1])):
        assert [o["step"] for o in rs] == [1, 1, 1, 1]
        _check_ranks(rs, jax_out, params0, zero)
        for o in rs:  # halos exchanged, every reduction over the mesh, one bucket
            c = o["collectives"]
            assert c["halo_exchange"] > 0 and c["grad_bucket"] == 1 and c["bn_moments"] > 0
        # the running statistics moved (from the global batch's moments)
        stats0 = _flat(v_np["batch_stats"])
        assert all(not np.array_equal(b, stats0[p]) for p, b in rs[0]["buffers"].items())
    for o in r:  # GCNetLR: each rank gathers its data index's whole maps
        i = o["data_index"]
        for got, want in zip(o["lr"], lr_maps):
            assert got.shape == want[i:i + 1].shape
            np.testing.assert_allclose(got, want[i:i + 1], rtol=REL, atol=1e-12)


def _port_variables(tm, rng):
    """The port model's seeded parameters, BN scale and bias perturbed so
    their gradients are not the identity's, and its buffers, as trees
    nested by the flax paths their names spell."""
    params = {}
    for k, p in tm.named_parameters():
        t = p.detach().double().numpy().copy()
        if k.endswith(".scale"):
            t = t + 0.03 * rng.randn(*t.shape)
        elif k.endswith(".bias") and t.ndim == 1:
            t = t + 0.02 * rng.randn(*t.shape)
        params[k] = t
    return _flax_tree_of(params), _flax_tree_of(
        {k: b.double().numpy().copy() for k, b in tm.named_buffers()})


def _flax_tree_of(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        *parents, leaf = k.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def test_psmnet_spatial_steps_match_one_process_f64(rng, tmp_path):
    """The fused stem's halos, the hourglasses' stride-2 convs and deconvs
    on bands, the banded regression and loss; ``remat`` recomputes each
    hourglass in the backward, exchanging its halos again."""
    n, h, w, maxdisp = 1, 256, 256, 16
    batch = _batch(rng, n, h, w, maxdisp)
    tm = t_create_model("psmnet", maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    params, stats = _port_variables(tm, rng)
    weights = parse_loss_name("supervised", tm.count_levels, 10).weights(3).astype(np.float64)
    payload = {"net": "psmnet", "maxdisp": maxdisp, "params": params, "batch_stats": stats,
               "batch": batch, "weights": weights, "lr": LR, "mesh": (1, 2)}
    groups = [Ranks("supervised_step", 2, tmp_path / f"g{remat}",
                    {**payload, "kwargs": {"remat": remat}}, timeout=240)
              for remat in (False, True)]
    with groups[0], groups[1]:
        tm = t_create_model("psmnet", maxdisp).double()
        interop.load_flax_variables(tm, params, stats)
        params0 = {k: p.detach().numpy().copy() for k, p in tm.named_parameters()}
        state, opt = create_train_state(tm, device="cpu")
        m = make_supervised_train_step(tm, opt)(state, torch.from_numpy(batch), LR, weights)
        ref = {k: v.item() for k, v in m.items()}
        results = [g.results() for g in groups]
    zero = chip_smoke.zero_gradient_params(tm)
    for remat, r in zip((False, True), results):
        o = r[0]
        for k in ("loss", "d1", "epe"):
            np.testing.assert_allclose(o[k], ref[k], rtol=REL, err_msg=(remat, k))
        for k, p in tm.named_parameters():
            g = o["grads"][k]
            if k in zero:
                assert np.abs(g).max() <= ZERO_ATOL, (remat, k)
                continue
            assert _relerr(g, p.grad.numpy()) <= REL, (remat, k, _relerr(g, p.grad.numpy()))
            assert _relerr(o["params"][k], p.detach().numpy()) <= REL, (remat, k)
            np.testing.assert_allclose(o["params"][k], params0[k] - LR * g / (np.abs(g) + 1e-8),
                                       rtol=1e-12, atol=1e-15, err_msg=k)
        for k, b in tm.named_buffers():
            assert _relerr(o["buffers"][k], b.numpy()) <= REL, (remat, k)
        assert r[1]["digest"] == o["digest"]
        assert o["collectives"]["halo_exchange"] > 0
    # the recomputation exchanges the hourglasses' halos a second time
    assert results[1][0]["collectives"]["halo_exchange"] > \
        results[0][0]["collectives"]["halo_exchange"]


def test_trainer_on_model_mesh_matches_jax(tmp_path, monkeypatch):
    """DispNet, maxdisparity 32, 64x96 (``test_torch_trainer.py``'s
    configuration): two float32 steps of global batch 2 and a validation of
    two batches, on a (1, 2) mesh; both ranks run the whole model."""
    tree = _flax_tree(t_create_model(NET, MAXDISP).reset_parameters(
        torch.Generator().manual_seed(0)))

    def create_train_state_j(model, rng, beta1=0.9, beta2=0.999):
        tx = j_state.make_optimizer(beta1, beta2)
        params = jax.tree.map(jnp.asarray, tree["params"])
        return j_state.TrainState(params, {}, tx.init(params), jnp.zeros((), jnp.int32)), tx

    monkeypatch.setattr(j_trainer, "create_train_state", create_train_state_j)
    # JAX's checkpoints (~1 GB of DispNet) are not compared: only its history
    monkeypatch.setattr(j_trainer, "save_checkpoint", lambda *a, **k: None)
    cfg = _cfg(tmp_path / "torch")
    payload = {"n": 4, "hw": (64, 96), "batch": 2, "cfg": cfg, "mesh": (1, 2)}
    with Ranks("trainer", 2, tmp_path, payload, timeout=240) as ranks:  # beside JAX's
        jt = JTrainer(JTrainConfig(**_cfg(tmp_path / "jax")), loader_train=_loader(shuffle=True),
                      loader_val=_loader(), mesh=j_parallel.make_mesh(data=1, model=2))
        jt.start()
        r = ranks.results()
    with open(os.path.join(jt.dirpath, "loss_history.json")) as f:
        j_hist = json.load(f)
    after = flatten(jax.device_get(jt.state.params))

    lr = cfg["lr"]
    o = r[0]
    for rank_out in r:
        assert (rank_out["epoch0"], rank_out["step0"], rank_out["step"]) == (0, 0, 2)
        assert rank_out["hist"] == o["hist"] and rank_out["digest"] == o["digest"]
        assert rank_out["spatial_axis"] == "model" and rank_out["grad_group_size"] == 1
        assert rank_out["files"] == ["loss_history.json", "model_best.pt",
                                     "model_checkpoint.pt", "weight_best.pt"]
    t_hist = o["hist"]
    assert t_hist["epochs_val"] == j_hist["epochs_val"] == [0]
    for key in ("loss", "epe", "loss_val", "epe_val"):
        np.testing.assert_allclose(t_hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    for key in ("d1", "d1_val"):
        np.testing.assert_allclose(t_hist[key], j_hist[key], atol=0.05, err_msg=key)
    # test_torch_trainer.py's bounds: Adam's first steps move a weight by
    # about lr whatever its gradient's size
    assert set(o["state"]) == set(after)
    diffs = np.concatenate([np.abs(o["state"][k] - after[k]).ravel() for k in after])
    assert diffs.max() <= 4 * lr, diffs.max() / lr
    assert np.quantile(diffs, 0.99) <= 0.05 * lr, np.quantile(diffs, 0.99) / lr
    assert np.quantile(diffs, 0.9) <= 1e-3 * lr, np.quantile(diffs, 0.9) / lr
