"""The port's ``Trainer`` (``dsmnet_tpu_torch.train.trainer``) against the
JAX package's, and its checkpoints, resume, finetune and submit.

  * One epoch of DispNet (maxdisparity 32, 64x96 samples, as
    ``tests/test_train.py``'s trainer tests), two float32 steps of batch 2
    and a validation, in both trainers from the same weights (the port's
    seeded weights as JAX's initial state, then written as JAX writes a
    weight file and read by the port's ``load_weights``) and the same
    batches (two identical seeded loaders).  The epoch's mean train and validation loss, D1 and EPE
    agree to 1e-4 relative (float32 convolutions in two libraries, summed
    in other orders: ~1e-6 relative after a step), D1 to 0.05 points (a
    pixel at the 3 px / 5% threshold moves it by 100 / (2 x 64 x 96) =
    0.008).  Adam's first steps move a weight by about lr whatever its
    gradient's size, so where float32 rounding flips a tiny gradient's
    sign the weights may differ by up to 2 lr per step: each weight is held
    to 4 lr absolute over the two steps, 99% of them to 0.05 lr and 90% to
    1e-3 lr (measured: at most 2.04 lr, 99% within 0.0079 lr, 90% within
    0.0002 lr).
    The JAX checkpoint after the epoch, read by ``load_weights``, gives
    JAX's params exactly.
  * Resume, finetune and submit, as ``tests/test_train.py`` drives the
    JAX trainer: resume continues at the next epoch with
    ``lr_for_epoch``'s rate; finetune loads the weights and has no
    curriculum (its level weights equal JAX's for the same config);
    submit writes uint16 PNGs that read back as the disparity x 256, and a
    second call returns the cached results.
  * A JAX checkpoint of a model with BN statistics (GCNet's tree, written
    by JAX's ``save_checkpoint``): ``load_weights`` takes its
    ``state.params`` and ``state.batch_stats`` exactly, and the weights-only
    file its params.

Three tests (``--dist loadfile`` queues a file of three or fewer behind
``test_train_zoo.py``).
"""

import dataclasses
import json
import os
import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dsmnet_tpu.losses import parse_loss_name as j_parse_loss_name
from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.train import TrainConfig as JTrainConfig
from dsmnet_tpu.train import Trainer as JTrainer
from dsmnet_tpu.train import state as j_state
from dsmnet_tpu.train import trainer as j_trainer
from dsmnet_tpu_torch.data import BatchLoader, SyntheticStereoDataset, eval_transform
from dsmnet_tpu_torch.images import read_png16
from dsmnet_tpu_torch.interop import flatten
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.train import TrainConfig, Trainer, load_weights, lr_for_epoch
from torch_parallel_ranks import worker_cpus


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


NET, MAXDISP, HW = "dispnet", 32, (64, 96)


def _loader(n=4, batch=2, shuffle=False, seed=0):
    ds = SyntheticStereoDataset(n=n, hw=HW, max_disp=16, transform=eval_transform())
    return BatchLoader(ds, batch_size=batch, shuffle=shuffle, num_workers=1, seed=seed)


def _cfg(tmp_path, **kw):
    base = dict(mode="train", epochs=1, net=NET, maxdisparity=MAXDISP, loss_name="supervised",
                lr=1e-4, val_freq=1, print_freq=100, batchsize=2, output=str(tmp_path / "out"),
                dataset="synthetic")
    return {**base, **kw}


def _flax_tree(tm: torch.nn.Module) -> dict:
    """{params, batch_stats} of the port model's values, nested by the flax
    paths its names spell."""
    tree = {"params": {}, "batch_stats": {}}
    buffers = {k for k, _ in tm.named_buffers()}
    for k, v in tm.state_dict().items():
        node = tree["batch_stats" if k in buffers else "params"]
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v.numpy().copy()
    return tree


def test_trainer_epoch_matches_jax(tmp_path, monkeypatch):
    # JAX's trainer starts from the port's seeded weights (its own init
    # would take ~10 s of compilation on the CPU)
    tree = _flax_tree(t_create_model(NET, MAXDISP).reset_parameters(
        torch.Generator().manual_seed(0)))

    def create_train_state(model, rng, beta1=0.9, beta2=0.999):
        tx = j_state.make_optimizer(beta1, beta2)
        params = jax.tree.map(jnp.asarray, tree["params"])
        return j_state.TrainState(params, {}, tx.init(params), jnp.zeros((), jnp.int32)), tx

    monkeypatch.setattr(j_trainer, "create_train_state", create_train_state)
    jt = JTrainer(JTrainConfig(**_cfg(tmp_path / "jax")), loader_train=_loader(shuffle=True),
                  loader_val=_loader())
    w0 = str(tmp_path / "w0.msgpack")
    with open(w0, "wb") as f:  # as JAX's save_checkpoint writes weight_best.msgpack
        f.write(flax.serialization.msgpack_serialize(
            {"params": flax.serialization.to_state_dict(jax.device_get(jt.state.params))}))
    tt = Trainer(TrainConfig(**_cfg(tmp_path / "torch", path_weight=w0), device="cpu"),
                 loader_train=_loader(shuffle=True), loader_val=_loader())
    initial = flatten(tree["params"])
    for k, p in tt.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), initial[k])

    jt.start()
    t_hist = tt.start()
    with open(os.path.join(jt.dirpath, "loss_history.json")) as f:
        j_hist = json.load(f)
    assert t_hist["epochs_val"] == j_hist["epochs_val"] == [0]
    for key in ("loss", "epe", "loss_val", "epe_val"):
        np.testing.assert_allclose(t_hist[key], j_hist[key], rtol=1e-4, err_msg=key)
    for key in ("d1", "d1_val"):
        np.testing.assert_allclose(t_hist[key], j_hist[key], atol=0.05, err_msg=key)

    lr = tt.cfg.lr
    after = flatten(jax.device_get(jt.state.params))
    diffs = np.concatenate([np.abs(p.detach().numpy() - after[k]).ravel()
                            for k, p in tt.model.named_parameters()])
    assert diffs.max() <= 4 * lr, diffs.max() / lr
    assert np.quantile(diffs, 0.99) <= 0.05 * lr, np.quantile(diffs, 0.99) / lr
    assert np.quantile(diffs, 0.9) <= 1e-3 * lr, np.quantile(diffs, 0.9) / lr
    # JAX's checkpoint after the epoch through the port's reader: JAX's params
    jm = t_create_model(NET, MAXDISP)
    load_weights(os.path.join(jt.dirpath, "model_checkpoint.msgpack"), jm)
    for k, p in jm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), after[k])


def test_trainer_resume_finetune_submit(tmp_path):
    loader = _loader(n=2)
    t = Trainer(TrainConfig(**_cfg(tmp_path), device="cpu"), loader_train=loader,
                loader_val=loader)
    t.start()
    for name in ("model_checkpoint.pt", "model_best.pt", "weight_best.pt", "loss_history.json"):
        assert os.path.exists(os.path.join(t.dirpath, name)), name
    trained = {k: v.clone() for k, v in t.model.state_dict().items()}

    # resume: the next epoch, at lr_for_epoch's rate, from the saved weights
    cfg2 = TrainConfig(**_cfg(tmp_path, epochs=2, lr_epoch0=1, lr_stride=1), device="cpu")
    t2 = Trainer(cfg2, loader_train=loader, loader_val=loader)
    assert t2.epoch == 1 and t2.state.step == 1
    for k, v in t2.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    hist = t2.start()
    assert len(hist["loss"]) == 2 and t2.state.step == 2
    assert t2.lr == lr_for_epoch(1, 1e-4, 1, 1) == 5e-5

    # finetune: the weights loaded, no curriculum, level weights as JAX's
    weight_path = os.path.join(t.dirpath, "weight_best.pt")
    ft = _cfg(tmp_path, mode="finetune", output=str(tmp_path / "ft"), path_weight=weight_path)
    tf = Trainer(TrainConfig(**ft, device="cpu"), loader_train=loader, loader_val=loader)
    for k, v in tf.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    for mode, spec in (("finetune", tf.spec), ("train", t.spec)):
        cfg = JTrainConfig(**_cfg(tmp_path, mode=mode))
        adjust = 0 if mode == "finetune" else int(cfg.lr_epoch0 * 3 // 4)
        levels = j_create_model(NET, MAXDISP).count_levels
        jspec = j_parse_loss_name(cfg.loss_name, levels, max(adjust, 1))
        if mode == "finetune":
            jspec = dataclasses.replace(jspec, maxepoch_weight_adjust=0)
        for epoch in (0, 5, 40):
            np.testing.assert_array_equal(spec.weights(epoch), jspec.weights(epoch))
    assert tf.spec.weights(0)[0] == 1.0

    # submit: uint16 PNGs of the disparity x 256, then the cached results
    sub = Trainer(TrainConfig(**_cfg(tmp_path, mode="submit", batchsize=1, flag_model="t",
                                     path_weight=weight_path), device="cpu"),
                  loader_val=_loader(n=2, batch=1))
    out_dir = str(tmp_path / "submit")
    res = sub.submit(out_dir=out_dir)
    assert res["filename"] == ["synthetic_000000.png", "synthetic_000001.png"]
    assert len(res["D1"]) == len(res["epe"]) == 2
    for i, (batch, _) in enumerate(_loader(n=2, batch=1)):
        disp = sub._eval_step(sub.state, torch.from_numpy(batch), sub._weights(0))["disp"]
        want = np.clip(disp[0, :, :, 0].numpy() * 256.0, 0, 65535).astype(np.uint16)
        got = read_png16(os.path.join(out_dir, "synthetic_t", f"synthetic_{i:06d}.png"))
        np.testing.assert_array_equal(got, want)
    assert sub.submit(out_dir=out_dir) == res


def test_load_weights_reads_jax_checkpoint(tmp_path, rng):
    """GCNet's tree (BN statistics included), random values, written by
    JAX's ``save_checkpoint`` as a best checkpoint."""
    tm = t_create_model("gcnet", 32)
    with torch.no_grad():
        for v in tm.state_dict().values():
            v.copy_(torch.from_numpy(rng.standard_normal(tuple(v.shape))))
    tree = _flax_tree(tm)
    opt_state = optax.scale_by_adam().init(tree["params"])
    state = j_state.TrainState(tree["params"], tree["batch_stats"], opt_state, np.int32(7))
    d = str(tmp_path / "ckpt")
    j_state.save_checkpoint(d, state, epoch=3, best_prec=1.5, is_best=True)

    want = {**flatten(tree["params"]), **flatten(tree["batch_stats"])}
    got = load_weights(os.path.join(d, "model_checkpoint.msgpack"), t_create_model("gcnet", 32))
    for k, v in got.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    got = load_weights(os.path.join(d, "weight_best.msgpack"), t_create_model("gcnet", 32))
    for k, p in got.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[k], err_msg=k)
