"""Training driver of the port (``dsmnet_tpu/train/trainer.py``; the
reference's stereo.py + stereo_supervised.py + stereo_selfsupervised.py).

One ``Trainer`` owns the model, its optimizer, the loss spec, the
checkpoint directory and the epoch loop: per-epoch LR decay, the
level-weight curriculum (finetune skips it), validation, best-D1
checkpoints with auto-resume, an atomically written ``loss_history.json``,
an optional curve PNG (stereo.py:190-248) and ``submit``'s uint16 PNG
export.  It runs on ``cfg.device`` (``None`` = CUDA; without a card it
raises).  The weights are drawn from a torch generator seeded with
``cfg.seed`` (JAX draws them from ``PRNGKey(seed)``), unless
``path_weight`` names a ``.pt``, ``.npz`` or JAX ``.msgpack`` file.
The loss name picks the supervised or the self-supervised steps; the
latter crop a 64-pixel border with a ``-mask`` loss, and draw each step's
augmentation from a generator seeded by (``seed`` + 1, the step), so a
resumed run draws what an unbroken one would (JAX folds the step into
``PRNGKey(seed + 1)``).

With a ``mesh`` (``parallel.make_mesh``) every rank is a process of a
parallel run, as JAX's ``Trainer(cfg, mesh=...)``: the state is
replicated from the mesh's first rank, the steps run under a
``ShardingContext`` (global BN moments, losses, metrics; the gradients
summed over the ranks), each rank places its share of the global batch
by its ``data`` coordinate (``shard_batch`` of a global batch, or, from a
loader cut by ``rank_slice`` or under ``cfg.multihost``, its own batch
through ``global_batch_from_host_local``), and the meters count the
global batch.  A mesh with ``model`` > 1 also splits H over the ``model``
ranks (``ShardingContext(mesh, "data", "model")``, as JAX's trainer sets
``spatial``): PSMNet and GCNet train on bands of rows, the other models
run whole on every ``model`` rank; a photometric loss runs on the same
bands of the crops (its towers whole).  Checkpoints, the history, the
curves and ``submit``'s files are written by the primary rank, and every
rank waits at a barrier until they are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import logging
import os
import time

import numpy as np
import torch

from .. import config
from ..images import write_png16
from ..losses import LossSpec, parse_loss_name
from ..models import MODELS, create_model
from ..models.layers import compute_dtype
from ..parallel import (
    ShardingContext,
    activate,
    global_batch_from_host_local,
    is_primary_host,
    replicate,
    shard_batch,
)
from ..parallel.mesh import axis_index, axis_size
from ..parallel.multihost import barrier
from .metrics import AverageMeter
from .state import (
    create_train_state,
    load_checkpoint,
    load_weights,
    lr_for_epoch,
    save_checkpoint,
)
from .color_aug import draw_selfsup_params, selfsup_generator
from .steps import (
    make_selfsup_eval_step,
    make_selfsup_train_step,
    make_supervised_eval_step,
    make_supervised_train_step,
)

log = logging.getLogger(__name__)

__all__ = ["TrainConfig", "Trainer"]

# the profiler's window in the first epoch: steps [10, 15)
PROFILE_STEPS = (10, 15)


@dataclasses.dataclass
class TrainConfig:
    """CLI-facing configuration (reference main.py:16-38 argparse flags);
    every field of JAX's, and the device."""

    mode: str = "train"  # train | finetune | test | submit
    epochs: int = 150
    net: str = "dispnet"
    maxdisparity: int = 192
    loss_name: str = "supervised"
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    lr_epoch0: int = 50
    lr_stride: int = 20
    val_freq: int = 1
    print_freq: int = 20
    batchsize: int = 1
    output: str = "output"
    dataset: str = "kitti2015-tr"
    dataset_val: str = "kitti2015-tr"
    path_weight: str = ""
    flag_model: str = ""
    seed: int = 0
    plot_curves: bool = False  # matplotlib curve PNG per validation
    dtype: str = "float32"  # compute dtype of the convolutions: float32 | bfloat16
    profile_dir: str = ""  # torch.profiler trace of steps 10-15 of the first epoch
    remat: bool = False  # recompute heavy blocks in the backward (FLOPs for memory)
    device: str | None = None  # None = CUDA (under a process group: cuda:LOCAL_RANK)
    # with a mesh: each rank's loaders yield its own batches (datasets
    # strided by rank); the global batch is the ranks' batches in rank order
    multihost: bool = False


class Trainer:
    """Owns model, optimizer, loss spec, checkpoint directory and step
    functions.  After an epoch, ``lr`` holds its learning rate and
    ``times`` its per-step ``bt`` (whole step) and ``dt`` (waiting for
    data, and the batch's copy to the device) in seconds."""

    def __init__(self, cfg: TrainConfig, loader_train=None, loader_val=None, mesh=None):
        self.cfg = cfg
        self.device = config.resolve_device(cfg.device)
        self.loader_train = loader_train
        self.loader_val = loader_val
        self.mesh = mesh
        self._sharding_ctx = None
        if mesh is not None:
            spatial = "model" if axis_size(mesh, "model") > 1 else None
            self._sharding_ctx = ShardingContext(mesh, "data", spatial)

        model_kwargs = {}
        if cfg.remat:
            if "remat" in inspect.signature(MODELS[cfg.net]).parameters:
                model_kwargs["remat"] = True
            else:
                log.warning("--remat requested but %s has no remat support", cfg.net)
        model = create_model(cfg.net, cfg.maxdisparity, **model_kwargs)
        model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        # finetune skips the curriculum (stereo.py:46)
        maxepoch_adjust = 0 if cfg.mode == "finetune" else int(cfg.lr_epoch0 * 3 // 4)
        self.spec: LossSpec = parse_loss_name(cfg.loss_name, model.count_levels,
                                              max(maxepoch_adjust, 1))
        if cfg.mode == "finetune":
            self.spec = dataclasses.replace(self.spec, maxepoch_weight_adjust=0)

        self.dirpath = os.path.join(
            cfg.output, f"{cfg.mode}_{cfg.dataset}", f"{cfg.net}_{cfg.loss_name}"
        )

        self.state, opt = create_train_state(model, self.device, cfg.beta1, cfg.beta2)
        self.model = self.state.model
        self.epoch = 0
        self.best_prec = float("inf")
        self.lr = cfg.lr
        self.times: dict[str, list[float]] = {"bt": [], "dt": []}

        if cfg.path_weight and os.path.exists(cfg.path_weight):
            load_weights(cfg.path_weight, self.model)
            log.info("loaded pretrained weights: %s", cfg.path_weight)

        if cfg.mode in ("train", "finetune"):
            restored = load_checkpoint(self.dirpath, self.state)
            if restored is not None:
                _, last_epoch, self.best_prec = restored
                self.epoch = last_epoch + 1
                log.info("resumed checkpoint at epoch %d", self.epoch)
        if mesh is not None:
            replicate(self.state, mesh)

        nedge = 64 if self.spec.flag_mask else 0
        if self.spec.supervised:
            self._train_step = make_supervised_train_step(self.model, opt)
            self._eval_step = make_supervised_eval_step(self.model)
        else:
            self._train_step = make_selfsup_train_step(self.model, opt, self.spec.photo, nedge)
            self._eval_step = make_selfsup_eval_step(self.model, self.spec.photo)
        log.info("[%s] model: %s, loss: %s, resumed epochs: %d",
                 cfg.mode, cfg.net, cfg.loss_name, self.epoch)

    # ------------------------------------------------------------- epochs

    def _weights(self, epoch):
        return self.spec.weights(epoch)

    def _data_ranks(self) -> tuple[int, int]:
        """(this rank's index, the number of ranks) on the data axis."""
        if self.mesh is None:
            return 0, 1
        return axis_index(self.mesh, "data"), axis_size(self.mesh, "data")

    def _draws(self, n: int):
        """The self-supervised step's draws for this rank's batch of ``n``:
        those of its rows of the global batch, drawn from a generator seeded
        by (seed + 1, step), as JAX draws them inside its global step."""
        index, count = self._data_ranks()
        draws = draw_selfsup_params(selfsup_generator(self.cfg.seed + 1, self.state.step),
                                    n * count)
        return draws if count == 1 else draws.rows(index * n, (index + 1) * n)

    def _place_batch(self, batch: np.ndarray, loader=None) -> tuple[torch.Tensor, int]:
        """This rank's part of a host batch on its device, and the size of
        the global batch: the whole batch without a mesh; with one, the
        rank's slice of a global batch (``shard_batch``), or, when ``loader``
        yields each rank's own batch (cut by ``rank_slice``, or under
        ``multihost``), that batch (``global_batch_from_host_local``)."""
        if self.mesh is None:
            return torch.from_numpy(np.ascontiguousarray(batch)).to(self.device), len(batch)
        if self.cfg.multihost or getattr(loader, "rank_slice", None) is not None:
            t = global_batch_from_host_local(batch, self.mesh, device=self.device)
            return t, len(batch) * axis_size(self.mesh, "data")
        return shard_batch(batch, self.mesh).to(self.device), len(batch)

    def _ctx(self):
        stack = contextlib.ExitStack()
        if self._sharding_ctx is not None:
            stack.enter_context(activate(self._sharding_ctx))
        if self.cfg.dtype != "float32":
            stack.enter_context(compute_dtype(getattr(torch, self.cfg.dtype)))
        return stack

    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def train_epoch(self) -> tuple[float, float, float]:
        cfg = self.cfg
        self.lr = lr = lr_for_epoch(self.epoch, cfg.lr, cfg.lr_epoch0, cfg.lr_stride)
        weights = self._weights(self.epoch)
        log.info("lr: %.6f | level weights: %s", lr, np.asarray(weights).round(3))

        meters = {k: AverageMeter() for k in ("loss", "d1", "epe", "bt", "dt")}
        self.times = {"bt": [], "dt": []}
        prof = None
        t0 = time.time()
        try:
            for i, (batch, _names) in enumerate(self.loader_train):
                # profiler window: steps 10-15 of the first epoch
                if cfg.profile_dir and self.epoch == 0:
                    if i == PROFILE_STEPS[0]:
                        prof = self._profiler()
                        prof.start()
                    elif i == PROFILE_STEPS[1]:
                        self._stop_profile(prof)
                        prof = None
                        t0 = time.time()  # the trace's export is no wait for data
                batch, n = self._place_batch(batch, self.loader_train)
                meters["dt"].update(time.time() - t0)
                with self._ctx():
                    if self.spec.supervised:
                        m = self._train_step(self.state, batch, lr, weights)
                    else:
                        m = self._train_step(self.state, batch, lr, weights,
                                             self._draws(batch.shape[0]))
                m = {k: v.item() for k, v in m.items()}
                meters["loss"].update(m["loss"], n)
                if m["d1"] >= 0:
                    meters["d1"].update(m["d1"], n)
                    meters["epe"].update(m["epe"], n)
                meters["bt"].update(time.time() - t0)
                self.times["dt"].append(meters["dt"].val)
                self.times["bt"].append(meters["bt"].val)
                t0 = time.time()
                if i % cfg.print_freq == 0:
                    log.info(
                        "Train: [%d][%d/%d] | Time %.3f (%.3f) | Data %.3f (%.3f) | "
                        "Loss %.4f (%.4f) | D1 %.3f (%.3f) | EPE %.3f (%.3f)",
                        self.epoch, i, len(self.loader_train),
                        meters["bt"].val, meters["bt"].avg,
                        meters["dt"].val, meters["dt"].avg,
                        meters["loss"].val, meters["loss"].avg,
                        meters["d1"].val, meters["d1"].avg,
                        meters["epe"].val, meters["epe"].avg,
                    )
        finally:
            # an epoch shorter than the window still writes its trace
            self._stop_profile(prof)
        log.info(
            "mean train loss: %.3f | mean D1: %.3f | mean EPE: %.3f",
            meters["loss"].avg, meters["d1"].avg, meters["epe"].avg,
        )
        return meters["loss"].avg, meters["epe"].avg, meters["d1"].avg

    def _stop_profile(self, prof) -> None:
        if prof is None:
            return
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"trace_steps{PROFILE_STEPS[0]}-{PROFILE_STEPS[1]}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace: %s", path)

    def validate(self) -> tuple[float, float, float]:
        weights = self._weights(max(self.epoch, 0))
        meters = {k: AverageMeter() for k in ("loss", "d1", "epe")}
        for i, (batch, _names) in enumerate(self.loader_val):
            batch, n = self._place_batch(batch, self.loader_val)
            with self._ctx():
                m = self._eval_step(self.state, batch, weights)
            m = {k: m[k].item() for k in ("loss", "d1", "epe")}
            meters["loss"].update(m["loss"], n)
            if m["d1"] >= 0:
                meters["d1"].update(m["d1"], n)
                meters["epe"].update(m["epe"], n)
            if i % self.cfg.print_freq == 0:
                log.info(
                    "Val: [%d][%d/%d] | Loss %.4f (%.4f) | D1 %.3f (%.3f) | "
                    "EPE %.3f (%.3f)",
                    self.epoch, i, len(self.loader_val),
                    meters["loss"].val, meters["loss"].avg,
                    meters["d1"].val, meters["d1"].avg,
                    meters["epe"].val, meters["epe"].avg,
                )
        log.info(
            "mean val loss: %.3f | mean D1: %.3f | mean EPE: %.3f",
            meters["loss"].avg, meters["d1"].avg, meters["epe"].avg,
        )
        return meters["loss"].avg, meters["epe"].avg, meters["d1"].avg

    def start(self):
        """Epoch loop with validation, checkpoints and history
        (stereo.py:190-248).  Returns the validation's (loss, epe, d1) in
        test mode, else the loss history."""
        cfg = self.cfg
        if cfg.mode == "test":
            return self.validate()

        hist_path = os.path.join(self.dirpath, "loss_history.json")
        hist = {
            "loss": [], "epe": [], "d1": [],
            "epochs_val": [], "loss_val": [], "epe_val": [], "d1_val": [],
        }
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                hist = json.load(f)

        t_start = time.time()
        epoch0 = self.epoch
        for epoch in range(epoch0, cfg.epochs):
            self.epoch = epoch
            mloss, mepe, md1 = self.train_epoch()
            hist["loss"].append(mloss)
            hist["epe"].append(mepe)
            hist["d1"].append(md1)

            if epoch % cfg.val_freq == 0 or epoch == cfg.epochs - 1:
                vloss, vepe, vd1 = self.validate()
                hist["epochs_val"].append(epoch)
                hist["loss_val"].append(vloss)
                hist["epe_val"].append(vepe)
                hist["d1_val"].append(vd1)

                is_best = vd1 < self.best_prec
                self.best_prec = min(vd1, self.best_prec)
                if is_primary_host():
                    save_checkpoint(self.dirpath, self.state, epoch, self.best_prec, is_best)
                    os.makedirs(self.dirpath, exist_ok=True)
                    with open(hist_path + ".tmp", "w") as f:
                        json.dump(hist, f)
                    os.replace(hist_path + ".tmp", hist_path)
                    if cfg.plot_curves:
                        self._plot_curves(hist)
                barrier()  # the files are written before any rank goes on

            elapsed = (time.time() - t_start) / 3600.0
            total = elapsed * (cfg.epochs - epoch0) / max(epoch + 1 - epoch0, 1)
            log.info("Progress: %.2f | %.2f (hour)", elapsed, total)
        return hist

    def _plot_curves(self, hist):
        """3-panel loss/EPE/D1 curve PNG (stereo.py:232-243)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        cfg = self.cfg
        fig, axes = plt.subplots(1, 3, figsize=(18, 5))
        for ax, key, label in zip(axes, ("loss", "epe", "d1"), ("Loss", "EPE", "D1")):
            ax.plot(hist[key], label="train")
            ax.plot(hist["epochs_val"], hist[f"{key}_val"], label="val")
            ax.set_xlabel("epoch")
            ax.set_ylabel(label)
            ax.legend()
        fig.savefig(
            f"check_{cfg.mode}_{cfg.dataset}_{cfg.net}_{cfg.loss_name}.png"
        )
        plt.close(fig)

    # ------------------------------------------------------------- submit

    def submit(self, out_dir: str = "submit") -> dict:
        """Inference and PNG export loop (stereo.py:115-187): per batch, the
        first sample's disparity as a KITTI uint16 PNG (disparity x 256, at
        1/256 px), its time and, with ground truth, its D1 and EPE; the
        results go to ``<out_dir>/<dataset>_<flag_model>.json``, and a run
        that finds that file returns it (stereo.py:124-137).  With a mesh
        every rank evaluates every batch, outside the sharding context, as
        JAX's submit does; the primary rank writes the files."""
        cfg = self.cfg
        dirpath = os.path.join(out_dir, f"{cfg.dataset}_{cfg.flag_model}")
        if os.path.exists(dirpath + ".json"):
            with open(dirpath + ".json") as f:
                prior = json.load(f)
            for i, name in enumerate(prior["filename"]):
                if prior["D1"]:
                    log.info("submit(cached): %s | time %.3f D1 %.3f epe %.3f",
                             name, prior["time"][i], prior["D1"][i], prior["epe"][i])
                else:
                    log.info("submit(cached): %s | time %.3f", name, prior["time"][i])
            return prior
        primary = is_primary_host()
        if primary:
            os.makedirs(dirpath, exist_ok=True)
        results = {"filename": [], "time": [], "D1": [], "epe": []}

        weights = self._weights(0)
        t_end = time.time()
        for batch, names in self.loader_val:
            batch = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
            has_gt = batch.shape[-1] >= 7
            if not has_gt:
                pad = batch.new_zeros(batch.shape[:-1] + (1,))
                batch7 = torch.cat([batch[..., :6], pad], dim=-1)
            else:
                batch7 = batch[..., :7]
            # outside the compute dtype, as JAX's submit runs its eval step
            m = self._eval_step(self.state, batch7, weights)
            disp = m["disp"].float().cpu().numpy()
            results["filename"].append(names[0])
            results["time"].append(time.time() - t_end)
            t_end = time.time()
            if has_gt:
                results["D1"].append(m["d1"].item())
                results["epe"].append(m["epe"].item())
                log.info("submit: %s | time %.3f D1 %.3f epe %.3f",
                         names[0], results["time"][-1], results["D1"][-1],
                         results["epe"][-1])
            else:
                log.info("submit: %s | time %.3f", names[0], results["time"][-1])
            out_name = os.path.splitext(names[0])[0] + ".png"
            # KITTI submission convention: uint16 PNG at 1/256 px precision
            # (the reference wrote the raw float through cv2, truncating it
            # to uint8, stereo.py:172-174; JAX fixed that)
            d16 = np.clip(disp[0, :, :, 0] * 256.0, 0, 65535).astype(np.uint16)
            if primary:
                write_png16(os.path.join(dirpath, out_name), d16)
        if primary:
            with open(dirpath + ".json", "w") as f:
                json.dump(results, f)
        barrier()
        return results
