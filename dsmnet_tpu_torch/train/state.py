"""Train state, optimizer, LR schedule and checkpoint I/O
(``dsmnet_tpu/train/state.py``).

The optimizer matches the JAX package: optax ``scale_by_adam(b1, b2,
eps=1e-8)`` followed by ``-lr * u`` (``train/steps.py:73-75``), which is
the update of ``torch.optim.Adam(eps=1e-8)`` with its learning rate set
per step; the step sets it from its ``lr`` argument.  The schedule is the
reference's epoch-keyed step decay lr = lr0 * 0.5^(((epoch - epoch0) //
stride) + 1) for epoch >= epoch0 (stereo.py:95-101).

Unlike the JAX ``TrainState`` (immutable, replaced by each step), this
one is updated in place: the step writes the model's parameters and BN
statistics and the optimizer's moments where they lie.

Checkpoints keep the reference's semantics (utils/utils.py:31-53,
stereo.py:73-93): one file, ``model_checkpoint.pt``, holding {epoch,
best_prec, model, optimizer, step}, written to a temporary file and
renamed; on a new best a ``model_best.pt`` copy and a weights-only
``weight_best.pt`` ({model}).  They are ``torch.save`` files (JAX's are
msgpack); "model" is the model's ``state_dict``, so the weights file also
holds the BN running statistics (flax keeps those apart from the params
that JAX's weight file holds).
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import torch

from .. import config, interop

__all__ = ["TrainState", "make_optimizer", "create_train_state", "lr_for_epoch",
           "save_checkpoint", "load_checkpoint", "load_weights"]


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, beta1: float = 0.9, beta2: float = 0.999) -> torch.optim.Adam:
    """Bias-corrected Adam; the step sets the learning rate at each call."""
    return torch.optim.Adam(params, lr=0.0, betas=(beta1, beta2), eps=1e-8)


def create_train_state(model: torch.nn.Module, device=None, beta1: float = 0.9,
                       beta2: float = 0.999) -> tuple[TrainState, torch.optim.Adam]:
    """Move ``model`` (weights already set) to ``device`` (``None`` = CUDA)
    and build its optimizer; returns (state, optimizer) like the JAX
    package's (state, tx)."""
    model = model.to(config.resolve_device(device))
    opt = make_optimizer(model.parameters(), beta1, beta2)
    return TrainState(model, opt), opt


def lr_for_epoch(epoch: int, lr0: float, epoch0: int, stride: int) -> float:
    """Step-decay schedule (stereo.py:95-101)."""
    if epoch < epoch0:
        return lr0
    return lr0 * 0.5 ** ((epoch - epoch0) // stride + 1)


def _ckpt_paths(dirpath: str):
    return (
        os.path.join(dirpath, "model_checkpoint.pt"),
        os.path.join(dirpath, "model_best.pt"),
        os.path.join(dirpath, "weight_best.pt"),
    )


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(dirpath: str, state: TrainState, epoch: int, best_prec: float,
                    is_best: bool) -> None:
    """Atomic tmp+rename write; the best copies mirror utils/utils.py:31-42."""
    os.makedirs(dirpath, exist_ok=True)
    path, path_best, path_wbest = _ckpt_paths(dirpath)
    _save_atomic({"epoch": epoch, "best_prec": float(best_prec),
                  "model": state.model.state_dict(), "optimizer": state.opt.state_dict(),
                  "step": state.step}, path)
    if is_best:
        shutil.copyfile(path, path_best)
        _save_atomic({"model": state.model.state_dict()}, path_wbest)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def load_checkpoint(dirpath: str, state: TrainState, best: bool = False):
    """Restore the model, optimizer and step of ``state`` in place from
    ``dirpath``'s checkpoint (its best copy if ``best``); returns (state,
    epoch, best_prec), or None when there is no file (utils/utils.py:45-53)."""
    path, path_best, _ = _ckpt_paths(dirpath)
    p = path_best if best else path
    if not os.path.exists(p):
        return None
    payload = torch.load(p, map_location=_device_of(state.model), weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.opt.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"]), float(payload["best_prec"])


def load_weights(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Weights-only restore for --path_weight (stereo.py:59-64), into
    ``model`` in place: the port's ``.pt`` (a weights file or a checkpoint:
    its "model"), an ``.npz`` of '/'-joined flax paths (``interop.load_npz``),
    or a JAX ``.msgpack``: ``weight_best.msgpack``'s params, or a
    checkpoint's ``state.params`` and ``state.batch_stats``."""
    if path.endswith(".npz"):
        return interop.load_npz(model, path)
    if path.endswith(".msgpack"):
        payload = interop.load_msgpack(path)
        tree = payload["state"] if "state" in payload else payload
        return interop.load_flax_variables(model, tree["params"],
                                           tree.get("batch_stats") or None)
    payload = torch.load(path, map_location=_device_of(model), weights_only=True)
    model.load_state_dict(payload["model"])
    return model
