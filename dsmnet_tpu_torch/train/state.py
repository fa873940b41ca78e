"""Train state, optimizer and LR schedule (``dsmnet_tpu/train/state.py``).

The optimizer matches the JAX package: optax ``scale_by_adam(b1, b2,
eps=1e-8)`` followed by ``-lr * u`` (``train/steps.py:73-75``), which is
the update of ``torch.optim.Adam(eps=1e-8)`` with its learning rate set
per step; the step sets it from its ``lr`` argument.  The schedule is the
reference's epoch-keyed step decay lr = lr0 * 0.5^(((epoch - epoch0) //
stride) + 1) for epoch >= epoch0 (stereo.py:95-101).  Checkpoint I/O
comes with the trainer (ROADMAP.md queue 1, "Trainer and CLI").

Unlike the JAX ``TrainState`` (immutable, replaced by each step), this
one is updated in place: the step writes the model's parameters and BN
statistics and the optimizer's moments where they lie.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import config

__all__ = ["TrainState", "make_optimizer", "create_train_state", "lr_for_epoch"]


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
