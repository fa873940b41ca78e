"""Supervised train and eval steps (``dsmnet_tpu/train/steps.py:59-95``).

One step: split the 7-channel batch (left RGB, right RGB, left
disparity), forward in train mode (BN on batch statistics pooled over
both views, running statistics updated), the supervised pyramid loss,
backward through the hand-written kernels, Adam with the step's learning
rate, and D1/EPE of the full-resolution ``disps[0]``.  The compute dtype
is the caller's (``models.layers.compute_dtype``), as in the JAX bench.

The metrics are returned as 0-d device tensors, so a step does not wait
for the device; reading one synchronises.
"""

from __future__ import annotations

import torch

from ..losses import supervised_pyramid_loss
from .metrics import d1_epe
from .state import TrainState

__all__ = ["make_supervised_train_step", "make_supervised_eval_step"]


def _split(batch: torch.Tensor):
    return batch[..., :3], batch[..., 3:6], batch[..., 6:7]


def make_supervised_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                               flag_smooth: bool = True):
    """Returns ``step(state, batch, lr, weights) -> {"loss", "d1", "epe"}``
    (stereo_supervised.py:43-119); ``state`` is updated in place."""

    def step(state: TrainState, batch: torch.Tensor, lr: float, weights) -> dict:
        imL, imR, dispL = _split(batch)
        model.train()
        scales, disps = model(imL, imR)
        loss = supervised_pyramid_loss(dispL, disps, scales, weights, flag_smooth)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = float(lr)
        opt.step()
        state.step += 1
        d1, epe = d1_epe(disps[0].detach(), dispL)
        return {"loss": loss.detach(), "d1": d1, "epe": epe}

    return step


def make_supervised_eval_step(model: torch.nn.Module, flag_smooth: bool = True):
    """Returns ``step(state, batch, weights) -> {"loss", "d1", "epe",
    "disp"}`` with BN on its running statistics (stereo_supervised.py:121-186)."""

    @torch.no_grad()
    def step(state: TrainState, batch: torch.Tensor, weights) -> dict:
        del state
        imL, imR, dispL = _split(batch)
        model.eval()
        scales, disps = model(imL, imR)
        loss = supervised_pyramid_loss(dispL, disps, scales, weights, flag_smooth)
        d1, epe = d1_epe(disps[0], dispL)
        return {"loss": loss, "d1": d1, "epe": epe, "disp": disps[0]}

    return step
