"""Train and eval steps, supervised and self-supervised
(``dsmnet_tpu/train/steps.py``).

A supervised step: split the 7-channel batch (left RGB, right RGB, left
disparity), forward in train mode (BN on batch statistics pooled over
both views, running statistics updated), the supervised pyramid loss,
backward through the hand-written kernels, Adam with the step's learning
rate, and D1/EPE of the full-resolution ``disps[0]``.

A self-supervised step (stereo_selfsupervised.py:44-95): the batch and
its horizontal flip, a border of ``nedge`` cropped, the crop colour
augmented on the device; two weight-shared train-mode forwards, of the
pair and of the flipped, swapped pair, the second starting from the BN
running statistics that the first left; the photometric pyramid loss on
the raw [0, 1] views, whose warps sample the uncropped right sources;
backward, Adam.  Its random draws (``color_aug.SelfsupDraws``) are an
argument.

The compute dtype is the caller's (``models.layers.compute_dtype``), as
in the JAX bench.  The metrics are returned as 0-d device tensors, so a
step does not wait for the device; reading one synchronises.

Data parallel: under a sharding context (``parallel.activate``) each rank
steps on its shard of the global batch.  Its loss is its share of the
global loss (the losses' counts and means, and BN's moments, are global:
``parallel/context.py``), so after the backward the step sums the
gradients in one flat bucket and every rank takes the same Adam step that
JAX's step on the global batch takes.  The reported loss, D1 and EPE are
the global batch's.  Under a spatial axis a model that bands H
(``parallel.context.bands``) returns this rank's band of rows of its
maps: the supervised steps take the same band of the ground truth, the
loss and D1/EPE reduce over the whole mesh, and the bucket sums over the
whole mesh (each rank's gradients are its band's share); a model that
runs whole on every ``model`` rank sums over the data group alone
(``parallel.context.gradient_group``).  The eval step returns the whole
disparity, its bands all-gathered.  The self-supervised steps run both
forwards on the whole augmented crops (the tower is whole on every
``model`` rank, and every ``model`` rank of a data index draws the same
augmentation), then the loss in a banded section of the crop's H on this
rank's band of the targets, rows ``nedge + lo .. nedge + hi`` of the
batch (not a crop of each band), against the whole uncropped sources.
"""

from __future__ import annotations

import contextlib

import torch

from ..losses import PhotoLossConfig, photometric_pyramid_loss, supervised_pyramid_loss
from ..parallel import context as sharding
from .color_aug import SelfsupDraws, color_augment_batch
from .metrics import d1_epe
from .state import TrainState

__all__ = ["make_supervised_train_step", "make_supervised_eval_step",
           "make_selfsup_train_step", "make_selfsup_eval_step", "selfsup_loss"]


def _split(batch: torch.Tensor):
    return batch[..., :3], batch[..., 3:6], batch[..., 6:7]


def _loss_section(model: torch.nn.Module, h: int):
    """The section of a step's loss, metrics and reported loss: banded over
    the ``h`` rows of the full-resolution maps (the ground truth's, a
    self-supervised step's crop) when ``model`` bands H under the context."""
    if sharding.bands(model):
        return sharding.banded(h)
    return contextlib.nullcontext()


def make_supervised_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                               flag_smooth: bool = True):
    """Returns ``step(state, batch, lr, weights) -> {"loss", "d1", "epe"}``
    (stereo_supervised.py:43-119); ``state`` is updated in place."""

    def step(state: TrainState, batch: torch.Tensor, lr: float, weights) -> dict:
        imL, imR, dispL = _split(batch)
        model.train()
        scales, disps = model(imL, imR)
        with _loss_section(model, dispL.shape[1]):
            dispL = sharding.shard_activation(dispL)
            loss = supervised_pyramid_loss(dispL, disps, scales, weights, flag_smooth)
            _adam_step(state, opt, loss, lr, sharding.gradient_group(model))
            d1, epe = d1_epe(disps[0].detach(), dispL)
            return {"loss": sharding.data_sum(loss.detach()), "d1": d1, "epe": epe}

    return step


def _sum_gradients(opt: torch.optim.Optimizer, group) -> None:
    """Every parameter's gradient summed over ``group``: one all-reduce of
    the gradients flattened into one bucket, then copied back."""
    grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
    flat = sharding.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group,
                                   "grad_bucket")
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _adam_step(state: TrainState, opt: torch.optim.Optimizer, loss: torch.Tensor,
               lr: float, group) -> None:
    """Backward, the gradients summed over ``group`` (the context's
    ``gradient_group``; None: no sum), then Adam at the step's learning
    rate (applied outside the moments, as JAX's -lr * u:
    train/steps.py:73-75)."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if group is not None:
        with torch.profiler.record_function("grad_allreduce"):
            _sum_gradients(opt, group)
    for g in opt.param_groups:
        g["lr"] = float(lr)
    opt.step()
    state.step += 1


def make_supervised_eval_step(model: torch.nn.Module, flag_smooth: bool = True):
    """Returns ``step(state, batch, weights) -> {"loss", "d1", "epe",
    "disp"}`` with BN on its running statistics (stereo_supervised.py:121-186)."""

    @torch.no_grad()
    def step(state: TrainState, batch: torch.Tensor, weights) -> dict:
        del state
        imL, imR, dispL = _split(batch)
        model.eval()
        scales, disps = model(imL, imR)
        with _loss_section(model, dispL.shape[1]):
            dispL = sharding.shard_activation(dispL)
            loss = supervised_pyramid_loss(dispL, disps, scales, weights, flag_smooth)
            d1, epe = d1_epe(disps[0], dispL)
            return {"loss": sharding.data_sum(loss), "d1": d1, "epe": epe,
                    "disp": sharding.gather_band(disps[0])}

    return step


def _selfsup_views(batch: torch.Tensor, nedge: int, draws: SelfsupDraws | None) -> dict:
    """Flip, crop and colour augmentation (stereo_selfsupervised.py:59-95):
    the models' inputs (augmented, normalized) and the loss's views ([0, 1]).
    The crop's border is symmetric, so the flip of the augmented crop is
    the augmented crop of the flipped batch, with the views swapped."""
    h, w = batch.shape[1], batch.shape[2]
    he, we = h - nedge, w - nedge
    batch1 = batch.flip(2)
    batch_aug = color_augment_batch(draws, batch[:, nedge:he, nedge:we, :6])
    batch1_aug = batch_aug.flip(2)
    views = {
        "imL_pre": batch_aug[..., :3],
        "imR_pre": batch_aug[..., 3:6],
        "imL1_pre": batch1_aug[..., 3:6],
        "imR1_pre": batch1_aug[..., :3],
        "imL": batch[:, nedge:he, nedge:we, :3],
        "imR_src": batch[..., 3:6],
        "imL1": batch1[:, nedge:he, nedge:we, 3:6],
        "imR1_src": batch1[..., :3],
    }
    if batch.shape[-1] >= 7:
        views["dispL"] = batch[:, nedge:he, nedge:we, 6:7]
    return views


def selfsup_loss(model: torch.nn.Module, cfg: PhotoLossConfig, batch: torch.Tensor,
                 nedge: int, weights, draws: SelfsupDraws | None = None):
    """The views, the two forwards (in the model's current mode) and the
    photometric pyramid loss of a self-supervised step: (loss, the first
    forward's full-resolution disparity, the views).  ``draws`` None is the
    eval step's: no jitter, the warps' default eps.  When ``model`` bands H
    under the context the disparities are this rank's bands of the crop's
    rows: the loss runs in a banded section of the crop's H, on the same
    band of the targets ``imL``, ``imL1`` (and ``dispL``, returned so), its
    warps starting at the band's first row of the whole sources; the loss
    is this rank's share."""
    v = _selfsup_views(batch, nedge, draws)
    scales, disps = model(v["imL_pre"], v["imR_pre"])
    scales1, disps1 = model(v["imL1_pre"], v["imR1_pre"])  # from the first's BN statistics
    eps = 5.5e-5 if draws is None else draws.eps
    with _loss_section(model, v["imL"].shape[1]), \
            torch.profiler.record_function("photometric_loss"):
        for k in ("imL", "imL1", "dispL"):
            if k in v:
                v[k] = sharding.shard_activation(v[k])
        left_top = (nedge, nedge + sharding.section_band()[0])
        loss = photometric_pyramid_loss(
            cfg, v["imR_src"], v["imL"], disps, scales, left_top,
            v["imR1_src"], v["imL1"], disps1, scales1, left_top, weights, eps=eps)
    return loss, disps[0], v


def _d1_epe_of_views(disp: torch.Tensor, v: dict):
    """D1/EPE against the batch's 7th channel, or -1 for both without one."""
    if "dispL" in v:
        return d1_epe(disp, v["dispL"])
    none = disp.new_full((), -1.0)
    return none, none


def make_selfsup_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                            cfg: PhotoLossConfig, nedge: int):
    """Returns ``step(state, batch, lr, weights, draws) -> {"loss", "d1",
    "epe"}`` on a (N,H,W,6 or 7) [0, 1] batch; ``draws`` is the step's
    ``SelfsupDraws`` (on any device) and ``state`` is updated in place.
    ``nedge`` is 64 with occlusion masking: the border lets a warp sample
    real content outside the crop (stereo_selfsupervised.py:60,85-95).
    The reported loss and D1/EPE (against this rank's band of ``dispL``
    when the model bands H) are the global batch's."""

    def step(state: TrainState, batch: torch.Tensor, lr: float, weights,
             draws: SelfsupDraws) -> dict:
        model.train()
        loss, disp, v = selfsup_loss(model, cfg, batch, nedge, weights, draws.to(batch.device))
        _adam_step(state, opt, loss, lr, sharding.gradient_group(model))
        with _loss_section(model, batch.shape[1] - 2 * nedge):
            d1, epe = _d1_epe_of_views(disp.detach(), v)
            return {"loss": sharding.data_sum(loss.detach()), "d1": d1, "epe": epe}

    return step


def make_selfsup_eval_step(model: torch.nn.Module, cfg: PhotoLossConfig):
    """Returns ``step(state, batch, weights) -> {"loss", "d1", "epe",
    "disp"}`` (stereo_selfsupervised.py:148-241): no border, no jitter, the
    warps' default eps, BN on its running statistics; ``disp`` whole, its
    bands all-gathered when the model bands H."""

    @torch.no_grad()
    def step(state: TrainState, batch: torch.Tensor, weights) -> dict:
        del state
        model.eval()
        loss, disp, v = selfsup_loss(model, cfg, batch, 0, weights)
        with _loss_section(model, batch.shape[1]):
            d1, epe = _d1_epe_of_views(disp, v)
            return {"loss": sharding.data_sum(loss), "d1": d1, "epe": epe,
                    "disp": sharding.gather_band(disp)}

    return step
