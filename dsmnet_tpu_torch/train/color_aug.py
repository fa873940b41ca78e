"""Batched colour augmentation of the self-supervised step, on the device
(``dsmnet_tpu/train/color_aug.py``; reference myTransforms/aug_color.py).

Per sample, with one parameter shared by its L/R pair
(aug_color.py:103-217, same_group=True):

  * the four jitter ops in the sample's drawn order, each with its own
    u ~ U(-0.5, 0.5):
      brightness  x (1 + 0.4 u)
      contrast    x + 0.4 u                  (the reference's is additive)
      saturation  x + gray(x) (0.4 u)        ITU-R 601 luma, per view
      gamma       clip(x, 1e-6, 1) ** (1 + 0.4 u)
    then a clamp to [0, 1];
  * PCA lighting, AlexNet's, alpha ~ N(0, 0.1), then a clamp to [0, 1]
    (aug_color.py:66-99);
  * ImageNet normalization per 3-channel group.

JAX draws the parameters from a PRNG key inside its jitted step.  Here
they are explicit arguments: ``draw_selfsup_params`` makes them from a
CPU ``torch.Generator`` (so a seed gives the same draws on the CPU and on
the card) and moves the few numbers to the device, and a test can inject
JAX's.  The ops run over the whole batch, each sample's choice made by
``torch.where``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import images
from ..images import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["SelfsupDraws", "draw_selfsup_params", "selfsup_generator", "color_augment_batch",
           "normalize_imagenet", "unnormalize_imagenet"]

# aug_color.py:8-15, in float32 as JAX's module-level constants are
_PCA_EIGVAL = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
_PCA_EIGVEC = np.asarray([[-0.5675, 0.7192, 0.4009],
                          [-0.5808, -0.0045, -0.8140],
                          [-0.5836, -0.6948, 0.4203]], np.float32)

BRIGHTNESS, CONTRAST, SATURATION, GAMMA = range(4)


@dataclasses.dataclass
class SelfsupDraws:
    """The random draws of one self-supervised step: per sample the jitter
    ops' order (N, 4) (a permutation of 0..3: brightness, contrast,
    saturation, gamma), the parameter of the op at each position (N, 4),
    in [-0.5, 0.5), and the lighting's alphas (N, 3), N(0, 1) x 0.1; per
    step the warps' eps = 1e-4 (U + 0.1) (steps.py:133-135, imwrap.py:70)."""

    order: torch.Tensor
    u: torch.Tensor
    alpha: torch.Tensor
    eps: torch.Tensor

    def to(self, device) -> "SelfsupDraws":
        return SelfsupDraws(*(getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)))

    def rows(self, start: int, stop: int) -> "SelfsupDraws":
        """The draws of samples [start, stop) (a rank's shard of the global
        batch's draws); eps is the step's."""
        return SelfsupDraws(self.order[start:stop], self.u[start:stop],
                            self.alpha[start:stop], self.eps)


def selfsup_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded by (seed, step): the draws of step ``step`` of
    a run seeded ``seed`` do not depend on where the run (re)started."""
    return torch.Generator().manual_seed((seed << 32) + step)


def draw_selfsup_params(generator: torch.Generator, n: int) -> SelfsupDraws:
    """One step's draws for a batch of ``n`` from a CPU generator."""
    order = torch.rand((n, 4), generator=generator).argsort(dim=1)
    u = torch.rand((n, 4), generator=generator) - 0.5
    alpha = torch.randn((n, 3), generator=generator) * 0.1
    eps = 1e-4 * (torch.rand((), generator=generator) + 0.1)
    return SelfsupDraws(order, u, alpha, eps)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma of (..., 3), replicated to 3 channels (aug_color.py:105-117)."""
    g = 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]
    return g.expand(*g.shape[:-1], 3)


def _apply_op(op: int, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Jitter op ``op`` on (N,H,W,6) L/R stacks, u (N,1,1,1) per sample."""
    if op == BRIGHTNESS:
        return x * (1.0 + u * 0.4)
    if op == CONTRAST:
        return x + u * 0.4
    if op == SATURATION:
        gs = torch.cat([_grayscale(x[..., :3]), _grayscale(x[..., 3:6])], -1)
        return x + gs * (u * 0.4)
    return x.clamp(1e-6, 1.0) ** (1.0 + u * 0.4)


def _jitter(x: torch.Tensor, order: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Random-order jitter (aug_color.py:186-217): at position i each
    sample applies its op ``order[:, i]``."""
    order = order.to(x.device).view(-1, 1, 1, 1, 4)
    u = u.to(device=x.device, dtype=x.dtype).view(-1, 1, 1, 1, 4)
    for i in range(4):
        y = x
        for op in range(4):
            y = torch.where(order[..., i] == op, _apply_op(op, x, u[..., i]), y)
        x = y
    return x.clamp(0.0, 1.0)


def _lighting(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PCA lighting noise, shared by the pair (aug_color.py:66-99)."""
    vec = torch.as_tensor(_PCA_EIGVEC, dtype=x.dtype, device=x.device)
    val = torch.as_tensor(_PCA_EIGVAL, dtype=x.dtype, device=x.device)
    a = alpha.to(device=x.device, dtype=x.dtype)
    rgb = (vec[None] * a[:, None, :] * val[None, None, :]).sum(-1)  # (N, 3)
    return (x + torch.cat([rgb, rgb], -1)[:, None, None, :]).clamp(0.0, 1.0)


def normalize_imagenet(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Per-3-channel-group ImageNet normalization (myTransforms/__init__.py:8),
    both views of a pair by default, as JAX's (``color_aug.py:91``); the
    deploy's ``images.normalize_imagenet`` defaults to one view."""
    return images.normalize_imagenet(x, groups)


def unnormalize_imagenet(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    mean = torch.as_tensor(IMAGENET_MEAN * groups, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(IMAGENET_STD * groups, dtype=x.dtype, device=x.device)
    return x * std + mean


def color_augment_batch(draws: SelfsupDraws | None, batch: torch.Tensor) -> torch.Tensor:
    """Jitter + lighting + normalization of a (N,H,W,6) [0, 1] batch with
    ``draws`` (its own per sample, shared by the sample's pair); with
    ``draws`` None, normalization alone (JAX's ``jitter=False``)."""
    if draws is not None:
        batch = _jitter(batch, draws.order, draws.u)
        batch = _lighting(batch, draws.alpha)
    return normalize_imagenet(batch, groups=2)
