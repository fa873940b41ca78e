"""First differences of NHWC maps (``dsmnet_tpu/ops/gradients.py:31-40``).

The reference's convention (losses/loss.py:36-44): the difference is
zero-padded by one at the right / bottom, so the output keeps the
input's shape.  The port needs only these two so far (the supervised
smoothness term); the photometric family waits in ROADMAP.md queue 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["diff1_dx", "diff1_dy"]


def diff1_dx(x: torch.Tensor) -> torch.Tensor:
    """First difference along W, zero-padded right."""
    return F.pad(x[:, :, 1:] - x[:, :, :-1], (0, 0, 0, 1))


def diff1_dy(x: torch.Tensor) -> torch.Tensor:
    """First difference along H, zero-padded bottom."""
    return F.pad(x[:, 1:] - x[:, :-1], (0, 0, 0, 0, 0, 1))
