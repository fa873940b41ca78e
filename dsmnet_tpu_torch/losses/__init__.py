"""Loss registry of the port (``dsmnet_tpu/losses/__init__.py``): the
supervised branch of the loss-name DSL and the level-weight curriculum.

The curriculum sweeps a linearly interpolated one-hot from the coarsest
to the finest scale over ``maxepoch_weight_adjust`` epochs, with a 0.01
floor elsewhere (reference loss.py:379-391).  The photometric losses are
not ported yet (ROADMAP.md queue 1, "Self-supervised path"): their names
raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .supervised import supervised_level_loss, supervised_pyramid_loss

__all__ = ["LossSpec", "parse_loss_name", "weight_adjust_levels", "supervised_pyramid_loss",
           "supervised_level_loss"]

_PHOTOMETRIC = ("depthmono", "sssmnet", "cap", "common")


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """Parsed loss configuration (supervised only, so far)."""

    name: str
    supervised: bool
    count_levels: int
    maxepoch_weight_adjust: int

    def weights(self, epoch: int) -> np.ndarray:
        return weight_adjust_levels(epoch, self.count_levels, self.maxepoch_weight_adjust)


def parse_loss_name(loss_name: str, count_levels: int = 1,
                    maxepoch_weight_adjust: int = 1) -> LossSpec:
    """Parse the reference's loss-name DSL (loss.py:341-377)."""
    base = loss_name.split("-")[0].lower()
    if "supervised" in base:
        return LossSpec(loss_name, True, count_levels, maxepoch_weight_adjust)
    if any(p in base for p in _PHOTOMETRIC):
        raise NotImplementedError(
            f"loss '{loss_name}' is photometric (self-supervised), which is not ported to "
            "PyTorch yet: see ROADMAP.md, queue 1, 'Self-supervised path'")
    raise ValueError(f"unknown loss '{loss_name}'; expected supervised / depthmono / "
                     "SsSMnet / Cap_ds_lr / common with optional -mask suffix")


def weight_adjust_levels(epoch: int, count_levels: int, maxepoch: int) -> np.ndarray:
    """Per-epoch curriculum weights indexed by scale (loss.py:379-391)."""
    w = np.full((count_levels,), 0.01, np.float32)
    if count_levels == 1 or epoch >= maxepoch:
        w[0] = 1.0
        return w
    x = (1.0 - epoch / float(maxepoch)) * (count_levels - 1)
    idx = int(x)
    frac = x - idx
    w[idx] = 1.0 - frac
    if idx < count_levels - 1:
        w[idx + 1] = frac
    return w
