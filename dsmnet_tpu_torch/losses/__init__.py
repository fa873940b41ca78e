"""Loss registry of the port (``dsmnet_tpu/losses/__init__.py``): the
loss-name DSL and the level-weight curriculum.

The reference selects losses with a compositional string DSL
(losses/loss.py:341-377): a ``-mask`` suffix turns on occlusion
weighting, the prefix picks the loss family, and for ``Cap`` losses the
``ds`` / ``lr`` substrings toggle single terms.  The curriculum sweeps a
linearly interpolated one-hot from the coarsest to the finest scale over
``maxepoch_weight_adjust`` epochs, with a 0.01 floor elsewhere
(loss.py:379-391).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .photometric import PhotoLossConfig, photometric_pyramid_loss, weight_common
from .supervised import supervised_level_loss, supervised_pyramid_loss

__all__ = [
    "LossSpec",
    "parse_loss_name",
    "weight_adjust_levels",
    "supervised_pyramid_loss",
    "supervised_level_loss",
    "photometric_pyramid_loss",
    "PhotoLossConfig",
    "weight_common",
]


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """Parsed loss configuration."""

    name: str
    supervised: bool
    photo: PhotoLossConfig | None
    count_levels: int
    maxepoch_weight_adjust: int

    @property
    def flag_mask(self) -> bool:
        return self.photo.flag_mask if self.photo else False

    def weights(self, epoch: int) -> np.ndarray:
        return weight_adjust_levels(epoch, self.count_levels, self.maxepoch_weight_adjust)


def parse_loss_name(loss_name: str, count_levels: int = 1,
                    maxepoch_weight_adjust: int = 1) -> LossSpec:
    """Parse the reference's loss-name DSL (loss.py:341-377)."""
    flag_mask = "mask" in loss_name
    base = loss_name.split("-")[0].lower()
    supervised = False
    photo = None
    if "supervised" in base:
        supervised = True
    elif "depthmono" in base:
        photo = PhotoLossConfig("depthmono", flag_mask)
    elif "sssmnet" in base:
        photo = PhotoLossConfig("sssmnet", flag_mask)
    elif "cap" in base:
        photo = PhotoLossConfig("cap", flag_mask, with_ds="ds" in base, with_lr="lr" in base)
    elif "common" in base:
        photo = PhotoLossConfig("common", flag_mask)
    else:
        raise ValueError(f"unknown loss '{loss_name}'; expected supervised / depthmono / "
                         "SsSMnet / Cap_ds_lr / common with optional -mask suffix")
    return LossSpec(loss_name, supervised, photo, count_levels, maxepoch_weight_adjust)


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
