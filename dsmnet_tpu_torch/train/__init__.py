"""Training of the port: state, optimizer, checkpoints, supervised steps,
metrics and the ``Trainer`` (``dsmnet_tpu/train/``).

The self-supervised step waits in ROADMAP.md queue 1, "Self-supervised path".
"""

from .metrics import AverageMeter, d1_epe
from .state import (
    TrainState,
    create_train_state,
    load_checkpoint,
    load_weights,
    lr_for_epoch,
    make_optimizer,
    save_checkpoint,
)
from .steps import make_supervised_eval_step, make_supervised_train_step
from .trainer import TrainConfig, Trainer

__all__ = [
    "AverageMeter",
    "d1_epe",
    "TrainState",
    "create_train_state",
    "load_checkpoint",
    "load_weights",
    "lr_for_epoch",
    "make_optimizer",
    "save_checkpoint",
    "make_supervised_eval_step",
    "make_supervised_train_step",
    "TrainConfig",
    "Trainer",
]
