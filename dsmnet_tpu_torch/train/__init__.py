"""Training of the port: state, optimizer, supervised steps, metrics.

The trainer (epochs, LR decay, checkpoints) waits in ROADMAP.md
queue 1, "Trainer and CLI"; the self-supervised step in "Self-supervised path".
"""

from .metrics import AverageMeter, d1_epe
from .state import TrainState, create_train_state, lr_for_epoch, make_optimizer
from .steps import make_supervised_eval_step, make_supervised_train_step

__all__ = [
    "AverageMeter",
    "d1_epe",
    "TrainState",
    "create_train_state",
    "lr_for_epoch",
    "make_optimizer",
    "make_supervised_eval_step",
    "make_supervised_train_step",
]
