"""Training of the port: state, optimizer, checkpoints, the supervised and
self-supervised steps, the device colour augmentation, metrics and the
``Trainer`` (``dsmnet_tpu/train/``).
"""

from .color_aug import (
    SelfsupDraws,
    color_augment_batch,
    draw_selfsup_params,
    normalize_imagenet,
    selfsup_generator,
    unnormalize_imagenet,
)
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
from .steps import (
    make_selfsup_eval_step,
    make_selfsup_train_step,
    make_supervised_eval_step,
    make_supervised_train_step,
    selfsup_loss,
)
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
    "make_selfsup_eval_step",
    "make_selfsup_train_step",
    "SelfsupDraws",
    "color_augment_batch",
    "draw_selfsup_params",
    "selfsup_generator",
    "selfsup_loss",
    "normalize_imagenet",
    "unnormalize_imagenet",
    "TrainConfig",
    "Trainer",
]
