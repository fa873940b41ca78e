"""Utilities: timing on the tensors' device, offline evaluation metrics
(``dsmnet_tpu/utils/``)."""

from .benchtime import time_op, time_pytree_step
from .evaluate import compute_errors, evaluate_pair, warp_pixel_error

__all__ = [
    "time_op",
    "time_pytree_step",
    "compute_errors",
    "evaluate_pair",
    "warp_pixel_error",
]
