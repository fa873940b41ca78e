"""Device resolution and per-op implementation switches.

PyTorch counterpart of ``dsmnet_tpu/ops/config.py``, without the TPU
formulations (folded volumes, space-to-depth, kw-folding).  Each op that
has a hand-written kernel has one switch:

  * ``None``     — the default: the kernel for CUDA tensors, the plain
    version for CPU tensors;
  * ``"plain"``  — always take the plain PyTorch version;
  * ``"kernel"`` — the kernel for every tensor: the wrapper raises for
    one that is not on CUDA.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed

OPS = ("conv2d", "conv3d", "conv3d_s2", "deconv3d", "cost_volume", "corr1d", "fused_costvol")
_MODES = (None, "kernel", "plain")

impl: dict[str, str | None] = {op: None for op in OPS}


def launches_kernel(op: str, x: torch.Tensor) -> bool:
    """Whether ``op``'s kernel wrapper launches its kernel for ``x`` (and
    raises if it cannot): always for a CUDA tensor; for a CPU tensor only
    when ``op`` is forced to "kernel", else the wrapper takes the plain
    version.  The ops never reach the wrapper under "plain"."""
    return x.is_cuda or impl[op] == "kernel"


def set_impl(op: str, mode: str | None) -> None:
    if op not in impl:
        raise KeyError(f"unknown op {op!r}; ops: {OPS}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    impl[op] = mode


@contextlib.contextmanager
def implementation(mode: str | None, ops=OPS):
    """Set ``ops`` to ``mode`` inside the context (e.g. "plain" for a reference run)."""
    old = dict(impl)
    try:
        for op in ops:
            set_impl(op, mode)
        yield
    finally:
        impl.update(old)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA: under a process group the rank's card,
    ``cuda:LOCAL_RANK`` (an explicit ``cuda:0`` pins every rank to that
    card).  Raises when CUDA is asked for and absent: the entry points
    never drop to the CPU on their own."""
    if device is None and torch.distributed.is_available() and torch.distributed.is_initialized():
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
