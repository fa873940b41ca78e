"""Timing of an op or a step on the device its tensors lie on
(``dsmnet_tpu/utils/benchtime.py``).

JAX's timer differences two lengths of a serial chain inside one jit, the
only clock it trusts through a remote TPU runtime.  Here the tensors'
device decides the clock: for CUDA tensors, CUDA events recorded around
the chain on the current stream (the device's time for the work); for
CPU tensors, ``time.perf_counter`` around it (CPU ops return when done).
Nothing falls back from one to the other.  Two chain lengths are still
differenced, which cancels the fixed cost of a timed call.
"""

from __future__ import annotations

import time

import torch

__all__ = ["time_op", "time_pytree_step"]


def _first_tensor(*trees) -> torch.Tensor:
    stack = list(trees)
    while stack:
        x = stack.pop(0)
        if torch.is_tensor(x):
            return x
        if isinstance(x, dict):
            stack[:0] = list(x.values())
        elif isinstance(x, (list, tuple)):
            stack[:0] = list(x)
    raise ValueError("no tensor among the arguments: nothing says which device to time")


def _clock(device: torch.device):
    """``run(fn) -> seconds`` for the work ``fn`` queues on ``device``."""
    if device.type == "cuda":
        def run(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def run(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
    return run


def _per_application(chain, device, n_small: int, n_big: int, reps: int) -> float:
    run = _clock(device)
    run(lambda: chain(n_small))  # warm-up (kernel builds, allocator)
    best = lambda n: min(run(lambda: chain(n)) for _ in range(reps))
    t1, t2 = best(n_small), best(n_big)
    return max((t2 - t1) / (n_big - n_small), 1e-9)


def time_op(fn, *args, n_small: int = 1, n_big: int = 11, reps: int = 3) -> float:
    """Seconds per application of ``fn(*args) -> tensor`` on the device of
    the first tensor argument."""

    def chain(n):
        for _ in range(n):
            fn(*args)

    return _per_application(chain, _first_tensor(args).device, n_small, n_big, reps)


def time_pytree_step(step_fn, carry, *args, n_small: int = 1, n_big: int = 6,
                     reps: int = 3) -> float:
    """Seconds per application of ``step_fn(carry, *args) -> carry`` (e.g. a
    train step on its state), on the device of the first tensor in
    ``carry`` or ``args``; each application takes the previous one's carry."""
    box = [carry]

    def chain(n):
        for _ in range(n):
            box[0] = step_fn(box[0], *args)

    return _per_application(chain, _first_tensor(carry, args).device, n_small, n_big, reps)
