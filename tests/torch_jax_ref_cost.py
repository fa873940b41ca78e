"""Wall and CPU seconds of one float64 JAX supervised train step, the
reference that the port's train-step tests hold the port to: tracing and
lowering, XLA's compilation, and the run, with XLA's own float64
convolutions and with ``torch_jax_dots.f64_convs_as_dots``.

    PYTHONPATH=.:tests python tests/torch_jax_ref_cost.py psmnet 16 1 256 256

(model, maxdisparity, batch, height, width; PSMNet and PSMNet-basic
compile without XLA's constant folding, as ``test_torch_train.py`` does.)
Each variant runs in this process, one after the other; the gradients of
the second are held to the first's.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dsmnet_tpu.models import create_model as j_create_model  # noqa: E402
from dsmnet_tpu.train import state as j_state  # noqa: E402
from dsmnet_tpu.train import steps as j_steps  # noqa: E402
from dsmnet_tpu_torch.losses import parse_loss_name  # noqa: E402
from dsmnet_tpu_torch.models import create_model as t_create_model  # noqa: E402
from test_torch_train import NO_FOLDING, _flat, _recording_adam, _relerr, \
    _seeded_flax_variables  # noqa: E402
from test_torch_train_zoo import _F32_CASTS, _NoFloat32  # noqa: E402
from torch_jax_dots import f64_convs_as_dots  # noqa: E402


def _cpu() -> float:
    t = os.times()
    return t.user + t.system


def main(name: str, maxdisp: int, n: int, h: int, w: int) -> None:
    rng = np.random.RandomState(0)
    batch = rng.rand(n, h, w, 7)
    batch[..., 6] = batch[..., 6] * (maxdisp - 2) + 1
    tm = t_create_model(name, maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    weights = parse_loss_name("supervised", tm.count_levels, 10).weights(3).astype(np.float64)
    if name != "psmnet":  # as test_torch_train_zoo.check_train_step_f64
        for mod in _F32_CASTS:
            mod.jnp = _NoFloat32()
    opts = NO_FOLDING if name.startswith("psmnet") else {}
    grads = {}
    with jax.enable_x64():
        model = j_create_model(name, maxdisparity=maxdisp)
        v = jax.tree.map(np.asarray, _seeded_flax_variables(model, tm, h, w, rng))
        for dots in (False, True):
            tx = _recording_adam()
            params = jax.tree.map(jnp.asarray, v["params"])
            state = j_state.TrainState(params, jax.tree.map(jnp.asarray, v.get("batch_stats", {})),
                                       tx.init(params), jnp.zeros((), jnp.int32))
            args = (state, jnp.asarray(batch), 1e-3, jnp.asarray(weights))
            marks = [(time.time(), _cpu())]
            with f64_convs_as_dots() if dots else contextlib.nullcontext():
                lowered = j_steps.make_supervised_train_step(model, tx).lower(*args)
            marks.append((time.time(), _cpu()))
            step = lowered.compile(opts)
            marks.append((time.time(), _cpu()))
            new, _ = step(*args)
            grads[dots] = _flat(jax.device_get(new.opt_state[1]))
            marks.append((time.time(), _cpu()))
            phases = ", ".join(
                f"{phase} {b[0] - a[0]:.1f} s / {b[1] - a[1]:.1f} CPU s"
                for phase, a, b in zip(("lower", "compile", "run"), marks, marks[1:]))
            print(f"{name} {h}x{w} batch {n} {'dots' if dots else 'XLA convolutions'}: {phases}",
                  flush=True)
    worst = max(_relerr(grads[True][k], grads[False][k]) for k in grads[False]
                if np.abs(grads[False][k]).max() > 1e-9)
    print(f"largest relative gradient difference (gradients above 1e-9): {worst:.2e}")


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:6]))
