"""The port's cost-volume models learn on its own pipeline: the counterpart
of ``tests/test_train_zoo.py``.

The same data and settings as JAX's test, all from ``dsmnet_tpu_torch``
in float32 on the CPU: ``SyntheticStereoDataset(n=2, hw=(48, 64),
max_disp=12)`` through ``eval_transform()`` and a ``BatchLoader`` of batch
2 (one batch a pass), maxdisparity 16, lr 3e-4, the supervised loss's
weights of epoch 10, six passes.  The weights are the port's, seeded by 0.
PSMNet (the fused stem, BN, the SPP branches on windows larger than its
12x16 features, the chunked trilinear soft-argmin), GCNet (its volume and
3-D stack) and iResNet (the correlations, the warp and the refinement)
must keep the loss finite and end below 0.9 times the first loss; with
``remat`` PSMNet's first loss must be the plain one's within 1e-5 (in
PSMNet's case, not a test of its own as in JAX's file: a file of three
tests or fewer queues behind ``test_train_zoo.py`` under ``--dist
loadfile``, instead of just ahead of it).
"""

import numpy as np
import pytest
import torch

from dsmnet_tpu_torch.data import BatchLoader, SyntheticStereoDataset, eval_transform
from dsmnet_tpu_torch.losses import parse_loss_name
from dsmnet_tpu_torch.models import create_model
from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step
from torch_parallel_ranks import worker_cpus


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    with worker_cpus():
        yield
    torch.set_num_threads(old)


def _run_steps(name, passes, lr=3e-4, **model_kwargs):
    """The supervised losses of ``passes`` passes over JAX's learn-test data."""
    ds = SyntheticStereoDataset(n=2, hw=(48, 64), max_disp=12, transform=eval_transform())
    loader = BatchLoader(ds, batch_size=2, shuffle=False, num_workers=1)
    model = create_model(name, 16, **model_kwargs).reset_parameters(
        torch.Generator().manual_seed(0))
    state, opt = create_train_state(model, device="cpu")
    step = make_supervised_train_step(model, opt)
    weights = parse_loss_name("supervised", model.count_levels, 1).weights(10)
    losses = []
    for _ in range(passes):
        for batch, _names in loader:
            losses.append(step(state, torch.from_numpy(batch), lr, weights)["loss"].item())
    return losses


@pytest.mark.parametrize("name", ["psmnet", "gcnet", "iresnet"])
def test_supervised_step_learns_synthetic(name):
    losses = _run_steps(name, 6)
    assert len(losses) == 6 and np.isfinite(losses).all(), f"{name}: {losses}"
    assert losses[-1] < losses[0] * 0.9, f"{name} did not learn: {losses}"
    if name == "psmnet":  # remat changes the memory schedule, not the math
        remat, = _run_steps(name, 1, remat=True)
        assert remat == pytest.approx(losses[0], rel=1e-5)
