"""One supervised train step of PSMNet-basic and iResNet against the JAX step.

As ``test_torch_train_zoo.py`` (whose ``check_train_step_f64`` both use):
float64, the same batch and weights, the loss, D1/EPE, every parameter's
gradient, the updated parameters and the BN statistics to 1e-9 relative.
Two heavy tests, in a file of their own for ``--dist loadfile``.
"""

import pytest
import torch

from test_torch_train_zoo import check_train_step_f64
from torch_parallel_ranks import worker_cpus


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    with worker_cpus():
        yield
    torch.set_num_threads(old)


def test_psmnet_basic_train_step_matches_jax_f64(rng, monkeypatch):
    """PSMNet-basic at 256x256 (where every SPP pool, up to 64x64 at 1/4,
    has a window), maxdisparity 16, batch 1: the tower once per view
    (each BN updates its statistics twice), the masked volume, five residual
    3-D blocks and the trilinear regression."""
    check_train_step_f64("psmnet_basic", 16, 1, 256, 256, rng, monkeypatch, convs_as_dots=True)


def test_iresnet_train_step_matches_jax_f64(rng, monkeypatch):
    """iResNet at 64x128, batch 2, one refinement iteration: both
    correlations (D = 81; D = 41, stride 2, 3x3 pool), the warp and the ten
    outputs of the pyramid loss."""
    check_train_step_f64("iresnet", 24, 2, 64, 128, rng, monkeypatch)
