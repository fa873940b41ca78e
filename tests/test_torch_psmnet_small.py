"""PSMNet and PSMNet-basic below 256 pixels against the JAX package.

The SPP branches pool the 1/4-resolution features with windows of 64, 32,
16 and 8.  Where a window does not fit, JAX's VALID pool
(``lax.reduce_window``) gives an empty map, the branch's 1x1 ConvBN
(padding 1) a map of zeros, and the branch its BN's constant after ReLU;
the model still returns a disparity.  At 48x64 (12x16 features) the first
three pools are empty and the last is 1x2; at 128x192 (32x48) only the
64-pool is empty.  Float64, with the weights carried by ``interop``:

  * eval mode, as ``test_torch_psmnet.py``'s check: PSMNet at 48x64 and
    128x192, PSMNet-basic at 48x64;
  * one PSMNet supervised train step at 48x64 against JAX's step, as
    ``test_torch_train.py``'s check at its tolerances: gradients, the
    parameters after Adam and the BN running statistics.  The empty
    branches' conv kernels and BN scales get exact zeros on both sides,
    their BN biases do not, and their running means (of all-zero maps) stay
    0.

The JAX side is jitted without XLA's constant folding, which evaluates the
empty branches' constants on the host (``test_torch_train.NO_FOLDING``).
Three tests: ``--dist loadfile`` queues a file of three or fewer behind
``test_train_zoo.py`` instead of ahead of it.
"""

import pytest
import torch

from test_torch_psmnet import eval_matches_jax_f64
from test_torch_train import check_psmnet_step_f64
from torch_parallel_ranks import worker_cpus


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    with worker_cpus():
        yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name,sizes", [("psmnet", [(48, 64), (128, 192)]),
                                        ("psmnet_basic", [(48, 64)])],
                         ids=["psmnet", "psmnet_basic"])
def test_eval_below_spp_windows_matches_jax_f64(name, sizes, rng):
    for h, w in sizes:
        eval_matches_jax_f64(name, h, w, rng)


def test_psmnet_train_step_below_spp_windows_matches_jax_f64(rng):
    empty = [f"feature_extraction.branch{i}" for i in range(3)]
    tm = check_psmnet_step_f64(rng, 48, 64, still={f"{b}.BatchNorm_0.mean" for b in empty})
    for b in empty:
        assert not tm.get_parameter(f"{b}.Conv_0.kernel").grad.any(), b
        assert not tm.get_parameter(f"{b}.BatchNorm_0.scale").grad.any(), b
        assert tm.get_parameter(f"{b}.BatchNorm_0.bias").grad.any(), b
