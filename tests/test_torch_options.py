"""Model options of the port's factory (``create_model(name, maxdisparity,
**kwargs)``, as JAX's ``dsmnet_tpu/models/__init__.py:30``):

  * ``remat`` (PSMNet: each hourglass; GCNet: each 3-D stage, the volume
    built inside the two stages that read it): one float64 train step with
    and without it gives the same loss, gradients, parameters and BN
    running statistics to 1e-12 relative (the backward adds the same terms
    in another order; the recomputation updates no statistic; gradients
    that are 0 in exact arithmetic are held to 1e-12 absolute), and the
    remat'd modules really run twice.

Two tests (``--dist loadfile`` queues a file of three or fewer behind
``test_train_zoo.py``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step
from test_torch_train import _relerr


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batch(rng, n, h, w, maxdisp):
    b = rng.rand(n, h, w, 7)
    b[..., 6] = b[..., 6] * (maxdisp - 2) + 1
    return torch.from_numpy(b)


# name -> (maxdisparity, N, H, W, the modules that remat recomputes)
REMAT_CASES = {
    "psmnet": (16, 1, 256, 256, ("dres2", "dres3", "dres4")),
    "gcnet": (24, 2, 64, 96, ("layer3d.l21", "layer3d.l24", "layer3d.l31", "layer3d.l19",
                              "layer3d.l36")),
}


@pytest.mark.parametrize("name", sorted(REMAT_CASES))
def test_remat_step_matches_plain_step_f64(name, rng):
    maxdisp, n, h, w, recomputed = REMAT_CASES[name]
    batch = _batch(rng, n, h, w, maxdisp)
    runs = {}
    for remat in (False, True):
        tm = t_create_model(name, maxdisp, remat=remat).reset_parameters(
            torch.Generator().manual_seed(0)).double()
        calls = {m: 0 for m in recomputed}
        for m in recomputed:
            def count(mod, args, _m=m):
                calls[_m] += 1
            tm.get_submodule(m).register_forward_pre_hook(count)
        state, opt = create_train_state(tm, device="cpu")
        out = make_supervised_train_step(tm, opt)(state, batch, 1e-3, np.ones(1))
        runs[remat] = (out, tm)
        # each remat'd module runs once forward, and once more in the backward
        assert calls == {m: 2 if remat else 1 for m in recomputed}, calls
    (out0, m0), (out1, m1) = runs[False], runs[True]
    # the backward adds the same terms in another order: 1e-12 relative
    assert out1["loss"].item() == pytest.approx(out0["loss"].item(), rel=1e-12)
    zero = chip_smoke.zero_gradient_params(m0)
    p0, p1 = dict(m0.named_parameters()), dict(m1.named_parameters())
    for k, t in p0.items():
        g0, g1 = t.grad.numpy(), p1[k].grad.numpy()
        if k in zero:  # rounding noise on both sides
            assert np.abs(g0).max() <= 1e-12 and np.abs(g1).max() <= 1e-12, k
            continue
        assert _relerr(g1, g0) <= 1e-12, (k, _relerr(g1, g0))
        assert _relerr(p1[k].detach().numpy(), t.detach().numpy()) <= 1e-12, k
    b0, b1 = dict(m0.named_buffers()), dict(m1.named_buffers())
    for k, t in b0.items():
        assert _relerr(b1[k].numpy(), t.numpy()) <= 1e-12, (k, _relerr(b1[k].numpy(), t.numpy()))
