"""Model options of the port's factory (``create_model(name, maxdisparity,
**kwargs)``, as JAX's ``dsmnet_tpu/models/__init__.py:30``):

  * ``remat`` (PSMNet: each hourglass; GCNet: each 3-D stage, the volume
    built inside the two stages that read it): one float64 train step with
    and without it gives the same loss, gradients, parameters and BN
    running statistics to 1e-12 relative (the backward adds the same terms
    in another order; the recomputation updates no statistic; gradients
    that are 0 in exact arithmetic are held to 1e-12 absolute), and the
    remat'd modules really run twice;
  * PSMNet's ``fused_stem=False``: the masked concat volume and a plain
    ConvBN ``dres0_0``, against the JAX model with ``fused_stem=False``, a
    train-mode forward in float64: the three disparities and the updated BN
    statistics to 1e-9 (the JAX regression's float32 casts read as float64,
    as in ``test_torch_train_zoo.py``).

Three tests (``--dist loadfile`` queues a file of three or fewer behind
``test_train_zoo.py``); DispNetC's ``corr_d`` and every model's
``count_levels`` are in ``test_torch_zoo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dsmnet_tpu.models import create_model as j_create_model
from dsmnet_tpu.ops import regression as j_regression
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.models import create_model as t_create_model
from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step
from test_torch_train import _flat, _relerr, _seeded_flax_variables
from test_torch_train_zoo import _NoFloat32
from torch_jax_dots import f64_convs_as_dots
from torch_parallel_ranks import worker_cpus


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    with worker_cpus():
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


def test_psmnet_without_fused_stem_matches_jax_f64(rng, monkeypatch):
    maxdisp, h, w = 16, 256, 256
    imL, imR = rng.rand(1, h, w, 3), rng.rand(1, h, w, 3)
    tm = t_create_model("psmnet", maxdisp, fused_stem=False).reset_parameters(
        torch.Generator().manual_seed(0))
    assert tuple(tm.dres0_0.Conv_0.kernel.shape) == (3, 3, 3, 64, 32)
    monkeypatch.setattr(j_regression, "jnp", _NoFloat32())
    with jax.enable_x64(), f64_convs_as_dots():
        jm = j_create_model("psmnet", maxdisparity=maxdisp, fused_stem=False)
        v = _seeded_flax_variables(jm, tm, h, w, rng)
        v_np = jax.tree.map(np.asarray, v)
        fwd = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=True, mutable=["batch_stats"]))
        (_, ref), mut = fwd(v, jnp.asarray(imL), jnp.asarray(imR))
        ref = [np.asarray(d) for d in ref]
        ref_stats = _flat(mut["batch_stats"])

    tm = t_create_model("psmnet", maxdisp, fused_stem=False).double()
    interop.load_flax_variables(tm, v_np["params"], v_np["batch_stats"])
    tm.train()
    with torch.no_grad():
        _, outs = tm(torch.from_numpy(imL), torch.from_numpy(imR))
    assert len(outs) == len(ref) == 3
    for o, r in zip(outs, ref):
        assert o.shape == r.shape and o.dtype == torch.float64
        assert _relerr(o.numpy(), r) <= 1e-9, _relerr(o.numpy(), r)
    buffers = dict(tm.named_buffers())
    assert set(buffers) == set(ref_stats)
    for k, t in buffers.items():
        assert _relerr(t.numpy(), ref_stats[k]) <= 1e-9, (k, _relerr(t.numpy(), ref_stats[k]))
