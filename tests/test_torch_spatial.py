"""Spatial (H) sharding of the port over the ``model`` mesh axis, op by op,
on the CPU: ranks are processes on a gloo group
(``torch_parallel_ranks.run_ranks``), each holding a band of rows, and
the JAX op on the whole tensor is the reference, in float64.

  * ``halo_pad`` at 5-D with (above, below) rows (1, 1), (2, 0) and (0, 1)
    on 2 and 4 ranks, forward and adjoint, against numpy;
  * the banded ``conv3d_same``, ``conv3d_s2`` and ``deconv3d_k3s2``
    against the JAX op (``dsmnet_tpu/ops/conv3d.py``) on the whole tensor:
    each band of the output and of dx at 1e-9 relative, dK summed over the
    ranks against ``jax.vjp`` of the lax convolution;
  * the banded fused stem against JAX ``cost_volume_conv3x3`` (its exact
    autodiff, ``cost_volume_conv3x3_raw``), the banded concat volume
    against ``concat_cost_volume``, the banded trilinear soft-argmin
    against JAX's (its float32 casts read as float64), the supervised loss
    (the ranks' shares summed) and D1/EPE against JAX's;
  * the band rule's ``ValueError``; ``replicate`` over a (1, 2) mesh;
    ``shard_dataset_for_host`` by the data coordinate;
  * ``GCNetLR``'s float64 eval forward against JAX's.

A process takes ~3 s to import torch, so the 4-rank cases run in one
group and the 2-rank cases in another (module fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsmnet_tpu.losses import supervised_pyramid_loss as j_supervised_pyramid_loss
from dsmnet_tpu.models.gcnet import GCNetLR as JGCNetLR
from dsmnet_tpu.ops import conv3d as j_conv3d
from dsmnet_tpu.ops import cost_volume as j_cost_volume
from dsmnet_tpu.ops import fused_costvol as j_fused
from dsmnet_tpu.ops import regression as j_regression
from dsmnet_tpu.ops import softargmin as j_softargmin
from dsmnet_tpu.train.metrics import d1_epe as j_d1_epe
from dsmnet_tpu_torch import interop
from dsmnet_tpu_torch.models import GCNetLR
from dsmnet_tpu_torch.models.layers import calibrate_batch_stats
from test_torch_train_zoo import _NoFloat32
from test_torch_zoo import _flax_variables
from torch_parallel_ranks import Ranks

REL = 1e-9

# case -> (whole shape (N, D, H, W, C), (above, below))
HALO_CASES = {"1_1": ((1, 2, 8, 3, 2), (1, 1)), "2_0": ((2, 1, 8, 2, 3), (2, 0)),
              "0_1": ((1, 3, 8, 2, 2), (0, 1))}


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _halo_payload(world, rng):
    out = {}
    for case, (shape, (above, below)) in HALO_CASES.items():
        padded = list(shape)
        padded[2] = shape[2] // world + above + below
        out[case] = {"x": rng.randn(*shape), "rows": (above, below),
                     "g": [rng.randn(*padded) for _ in range(world)]}
    return out


def _conv_payload(rng):
    """x, kernel and the output's cotangent of each banded 3-D conv, at
    shapes whose bands span more than one halo."""
    cases = {"conv3d_same": ((1, 3, 8, 5, 32), (3, 3, 3, 32, 32)),
             "conv3d_s2": ((1, 4, 8, 6, 32), (3, 3, 3, 32, 64)),
             "deconv3d_k3s2": ((1, 2, 4, 3, 64), (3, 3, 3, 32, 64))}
    ops = {"conv3d_same": j_conv3d.conv3d_same, "conv3d_s2": j_conv3d.conv3d_s2,
           "deconv3d_k3s2": j_conv3d.deconv3d_k3s2}
    out = {}
    for name, (xs, ks) in cases.items():
        x, k = rng.randn(*xs), rng.randn(*ks) * 0.1
        with jax.enable_x64():
            y = np.asarray(jax.eval_shape(ops[name], jnp.asarray(x), jnp.asarray(k)).shape)
        out[name] = {"x": x, "k": k, "g": rng.randn(*y)}
    return out


def _volume_payload(rng):
    n, h, w, f = 1, 8, 10, 4
    out = {}
    for mask_left in (True, False):
        fL, fR = rng.randn(n, h, w, f), rng.randn(n, h, w, f)
        out[f"stem_{mask_left}"] = {"fL": fL, "fR": fR, "k": rng.randn(3, 3, 3, 2 * f, 5) * 0.1,
                                    "D": 6, "mask_left": mask_left,
                                    "g": rng.randn(n, 6, h, w, 5)}
        out[f"volume_{mask_left}"] = {"fL": fL, "fR": fR, "D": 7, "mask_left": mask_left,
                                      "g": rng.randn(n, 7, h, w, 2 * f)}
    return out


def _loss_payload(rng):
    n, h, w = 2, 8, 6
    disp = 1.0 + 10.0 * rng.rand(n, h, w, 1)
    gt = disp + rng.randn(n, h, w, 1) * 3.0
    gt[0, :3] = 0.0  # invalid rows in one band only: unequal counts
    gt[1, 5, 2] = 0.0
    return {"disp": disp, "gt": np.abs(gt)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: (inputs, each rank's results)}: the 4-rank group (halo_pad)
    and the 2-rank group (halo_pad and the banded ops), started together."""
    rng = np.random.RandomState(2)
    inputs = {4: {"halo": _halo_payload(4, rng)},
              2: {"halo": _halo_payload(2, rng),
                  "ops": {"convs": _conv_payload(rng), "volumes": _volume_payload(rng),
                          "regression": {"cost": rng.randn(1, 3, 4, 5, 1) * 2.0,
                                         "out_dhw": (12, 16, 20),
                                         "g": rng.randn(1, 16, 20, 1)},
                          "loss": _loss_payload(rng)}}}
    names = {"halo": "halo_pads", "ops": "banded_ops"}
    groups = {world: Ranks("suite", world, tmp_path_factory.mktemp(f"sp{world}"),
                           {k: (names[k], v) for k, v in p.items()})
              for world, p in inputs.items()}
    with groups[4], groups[2]:
        return {world: (inputs[world], g.results()) for world, g in groups.items()}


@pytest.fixture(scope="module")
def two_ranks(ranks):
    return ranks[2]


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_halo_pad_forward_and_adjoint(case, world, ranks):
    """Each rank's padded band is its rows of the whole tensor zero-padded
    by (above, below); the gradients scatter each halo's cotangent back to
    the rows it came from (the adjoint: sum <pad(x), g> = sum <x, dx>)."""
    inputs, results = ranks[world]
    p = inputs["halo"][case]
    r = [o["halo"][case] for o in results]
    x, (above, below) = p["x"], p["rows"]
    rows = x.shape[2] // world
    xp = np.pad(x, [(0, 0), (0, 0), (above, below), (0, 0), (0, 0)])
    dxp = np.zeros_like(xp)
    for m in range(world):
        np.testing.assert_array_equal(r[m]["y"], xp[:, :, m * rows:m * rows + rows + above + below])
        dxp[:, :, m * rows:m * rows + rows + above + below] += p["g"][m]
        assert r[m]["exchanges"] == 2  # the forward's and the backward's
    dx = np.concatenate([o["dx"] for o in r], axis=2)
    np.testing.assert_allclose(dx, dxp[:, :, above:above + x.shape[2]], rtol=1e-15, atol=1e-15)
    lhs = sum((o["y"] * g).sum() for o, g in zip(r, p["g"]))
    np.testing.assert_allclose(lhs, (x * dx).sum(), rtol=1e-12)


_LAX = {"conv3d_same": lambda x, k: j_conv3d._conv(x, k, [(1, 1)] * 3),
        "conv3d_s2": j_conv3d._conv_s2_native, "deconv3d_k3s2": j_conv3d._deconv_native}
_OPS = {"conv3d_same": j_conv3d.conv3d_same, "conv3d_s2": j_conv3d.conv3d_s2,
        "deconv3d_k3s2": j_conv3d.deconv3d_k3s2}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_banded_conv3d_matches_jax_whole(name, two_ranks):
    p = two_ranks[0]["ops"]["convs"][name]
    r = [o["ops"][name] for o in two_ranks[1]]
    with jax.enable_x64():
        x, k, g = (jnp.asarray(p[key]) for key in ("x", "k", "g"))
        y, vjp = jax.vjp(_OPS[name], x, k)
        dx = vjp(g)[0]
        dk = jax.vjp(_LAX[name], x, k)[1](g)[1]
    y, dx, dk = (np.asarray(a) for a in (y, dx, dk))
    assert _rel(np.concatenate([o["y"] for o in r], axis=2), y) <= REL
    assert _rel(np.concatenate([o["dx"] for o in r], axis=2), dx) <= REL
    assert _rel(sum(o["dk"] for o in r), dk) <= REL


@pytest.mark.parametrize("mask_left", [True, False], ids=["masked", "dense"])
@pytest.mark.parametrize("kind", ["stem", "volume"])
def test_banded_volumes_match_jax_whole(kind, mask_left, two_ranks):
    """The fused stem (kernel J's op) and the concat volume (kernel H's) on
    bands of the features, the stem with its halo rows."""
    p = two_ranks[0]["ops"]["volumes"][f"{kind}_{mask_left}"]
    r = [o["ops"][f"{kind}_{mask_left}"] for o in two_ranks[1]]
    D = p["D"]
    with jax.enable_x64():
        if kind == "stem":
            fn = lambda a, b, c: j_fused.cost_volume_conv3x3_raw(a, b, c, D, mask_left)
            op = lambda a, b, c: j_fused.cost_volume_conv3x3(a, b, c, D, mask_left)
            args = [jnp.asarray(p[key]) for key in ("fL", "fR", "k")]
        else:
            fn = lambda a, b: j_cost_volume.concat_cost_volume_reference(a, b, D, mask_left)
            op = lambda a, b: j_cost_volume.concat_cost_volume(a, b, D, mask_left)
            args = [jnp.asarray(p[key]) for key in ("fL", "fR")]
        # jitted: one compile instead of an eager dispatch per op
        y_op = np.asarray(jax.jit(op)(*args))
        y, grads = jax.jit(lambda g, *a: (fn(*a), jax.vjp(fn, *a)[1](g)))(
            jnp.asarray(p["g"]), *args)
        grads = [np.asarray(a) for a in grads]
    out = np.concatenate([o["y"] for o in r], axis=2)
    assert _rel(out, np.asarray(y)) <= REL and _rel(out, y_op) <= REL
    assert _rel(np.concatenate([o["dfL"] for o in r], axis=1), grads[0]) <= REL
    assert _rel(np.concatenate([o["dfR"] for o in r], axis=1), grads[1]) <= REL
    if kind == "stem":
        assert _rel(sum(o["dk"] for o in r), grads[2]) <= REL


def test_banded_trilinear_soft_argmin_matches_jax(two_ranks, monkeypatch):
    """Output rows near a band's edge interpolate across it; JAX's float32
    casts read as float64."""
    p = two_ranks[0]["ops"]["regression"]
    r = [o["ops"]["regression"] for o in two_ranks[1]]
    monkeypatch.setattr(j_regression, "jnp", _NoFloat32())
    with jax.enable_x64():
        fn = lambda c: j_regression.trilinear_soft_argmin(c, p["out_dhw"], negate=False)
        y, vjp = jax.vjp(fn, jnp.asarray(p["cost"]))
        dcost = np.asarray(vjp(jnp.asarray(p["g"]))[0])
    assert _rel(np.concatenate([o["y"] for o in r], axis=1), np.asarray(y)) <= REL
    assert _rel(np.concatenate([o["dcost"] for o in r], axis=2), dcost) <= REL


def test_banded_supervised_loss_and_metrics_match_jax(two_ranks):
    """The masked L1 and the smoothness term (whose dy reads the next band's
    first row) over the global count; the ranks' shares sum to JAX's loss,
    their gradients concatenate to its gradient; D1/EPE on every rank."""
    p = two_ranks[0]["ops"]["loss"]
    r = [o["ops"]["loss"] for o in two_ranks[1]]
    with jax.enable_x64():
        gt = jnp.asarray(p["gt"])
        fn = lambda d: j_supervised_pyramid_loss(gt, [d], [0], jnp.ones(1))
        loss, ddisp = jax.jit(jax.value_and_grad(fn))(jnp.asarray(p["disp"]))
        ddisp = np.asarray(ddisp)
        d1, epe = (float(v) for v in jax.jit(j_d1_epe)(jnp.asarray(p["disp"]), gt))
    assert _rel(sum(o["loss"] for o in r), np.asarray(loss)) <= REL
    assert _rel(np.concatenate([o["ddisp"] for o in r], axis=1), ddisp) <= REL
    for o in r:
        np.testing.assert_allclose(o["d1_epe"], (d1, epe), rtol=REL)


def test_band_rule_replicate_and_data_shards(two_ranks):
    """A band that is not a whole multiple of the model's rows raises a
    ValueError that states the rule; ``replicate`` gives both ranks of a
    (1, 2) mesh the first rank's state; ``shard_dataset_for_host`` cuts the
    datasets by the data coordinate, so both model ranks read every
    sample."""
    r = two_ranks[1]
    for o in r:
        odd, ragged, uneven, gcnet = o["ops"]["rule"]
        assert "must be a whole multiple of 4 rows" in odd  # 3 rows a band
        assert "must be a whole multiple of 4 rows" in ragged  # 6 rows a band
        assert "does not split into 2 bands" in uneven
        assert "(H/2)/M by 16" in gcnet and "H = 24" in gcnet  # a model's forward
        assert o["ops"]["dataset_shard"] == (0, 1, 6)
    assert r[0]["ops"]["replicate"] == r[1]["ops"]["replicate"]


def test_gcnet_lr_eval_matches_jax_f64(rng, monkeypatch):
    """``GCNetLR`` (the bidirectional GCNet outside the factory) in float64
    eval mode, with the port's seeded weights and calibrated BN statistics
    carried into the flax tree; the soft-argmin's float32 cast read as
    float64."""
    maxdisp, h, w = 16, 64, 96
    imL, imR = rng.rand(1, h, w, 3), rng.rand(1, h, w, 3)
    tm = GCNetLR(maxdisp).reset_parameters(torch.Generator().manual_seed(0))
    calibrate_batch_stats(tm, torch.from_numpy(imL).float(), torch.from_numpy(imR).float())
    jm = JGCNetLR(maxdisparity=maxdisp)
    variables = _flax_variables(jm, tm, h, w)
    monkeypatch.setattr(j_softargmin, "jnp", _NoFloat32())
    with jax.enable_x64():
        jv = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        ref = [np.asarray(d) for d in jax.jit(lambda v, a, b: jm.apply(
            v, a, b, train=False))(jv, jnp.asarray(imL), jnp.asarray(imR))]
    tm = GCNetLR(maxdisp).double()
    interop.load_flax_variables(tm, variables["params"], variables.get("batch_stats"))
    tm.eval()
    with torch.no_grad():
        outs = tm(torch.from_numpy(imL), torch.from_numpy(imR))
    for o, ref_o in zip(outs, ref):
        assert o.shape == ref_o.shape == (1, h, w, 1)
        assert _rel(o.numpy(), ref_o) <= REL
    assert not np.allclose(ref[0], ref[1])  # two views, two maps
