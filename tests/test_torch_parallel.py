"""The port's ``parallel/`` package on the CPU: ranks are processes on a
gloo group (``torch_parallel_ranks.run_ranks``), and the JAX package's
``parallel`` on ``conftest.py``'s 8 CPU devices is the reference.

  * ``make_mesh``: shapes, coordinates and errors on 4 ranks (a mesh must
    cover every rank);
  * ``halo_conv2d`` on 4 ranks against JAX's ``halo_conv2d`` on
    ``make_mesh(data=1, model=4)`` and the unsharded conv, 3x3 and 1x1
    (``tests/test_parallel.py:108-121,174-186``), its gradients against the
    unsharded conv's;
  * ``LeanBN`` on 2 ranks against one process on the concatenated batch,
    float64, 1e-12;
  * the photometric losses with one rank under 1024 valid pixels and the
    global count over 1024, the supervised loss with unequal mask counts,
    and D1/EPE, against one process on the concatenated batch;
  * ``shard_batch``, ``replicate``, ``global_batch_from_host_local`` (a
    mismatched local shape raises on every rank), ``host_shard`` and
    ``shard_dataset_for_host`` (``tests/test_parallel.py:124-161``);
  * ``init_distributed`` from a coordinator and from torchrun's
    environment; the CLI's flags; the sharding context and its call sites.

A process takes ~3 s to import torch, so the 4-rank cases run in one
group and the 2-rank cases in another (module fixtures), and each test
reads its part of their results.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dsmnet_tpu import parallel as j_parallel
from dsmnet_tpu.parallel.halo import halo_conv2d as j_halo_conv2d
from dsmnet_tpu_torch import cli
from dsmnet_tpu_torch.data import BatchLoader, ConcatDataset, SyntheticStereoDataset
from dsmnet_tpu_torch.losses import PhotoLossConfig, photometric_pyramid_loss
from dsmnet_tpu_torch.losses import supervised_pyramid_loss
from dsmnet_tpu_torch.models import create_model
from dsmnet_tpu_torch.models.layers import LeanBN
from dsmnet_tpu_torch.parallel import context, multihost
from dsmnet_tpu_torch.parallel import (
    ShardingContext,
    activate,
    current,
    host_shard,
    shard_activation,
    shard_cost_volume,
    shard_dataset_for_host,
)
from dsmnet_tpu_torch.train import draw_selfsup_params, selfsup_generator
from dsmnet_tpu_torch.train.metrics import d1_epe
from chip_smoke import free_port
from torch_parallel_ranks import run_ranks


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_HALO_CASES = {"3x3": ((2, 32, 16, 4), (3, 3, 4, 6)), "1x1": ((1, 16, 8, 3), (1, 1, 3, 5))}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """(inputs, each rank's results) of the 4-rank cases: make_mesh, and
    halo_conv2d at 3x3 and 1x1 (tests/test_parallel.py:108-121,174-186)."""
    rng = np.random.RandomState(0)
    inputs = {}
    for case, (shape, kernel) in _HALO_CASES.items():
        inputs[case] = {"x": rng.randn(*shape).astype(np.float32),
                        "k": rng.randn(*kernel).astype(np.float32),
                        "g": rng.randn(*shape[:3], kernel[-1]).astype(np.float32)}
    payload = {"mesh": ("mesh_shapes", None),
               **{case: ("halo", p) for case, p in inputs.items()}}
    return inputs, run_ranks("suite", 4, tmp_path_factory.mktemp("four"), payload)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(inputs, each rank's results) of the 2-rank cases."""
    rng = np.random.RandomState(0)
    inputs = {"bn": {"x": rng.randn(4, 5, 6, 8) * 2.0 + 0.5, "g": rng.randn(4, 5, 6, 8),
                     "scale": 1.0 + 0.1 * rng.randn(8), "bias": 0.1 * rng.randn(8)},
              "losses": _loss_inputs(rng),
              "placement": {"batch": rng.rand(4, 3, 5, 7).astype(np.float32)},
              "checks": None}
    names = {"bn": "lean_bn", "losses": "losses", "placement": "placement",
             "checks": "mesh_checks"}
    payload = {k: (names[k], p) for k, p in inputs.items()}
    return inputs, run_ranks("suite", 2, tmp_path_factory.mktemp("two"), payload)


def test_make_mesh_shapes_and_errors(four_ranks):
    for rank, out in enumerate(r["mesh"] for r in four_ranks[1]):
        assert out["all"] == ((4, 1), ("data", "model"), 4, rank, 0)
        assert out["2x2"] == ((2, 2), ("data", "model"), 2, rank // 2, rank % 2)
        assert out["model2"] == out["2x2"]
        assert out["1x4"] == ((1, 4), ("data", "model"), 1, 0, rank)
        assert "exceeds 4 ranks" in out["16x1"]
        assert "not divisible by model=3" in out["model3"]
        assert "does not cover" in out["2x1"]  # JAX would leave two devices idle
    # JAX's errors for the same shapes (tests/test_parallel.py:29-35)
    with pytest.raises(ValueError):
        j_parallel.make_mesh(data=16, model=1)


def _unsharded_conv(x, k, g):
    """The whole tensor's SAME conv in float64 and the gradients of
    sum(out * g) with respect to x and k (torch autograd)."""
    xt = torch.from_numpy(x).double().requires_grad_(True)
    kt = torch.from_numpy(k).double().requires_grad_(True)
    ph, pw = k.shape[0] // 2, k.shape[1] // 2
    out = F.conv2d(xt.permute(0, 3, 1, 2), kt.permute(3, 2, 0, 1), padding=(ph, pw))
    out = out.permute(0, 2, 3, 1)
    (out * torch.from_numpy(g).double()).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), kt.grad.numpy()


@pytest.mark.parametrize("case", sorted(_HALO_CASES))
def test_halo_conv2d_matches_jax_and_unsharded(case, four_ranks):
    x, k, g = (four_ranks[0][case][key] for key in ("x", "k", "g"))
    j_out = np.asarray(j_halo_conv2d(jnp.asarray(x), jnp.asarray(k),
                                     j_parallel.make_mesh(data=1, model=4), axis_name="model"))
    ref, dx, dk = _unsharded_conv(x, k, g)
    r = [o[case] for o in four_ranks[1]]
    out = np.concatenate([o["out"] for o in r], axis=1)
    np.testing.assert_allclose(out, j_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # each band's gradient, and the kernel's summed over the ranks
    np.testing.assert_allclose(np.concatenate([o["dx"] for o in r], axis=1), dx,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(o["dk"] for o in r), dk, rtol=1e-5, atol=1e-4)


def test_lean_bn_two_ranks_match_concatenated_batch(two_ranks):
    x, g, scale, bias = (two_ranks[0]["bn"][k] for k in ("x", "g", "scale", "bias"))
    r = [o["bn"] for o in two_ranks[1]]
    bn = LeanBN(8).double()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([o["y"] for o in r]), y.detach().numpy(), **tol)
    np.testing.assert_allclose(np.concatenate([o["dx"] for o in r]), xt.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(o["dscale"] for o in r), bn.scale.grad.numpy(), **tol)
    np.testing.assert_allclose(sum(o["dbias"] for o in r), bn.bias.grad.numpy(), **tol)
    for o in r:  # the running statistics, from the global moments, on every rank
        np.testing.assert_allclose(o["mean"], bn.mean.numpy(), **tol)
        np.testing.assert_allclose(o["var"], bn.var.numpy(), **tol)
        assert o["collectives"] == {"bn_moments": 1, "bn_moments_grad": 1}


def _loss_inputs(rng):
    """Two samples whose warps leave 256 valid pixels in sample 0 (a
    disparity of 40 on a 48-wide image) and ~1.5k in sample 1; ground truth
    with a third of sample 0 invalid."""
    n, h, w = 2, 32, 48
    disp = np.stack([np.full((h, w, 1), 40.0), 1.0 + rng.rand(h, w, 1)])
    gt = disp + rng.randn(n, h, w, 1) * 4.0
    gt[0, : h // 3] = 0.0
    im = lambda: 0.1 + 0.9 * rng.rand(n, h, w, 3)
    return {"imL": im(), "imR": im(), "imL1": im(), "imR1": im(), "disp": disp,
            "disp1": 1.0 + 3.0 * rng.rand(n, h, w, 1), "gt": gt}


def test_losses_and_metrics_are_global(two_ranks):
    """One rank holds fewer than 1024 valid pixels, the global batch more:
    the photometric fallback decides on the global count, the means are
    global, and the ranks' losses sum to the one process's on the
    concatenated batch (their gradients concatenate to its gradients)."""
    p = two_ranks[0]["losses"]
    r = [o["losses"] for o in two_ranks[1]]
    assert r[0]["valid"] < 1024 < r[0]["valid"] + r[1]["valid"]
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    tol = dict(rtol=1e-12, atol=1e-14)
    for kind in ("depthmono", "cap"):
        disp, disp1 = (t[k].clone().requires_grad_(True) for k in ("disp", "disp1"))
        loss = photometric_pyramid_loss(
            PhotoLossConfig(kind, True), t["imR"], t["imL"], [disp], [0], (0, 0), t["imR1"],
            t["imL1"], [disp1], [0], (0, 0), np.ones(1))
        loss.backward()
        np.testing.assert_allclose(sum(o[kind][0] for o in r), loss.item(), **tol)
        np.testing.assert_allclose(np.concatenate([o[kind][1] for o in r]), disp.grad.numpy(),
                                   **tol)
        np.testing.assert_allclose(np.concatenate([o[kind][2] for o in r]),
                                   disp1.grad.numpy(), **tol)
    disp = t["disp"].clone().requires_grad_(True)
    loss = supervised_pyramid_loss(t["gt"], [disp], [0], np.ones(1))
    loss.backward()
    np.testing.assert_allclose(sum(o["supervised"][0] for o in r), loss.item(), **tol)
    np.testing.assert_allclose(np.concatenate([o["supervised"][1] for o in r]),
                               disp.grad.numpy(), **tol)
    d1, epe = d1_epe(t["disp"], t["gt"])
    for o in r:
        np.testing.assert_allclose(o["d1_epe"], (d1.item(), epe.item()), **tol)


def test_shard_replicate_and_host_local_batch(two_ranks):
    b = two_ranks[0]["placement"]["batch"]
    r = [o["placement"] for o in two_ranks[1]]
    for rank, o in enumerate(r):
        np.testing.assert_array_equal(o["shard"], b[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(o["shard_tensor"], b[2 * rank:2 * rank + 2])
        assert "does not split over the 2 ranks" in o["shard_odd"]
        np.testing.assert_array_equal(o["local"], b[2 * rank:2 * rank + 2])
        assert "different shapes" in o["mismatch"]  # on both ranks
        assert o["step"] == 5
    for k, v in r[0]["state"].items():
        np.testing.assert_array_equal(r[1]["state"][k], v, err_msg=k)
    for a, b_ in zip(r[0]["adam"], r[1]["adam"]):
        np.testing.assert_array_equal(a, b_)
    assert np.all(r[0]["adam"][0] != 0)


def test_host_shard_and_dataset_sharding(monkeypatch):
    assert host_shard(list(range(6)), 0, 3) == [0, 3]
    assert host_shard(list(range(5))) == list(range(5))  # one process

    class FakeDS:
        paths_img_left = [f"L{i}" for i in range(10)]
        paths_img_right = [f"R{i}" for i in range(10)]
        paths_disp_left = None
        paths_disp_right = None

    ds, syn = FakeDS(), SyntheticStereoDataset(n=7, hw=(8, 8))
    # simulate rank 1 of 2, as tests/test_parallel.py does for host 1 of 2
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    concat = ConcatDataset([syn])
    concat.datasets.insert(0, ds)  # a concat of a path-list dataset and a path-less one
    shard_dataset_for_host(concat)
    assert ds.paths_img_left == ["L1", "L3", "L5", "L7", "L9"]
    assert ds.paths_img_right == ["R1", "R3", "R5", "R7", "R9"]
    assert (syn.index_offset, syn.index_stride, len(syn)) == (1, 2, 3)
    assert [syn[i][1] for i in range(3)] == [f"synthetic_{i:06d}.png" for i in (1, 3, 5)]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        shard_dataset_for_host(object())
    assert "SAME samples" in str(w[0].message)


def test_batch_loader_rank_slices():
    """Every rank cuts the same seeded global batches in rank order."""
    ds = SyntheticStereoDataset(n=8, hw=(4, 6))

    def names(**kw):
        return [n for _, n in BatchLoader(ds, 4, shuffle=True, num_workers=2, seed=3, **kw)]

    whole = names()
    parts = [names(rank_slice=(r, 2)) for r in range(2)]
    assert [p0 + p1 for p0, p1 in zip(*parts)] == whole
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        next(iter(BatchLoader(ds, 4, rank_slice=(0, 3))))


def test_init_distributed_paths(tmp_path, monkeypatch):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.init_distributed() is False  # no coordinator, no environment
    with pytest.raises(ValueError, match="need a coordinator"):
        multihost.init_distributed(num_processes=2)
    r = run_ranks("init_paths", 2, tmp_path, {"port": free_port(), "env_port": free_port()})
    for rank, o in enumerate(r):
        assert o["none"] is False
        assert o["coordinator"] == (True, rank, 2, 3.0)
        assert o["env"] == (True, rank, 2, 3.0, "gloo")


def test_cli_mesh_flags(two_ranks):
    args = cli.build_parser().parse_args(
        ["--mesh-data", "4", "--mesh-model", "1", "--multihost", "--coordinator", "h:1",
         "--num_processes", "2", "--process_id", "1"])
    assert (args.mesh_data, args.mesh_model, args.multihost, args.coordinator,
            args.num_processes, args.process_id) == (4, 1, True, "h:1", 2, 1)
    d = cli.build_parser().parse_args([])
    assert (d.mesh_data, d.mesh_model, d.multihost, d.coordinator, d.num_processes,
            d.process_id) == (0, 1, False, "", 0, -1)  # JAX's defaults
    base = ["--mode", "train", "--net", "dispnet", "--maxdisparity", "16", "--dataset",
            "synthetic", "--device", "cpu"]
    for flag in ("--mesh-model", "--mesh-data"):
        with pytest.raises(ValueError, match="exceeds the one rank"):
            cli.main(base + [flag, "2"])
    # under a group of 2: --mesh-model 2 makes a (1, 2) mesh; a photometric
    # loss runs on it (DispNet does not band: its bucket sums over the data
    # group of one); a mesh that leaves a rank out, or exceeds them, raises
    for rank, o in enumerate(r["checks"] for r in two_ranks[1]):
        assert o["cli_mesh_model2"] == ((1, 2), rank)
        assert o["trainer_model2"] == ("model", False, 1)
        assert o["cli_model2"] == ("model", True, [])
        assert o["cli_data1"] == ("ValueError", "mesh 1x1 does not cover the 2 ranks: a rank "
                                                "outside the mesh would train alone")
        assert o["cli_data4"] == ("ValueError", "mesh 4x1 exceeds 2 ranks")
        assert o["group_kept"]


def test_trainer_places_batches_and_draws_on_mesh(two_ranks):
    """The Trainer's part of a global batch (``shard_batch``, as JAX's
    ``Trainer._place_batch``, tests/test_parallel.py:164-172) or of a loader
    cut by ``rank_slice`` (its own batch), the global batch's size for the
    meters, and its rows of the draws JAX makes for the global batch."""
    batch = np.arange(4 * 2 * 3 * 7, dtype=np.float32).reshape(4, 2, 3, 7)
    draws = draw_selfsup_params(selfsup_generator(1, 0), 4)
    for rank, o in enumerate(r["checks"] for r in two_ranks[1]):
        placed, n = o["place_global"]
        np.testing.assert_array_equal(placed, batch[2 * rank:2 * rank + 2])
        assert n == 4
        placed, n = o["place_local"]
        np.testing.assert_array_equal(placed, batch[:2])
        assert n == 4
        want = draws.rows(2 * rank, 2 * rank + 2)
        for got, ref in zip(o["draws"], (want.order, want.u, want.alpha, want.eps)):
            np.testing.assert_array_equal(got, ref.numpy())


def test_context_and_its_call_sites(monkeypatch):
    """activate/current nest; without a context the reductions are the
    single-process expressions; with a spatial axis, outside a banded
    section, the call sites are the identity (a model that does not band
    runs whole); the models and ops reach them."""
    assert current() is None
    a, b = ShardingContext(mesh=None), ShardingContext(mesh=None, spatial_axis="model")
    with activate(a):
        assert current() is a
        with activate(b):
            assert current() is b
        assert current() is a
    assert current() is None
    x = torch.arange(6.0).reshape(2, 3)
    assert context.data_sum(x) is x and context.data_numel(x) == 6
    assert context.mean_share(x).item() == context.data_mean(x).item() == 2.5
    assert shard_activation(x) is x and shard_cost_volume(x) is x
    with activate(b):
        assert not context.in_band()
        assert shard_activation(x) is x and shard_cost_volume(x) is x
    from dsmnet_tpu_torch.models import gcnet, psmnet

    calls = []
    spy = lambda t: calls.append(tuple(t.shape)) or t
    for mod in (gcnet, psmnet):
        monkeypatch.setattr(mod, "shard_activation", spy)
    monkeypatch.setattr(context, "shard_cost_volume", spy)
    with torch.no_grad():
        # PSMNet at 256x256: every SPP pool (64x64 at 1/4) has a window
        for name, kw, hw in (("gcnet", {}, 64), ("psmnet", {}, 256),
                             ("psmnet", {"fused_stem": False}, 256)):
            calls.clear()
            img = torch.rand(1, hw, hw, 3)
            create_model(name, 16, **kw).eval()(img, img)
            assert len(calls) == 3, (name, kw, calls)  # fL, fR and the volume
