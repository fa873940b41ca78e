"""Ranks of the port's data-parallel tests, run as processes on the CPU.

``run_ranks(name, world, tmp_path, payload)`` starts ``world`` Python
processes (``Ranks`` starts them and returns, so that the test computes
its reference while they run); each makes a gloo process group through ``file://`` under
``tmp_path`` (never a fixed port: the test workers run at once), calls
``name(rank, world, payload)`` of this module with one CPU thread, and
returns what it returned.  The test computes its JAX reference itself and
passes numpy arrays in ``payload``: this module and the ranks import no
JAX.  A rank that fails, or a run that outlasts its timeout, kills every
rank and fails the test, so a hung collective never holds the suite; each
group also has a 60 s timeout of its own.

``worker_cpus`` lowers the priority of a heavy test's own threads (XLA's
CPU pool among them) in its pytest-xdist worker while it runs; its ranks
run at the suite's priority.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
BASE_NICE = os.getpriority(os.PRIO_PROCESS, 0)  # at import, before a test lowers it
# a heavy test's threads under pytest-xdist: at this priority a CPU that the
# suite's critical path also wants gives them about a quarter of its time,
# and a CPU that nobody else wants all of it
WORKER_NICE = BASE_NICE + 5


def _set_priority(nice: int) -> None:
    """Every thread of this process at priority ``nice``."""
    for tid in map(int, os.listdir("/proc/self/task")):
        try:
            os.setpriority(os.PRIO_PROCESS, tid, nice)
        except OSError:  # a thread that ended meanwhile, or no right to raise a priority
            pass


@contextlib.contextmanager
def worker_cpus():
    """Under pytest-xdist, this worker's threads (a JAX reference's XLA pool
    among them) at ``WORKER_NICE`` while the test runs, so that they take
    the CPU time that the suite's critical path (``tests/test_train_zoo.py``,
    on another worker) leaves; the test's ranks run at the suite's priority.
    A single process keeps its priority."""
    if not os.environ.get("PYTEST_XDIST_WORKER", "").startswith("gw"):
        yield
        return
    _set_priority(WORKER_NICE)
    try:
        yield
    finally:
        _set_priority(BASE_NICE)


class Ranks:
    """``name(rank, world, payload)`` started in ``world`` processes; the
    caller may compute its reference meanwhile, then read ``results()``."""

    def __init__(self, name: str, world: int, tmp_path, payload=None, timeout: float = 120.0):
        self.name, self.world, self.timeout = name, world, timeout
        self.work = work = Path(tmp_path) / f"ranks_{name}_{time.monotonic_ns()}"
        work.mkdir(parents=True)
        with open(work / "payload.pkl", "wb") as f:
            pickle.dump(payload, f)
        path = os.pathsep.join(p for p in (str(REPO), str(TESTS), os.environ.get("PYTHONPATH"))
                               if p)
        env = dict(os.environ, PYTHONPATH=path, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   TEST_RANK_NICE=str(BASE_NICE))
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(key, None)
        self.procs, self.logs = [], []
        self.deadline = time.monotonic() + timeout
        for rank in range(world):
            log = open(work / f"rank{rank}.log", "w")
            code = (f"import torch_parallel_ranks as m; "
                    f"m._main({name!r}, {rank}, {world}, {str(work)!r})")
            self.procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=work,
                                               stdout=log, stderr=subprocess.STDOUT))
            self.logs.append(log)

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        for p in self.procs:  # a test that failed before reading the results
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in self.logs:
            log.close()

    def results(self) -> list:
        """Each rank's result; a rank that failed, or ranks still running at
        the deadline, kill every rank and raise."""
        failed = None
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    failed = f"ranks still running after {self.timeout} s: {codes}"
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in self.logs:
                log.close()
        if failed:
            tails = "\n".join(f"--- rank {r}\n" + (self.work / f"rank{r}.log").read_text()[-3000:]
                              for r in range(self.world))
            raise AssertionError(f"{self.name}: {failed}\n{tails}")
        out = []
        for rank in range(self.world):
            with open(self.work / f"result{rank}.pkl", "rb") as f:
                out.append(pickle.load(f))
        for path in self.work.glob("*.pkl"):  # weights: keep the disk free
            path.unlink()
        return out


def run_ranks(name: str, world: int, tmp_path, payload=None, timeout: float = 120.0) -> list:
    """``name(rank, world, payload)`` in ``world`` processes; their results."""
    return Ranks(name, world, tmp_path, payload, timeout).results()


def _main(name: str, rank: int, world: int, work: str) -> None:
    from dsmnet_tpu_torch.parallel import init_distributed

    # the suite's priority, whatever the spawning test's worker had
    _set_priority(int(os.environ["TEST_RANK_NICE"]))
    torch.set_num_threads(1)
    with open(Path(work) / "payload.pkl", "rb") as f:
        payload = pickle.load(f)
    if name not in _NO_GROUP:
        init_distributed(f"file://{work}/rendezvous", world, rank, backend="gloo",
                         timeout=GROUP_TIMEOUT)
    result = globals()[name](rank, world, payload)
    jax_like = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "dsmnet_tpu"))
    if jax_like:
        raise RuntimeError(f"a rank imported {jax_like}")
    with open(Path(work) / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(_np(t).tobytes()).hexdigest()


def suite(rank, world, payload):
    """Several rank functions in one group (a process costs ~3 s to start):
    ``payload`` maps a key to (function name, its payload)."""
    return {key: globals()[name](rank, world, p) for key, (name, p) in payload.items()}


# ------------------------------------------------------------ parallel/

def mesh_shapes(rank, world, payload):
    """make_mesh's shapes, coordinates and errors on 4 ranks."""
    from dsmnet_tpu_torch.parallel import make_mesh
    from dsmnet_tpu_torch.parallel.mesh import axis_index, axis_size

    out = {}
    for key, kw in (("all", {}), ("2x2", {"data": 2, "model": 2}), ("model2", {"model": 2}),
                    ("1x4", {"data": 1, "model": 4})):
        mesh = make_mesh(**kw)
        out[key] = (tuple(mesh.shape), mesh.mesh_dim_names, axis_size(mesh, "data"),
                    axis_index(mesh, "data"), axis_index(mesh, "model"))
    for key, kw in (("16x1", {"data": 16}), ("model3", {"model": 3}), ("2x1", {"data": 2})):
        try:
            make_mesh(**kw)
            out[key] = None
        except ValueError as exc:
            out[key] = str(exc)
    return out


def halo(rank, world, payload):
    """halo_conv2d of this rank's band of rows over a (1, world) mesh, and
    the gradients of sum(out * g) with respect to the band and the kernel."""
    from dsmnet_tpu_torch.parallel import halo_conv2d, make_mesh

    mesh = make_mesh(data=1, model=world)
    x, k, g = (torch.from_numpy(payload[key]) for key in ("x", "k", "g"))
    rows = x.shape[1] // world
    band = slice(rank * rows, (rank + 1) * rows)
    xl = x[:, band].clone().requires_grad_(True)
    k = k.clone().requires_grad_(True)
    out = halo_conv2d(xl, k, mesh, axis_name="model")
    (out * g[:, band]).sum().backward()
    return {"out": _np(out), "dx": _np(xl.grad), "dk": _np(k.grad)}


def lean_bn(rank, world, payload):
    """A float64 LeanBN in train mode on this rank's samples, under the data
    axis of a (world, 1) mesh: output, gradients, running statistics and
    the all-reduces it made."""
    from dsmnet_tpu_torch.models.layers import LeanBN
    from dsmnet_tpu_torch.parallel import ShardingContext, activate, make_mesh
    from dsmnet_tpu_torch.parallel import context

    x, g = torch.from_numpy(payload["x"]), torch.from_numpy(payload["g"])
    per = x.shape[0] // world
    part = slice(rank * per, (rank + 1) * per)
    bn = LeanBN(x.shape[-1]).double()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(payload["scale"]))
        bn.bias.copy_(torch.from_numpy(payload["bias"]))
    xl = x[part].clone().requires_grad_(True)
    before = dict(context.COLLECTIVES)
    with activate(ShardingContext(make_mesh(data=world))):
        y = bn(xl)
    (y * g[part]).sum().backward()
    made = {k: v - before.get(k, 0) for k, v in context.COLLECTIVES.items()
            if v != before.get(k, 0)}
    return {"y": _np(y), "dx": _np(xl.grad), "dscale": _np(bn.scale.grad),
            "dbias": _np(bn.bias.grad), "mean": _np(bn.mean), "var": _np(bn.var),
            "collectives": made}


def losses(rank, world, payload):
    """This rank's shares of the photometric losses (the fallback kind
    ``depthmono`` and ``cap``), the supervised loss and D1/EPE on its
    samples, with the gradients of the losses with respect to its
    disparities."""
    from dsmnet_tpu_torch.losses import PhotoLossConfig, photometric_pyramid_loss
    from dsmnet_tpu_torch.losses import supervised_pyramid_loss
    from dsmnet_tpu_torch.ops.warp import imwarp
    from dsmnet_tpu_torch.parallel import ShardingContext, activate, make_mesh
    from dsmnet_tpu_torch.train.metrics import d1_epe

    t = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in payload.items()}
    out = {"valid": int((imwarp(t["imR"], t["disp"])[..., :1] != 0).sum())}
    with activate(ShardingContext(make_mesh(data=world))):
        for kind in ("depthmono", "cap"):
            disp, disp1 = (t[k].clone().requires_grad_(True) for k in ("disp", "disp1"))
            loss = photometric_pyramid_loss(
                PhotoLossConfig(kind, True), t["imR"], t["imL"], [disp], [0], (0, 0),
                t["imR1"], t["imL1"], [disp1], [0], (0, 0), np.ones(1))
            loss.backward()
            out[kind] = (_np(loss), _np(disp.grad), _np(disp1.grad))
        disp = t["disp"].clone().requires_grad_(True)
        loss = supervised_pyramid_loss(t["gt"], [disp], [0], np.ones(1))
        loss.backward()
        out["supervised"] = (_np(loss), _np(disp.grad))
        out["d1_epe"] = tuple(_np(v) for v in d1_epe(t["disp"], t["gt"]))
    return out


def placement(rank, world, payload):
    """shard_batch, replicate and global_batch_from_host_local on 2 ranks."""
    from dsmnet_tpu_torch.models import create_model
    from dsmnet_tpu_torch.parallel import (
        global_batch_from_host_local,
        make_mesh,
        replicate,
        shard_batch,
    )
    from dsmnet_tpu_torch.train import create_train_state

    mesh = make_mesh(data=world)
    b = payload["batch"]
    out = {"shard": _np(shard_batch(b, mesh)), "shard_tensor": _np(shard_batch(
        torch.from_numpy(b), mesh))}
    try:
        shard_batch(b[:3], mesh)
    except ValueError as exc:
        out["shard_odd"] = str(exc)
    # each rank draws other weights and takes one Adam step of its own;
    # replicate gives every rank rank 0's parameters, statistics and moments
    model = create_model("gcnet", 16).reset_parameters(torch.Generator().manual_seed(rank))
    state, opt = create_train_state(model, device="cpu")
    for p in model.parameters():
        p.grad = torch.full_like(p, float(rank + 1))
    opt.step()
    for buf in model.buffers():
        buf.fill_(float(rank + 2))
    state.step = 5 + rank
    replicate(state, mesh)
    out["state"] = {k: _np(v) for k, v in model.state_dict().items()}
    out["adam"] = [_np(opt.state[p]["exp_avg"]) for p in model.parameters()]
    out["step"] = state.step
    local = b[2 * rank:2 * rank + 2]
    out["local"] = _np(global_batch_from_host_local(local, mesh, device="cpu"))
    try:
        global_batch_from_host_local(b[:2 + rank], mesh)
    except ValueError as exc:
        out["mismatch"] = str(exc)
    return out


def mesh_checks(rank, world, payload):
    """A Trainer with a photometric loss on a mesh with model > 1 (its
    spatial axis, whether its loss is supervised, its gradient bucket's
    group size), the same through the CLI's --mesh-model 2 (no epoch: its
    spatial axis, whether it has a photometric loss, its loss history);
    what refuses to run on 2 ranks (a --mesh-data that leaves a rank out,
    or exceeds them), the CLI's mesh for --mesh-model 2, and a Trainer's
    placement and draws on a (2, 1) mesh."""
    import argparse

    import torch.distributed as dist

    from dsmnet_tpu_torch import cli
    from dsmnet_tpu_torch.parallel import activate, context, make_mesh
    from dsmnet_tpu_torch.train import TrainConfig, Trainer

    out = {}
    t = Trainer(TrainConfig(net="dispnet", maxdisparity=16, loss_name="Cap_ds-mask",
                            device="cpu"), mesh=make_mesh(data=1, model=2))
    with activate(t._sharding_ctx):
        out["trainer_model2"] = (t._sharding_ctx.spatial_axis, t.spec.supervised,
                                 dist.get_world_size(context.gradient_group(t.model)))
    mesh = cli._make_mesh(argparse.Namespace(mesh_data=0, mesh_model=2))
    out["cli_mesh_model2"] = (tuple(mesh.shape), mesh.get_local_rank("model"))
    # a Trainer on a (2, 1) mesh places its part of a global batch, or of a
    # loader's per-rank batch, and draws its rows of the global batch's draws
    t = Trainer(TrainConfig(net="gcnet", maxdisparity=16, loss_name="Cap_ds-mask",
                            device="cpu"), mesh=make_mesh(data=world))
    batch = np.arange(4 * 2 * 3 * 7, dtype=np.float32).reshape(4, 2, 3, 7)
    sliced = type("Loader", (), {"rank_slice": (rank, world)})()
    out["place_global"] = [_np(a) if torch.is_tensor(a) else a for a in t._place_batch(batch)]
    out["place_local"] = [_np(a) if torch.is_tensor(a) else a
                          for a in t._place_batch(batch[:2], sliced)]
    d = t._draws(2)
    out["draws"] = [_np(v) for v in (d.order, d.u, d.alpha, d.eps)]
    base = ["--mode", "train", "--net", "dispnet", "--maxdisparity", "16", "--dataset",
            "synthetic", "--device", "cpu"]
    t, hist = cli.main(base + ["--mesh-model", "2", "--loss_name", "Cap_ds-mask", "--epochs",
                               "0", "--output", "cli_model2"])
    out["cli_model2"] = (t._sharding_ctx.spatial_axis, t.spec.photo is not None, hist["loss"])
    for key, flags in (("cli_data1", ["--mesh-data", "1"]), ("cli_data4", ["--mesh-data", "4"])):
        try:
            cli.main(base + flags)
        except (NotImplementedError, ValueError) as exc:
            out[key] = (type(exc).__name__, str(exc))
    out["group_kept"] = torch.distributed.is_initialized()
    return out


_NO_GROUP = {"init_paths"}


# ------------------------------------------------------ spatial sharding

def _band(x, dim: int, rank: int, world: int) -> torch.Tensor:
    """Rows [rank h / world, (rank + 1) h / world) of ``x`` on ``dim``, a copy."""
    x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    rows = x.shape[dim] // world
    return x.narrow(dim, rank * rows, rows).clone()


def _spatial_ctx(world: int):
    from dsmnet_tpu_torch.parallel import ShardingContext, make_mesh

    mesh = make_mesh(data=1, model=world)
    return mesh, ShardingContext(mesh, "data", "model")


def halo_pads(rank, world, payload):
    """``halo_pad`` of this rank's band of each case's 5-D tensor (H on dim
    2) by its (above, below) rows on a (1, world) mesh, and the gradient of
    sum(out * g[rank]) with respect to the band (the adjoint)."""
    from dsmnet_tpu_torch.parallel import activate, halo_pad
    from dsmnet_tpu_torch.parallel import context

    _, ctx = _spatial_ctx(world)
    out = {}
    for case, p in payload.items():
        xl = _band(p["x"], 2, rank, world).requires_grad_(True)
        before = context.COLLECTIVES.get("halo_exchange", 0)
        with activate(ctx):
            y = halo_pad(xl, 2, *p["rows"])
        (y * torch.from_numpy(p["g"][rank])).sum().backward()
        out[case] = {"y": _np(y), "dx": _np(xl.grad),
                     "exchanges": context.COLLECTIVES["halo_exchange"] - before}
    return out


def banded_ops(rank, world, payload):
    """The banded ops on this rank's band on a (1, world) mesh, float64,
    each with the gradients of sum(out * g) (g's band): the 3-D convs on a
    band of H (dim 2), the fused stem and the concat volume inside a banded
    section of the features' H, the trilinear soft-argmin inside one of the
    coarse cost's H, the supervised loss (summed over the ranks: each
    rank's share) and D1/EPE inside one of the maps' H; the band rule's
    errors; ``replicate`` over the mesh."""
    from dsmnet_tpu_torch.losses import supervised_pyramid_loss
    from dsmnet_tpu_torch.models import create_model
    from dsmnet_tpu_torch.ops import concat_cost_volume, cost_volume_conv3x3
    from dsmnet_tpu_torch.ops import trilinear_soft_argmin
    from dsmnet_tpu_torch.parallel import (activate, banded, banded_conv3d_s2,
                                           banded_conv3d_same, banded_deconv3d_k3s2, replicate)
    from dsmnet_tpu_torch.train import create_train_state
    from dsmnet_tpu_torch.train.metrics import d1_epe

    mesh, ctx = _spatial_ctx(world)
    band = lambda x, dim: _band(x, dim, rank, world)
    t = lambda a: torch.from_numpy(a)
    ops = {"conv3d_same": banded_conv3d_same, "deconv3d_k3s2": banded_deconv3d_k3s2,
           "conv3d_s2": banded_conv3d_s2}
    out = {}
    with activate(ctx):
        for name, p in payload["convs"].items():
            xl = band(p["x"], 2).requires_grad_(True)
            k = t(p["k"]).clone().requires_grad_(True)
            y = ops[name](xl, k)
            (y * band(p["g"], 2)).sum().backward()
            out[name] = {"y": _np(y), "dx": _np(xl.grad), "dk": _np(k.grad)}
        for name, p in payload["volumes"].items():
            fL, fR = (band(p[key], 1).requires_grad_(True) for key in ("fL", "fR"))
            k = t(p["k"]).clone().requires_grad_(True) if "k" in p else None
            with banded(p["fL"].shape[1]):
                y = cost_volume_conv3x3(fL, fR, k, p["D"], p["mask_left"]) if k is not None \
                    else concat_cost_volume(fL, fR, p["D"], p["mask_left"])
            (y * band(p["g"], 2)).sum().backward()
            out[name] = {"y": _np(y), "dfL": _np(fL.grad), "dfR": _np(fR.grad),
                         "dk": None if k is None else _np(k.grad)}
        p = payload["regression"]
        cost = band(p["cost"], 2).requires_grad_(True)
        with banded(p["cost"].shape[2]):
            y = trilinear_soft_argmin(cost, p["out_dhw"], h_chunk=3)
        (y * band(p["g"], 1)).sum().backward()
        out["regression"] = {"y": _np(y), "dcost": _np(cost.grad)}
        p = payload["loss"]
        disp, gt = band(p["disp"], 1).requires_grad_(True), band(p["gt"], 1)
        with banded(p["gt"].shape[1]):
            loss = supervised_pyramid_loss(gt, [disp], [0], np.ones(1))
            d1, epe = d1_epe(disp.detach(), gt)
        loss.backward()
        out["loss"] = {"loss": _np(loss), "ddisp": _np(disp.grad), "d1_epe": (_np(d1), _np(epe))}
        out["rule"] = []
        for h, multiple in ((6, 4), (12, 4), (7, 1)):
            try:
                with banded(h, multiple):
                    out["rule"].append(None)
            except ValueError as exc:
                out["rule"].append(str(exc))
        # GCNet at 48 rows: 24 at 1/2, two bands of 12, not a multiple of 16
        img = torch.zeros(1, 48, 64, 3)
        try:
            with torch.no_grad():
                create_model("gcnet", 16).eval()(img, img)
            out["rule"].append(None)
        except ValueError as exc:
            out["rule"].append(str(exc))
    # every rank draws other weights; replicate gives every rank the mesh's
    # first rank's parameters, statistics and Adam state
    model = create_model("gcnet", 16).reset_parameters(torch.Generator().manual_seed(rank))
    state, opt = create_train_state(model, device="cpu")
    for q in model.parameters():
        q.grad = torch.full_like(q, float(rank + 1))
    opt.step()
    replicate(state, mesh)
    out["replicate"] = {"digest": {k: _digest(v) for k, v in model.state_dict().items()},
                        "adam": _digest(opt.state[next(model.parameters())]["exp_avg"])}
    # a host's share of the datasets follows its data coordinate: both
    # model ranks of the one data index read every sample
    from dsmnet_tpu_torch.data import SyntheticStereoDataset
    from dsmnet_tpu_torch.parallel import shard_dataset_for_host

    ds = SyntheticStereoDataset(n=6, hw=(4, 4))
    shard_dataset_for_host(ds, mesh)
    out["dataset_shard"] = (ds.index_offset, ds.index_stride, len(ds))
    return out


def _rank_batch_band(world: int):
    """The (world / 2, 2) mesh, its context with H over ``model``, and two
    functions: a global (N, H, ...) array's slice of this rank's data
    index, and that slice's band of rows of this rank's ``model``
    coordinate."""
    from dsmnet_tpu_torch.parallel import ShardingContext, make_mesh, shard_batch
    from dsmnet_tpu_torch.parallel.mesh import axis_index

    mesh = make_mesh(data=world // 2, model=2)
    m = axis_index(mesh, "model")
    data = lambda a: shard_batch(torch.from_numpy(a), mesh).clone()
    return (mesh, ShardingContext(mesh, "data", "model"), data,
            lambda a: _band(data(a), 1, m, 2))


def banded_photometric(rank, world, payload):
    """The self-supervised loss's ops, float64, on a (world / 2, 2) mesh:
    each data index holds its slice of the global batch, each ``model``
    rank its band of rows.  Inside a banded section of the maps' H:
    ``ssim_map``, the finite differences and smoothness terms (each with
    the gradient of sum(out * g) with respect to its banded operand),
    ``imwarp`` of a band of the crop from the whole source at origin
    (nedge, nedge + lo), and ``photometric_pyramid_loss`` of each loss
    name (this rank's share and its gradients with respect to both views'
    disparity bands); the warps taken by the horizontal fast path and by
    the generic one, and the collectives by site."""
    from dsmnet_tpu_torch.losses import parse_loss_name, photometric_pyramid_loss
    from dsmnet_tpu_torch.ops import gradients, ssim, warp
    from dsmnet_tpu_torch.parallel import activate, banded, context

    _, ctx, data, band = _rank_batch_band(world)
    paths = {"fast": 0, "generic": 0}
    for key, name in (("fast", "_bilinear_gather_zero_pad_h"),
                      ("generic", "_bilinear_gather_zero_pad")):
        def counted(*a, _f=getattr(warp, name), _k=key):
            paths[_k] += 1
            return _f(*a)
        setattr(warp, name, counted)
    out = {}
    before = dict(context.COLLECTIVES)
    with activate(ctx):
        a, b = (band(x) for x in payload["ssim"])
        with banded(payload["ssim"][0].shape[1]):
            out["ssim"] = _np(ssim.ssim_map(a, b))
        for name, p in payload["ops"].items():
            args = [band(x).requires_grad_(i == p["wrt"]) for i, x in enumerate(p["args"])]
            with banded(p["args"][0].shape[1]):
                y = getattr(gradients, name)(*args)
            (y * band(p["g"])).sum().backward()
            out[name] = {"y": _np(y), "grad": _np(args[p["wrt"]].grad)}
        s = payload["scene"]
        e, h = s["nedge"], s["imL"].shape[1]
        imR_src, imR1_src = data(s["imR_src"]), data(s["imR1_src"])
        imL, imL1 = band(s["imL"]), band(s["imL1"])
        with banded(h):
            lo = context.section_band()[0]
            out["lo"] = lo
            out["imwarp"] = _np(warp.imwarp(imR_src, band(s["dispL"]), False, (e, e + lo)))
            for name in payload["loss_names"]:
                dl, dl1 = band(s["dispL"]).requires_grad_(), band(s["dispL1"]).requires_grad_()
                loss = photometric_pyramid_loss(
                    parse_loss_name(name, 1, 10).photo, imR_src, imL, [dl], [0], (e, e + lo),
                    imR1_src, imL1, [dl1], [0], (e, e + lo), np.ones(1),
                    eps=torch.tensor(s["eps"], dtype=torch.float64))
                loss.backward()
                out[name] = {"loss": _np(loss), "dl": _np(dl.grad), "dl1": _np(dl1.grad)}
            try:
                photometric_pyramid_loss(parse_loss_name("depthmono", 2, 10).photo, imR_src,
                                         imL, [dl, dl], [0, 1], (e, e + lo), imR1_src, imL1,
                                         [dl1, dl1], [0, 1], (e, e + lo), np.ones(2))
                out["level1"] = None
            except NotImplementedError as exc:
                out["level1"] = str(exc)
    out["warp_paths"] = paths
    out["collectives"] = {k: v - before.get(k, 0) for k, v in context.COLLECTIVES.items()
                          if v != before.get(k, 0)}
    return out


def init_paths(rank, world, payload):
    """init_distributed from --coordinator-style arguments (host:port), then,
    after that group is gone, from torchrun's environment (env://)."""
    import torch.distributed as dist

    from dsmnet_tpu_torch.parallel import init_distributed

    out = {"none": init_distributed()}  # no coordinator, no environment: one process
    made = init_distributed(f"localhost:{payload['port']}", world, rank, backend="gloo",
                            timeout=GROUP_TIMEOUT)
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    out["coordinator"] = (made, dist.get_rank(), dist.get_world_size(), x.item())
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(payload["env_port"]))
    made = init_distributed(backend="gloo", timeout=GROUP_TIMEOUT)
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    out["env"] = (made, dist.get_rank(), dist.get_world_size(), x.item(),
                  dist.get_backend())
    return out


# --------------------------------------------------------- train steps

def _grads_params_buffers(model, rank: int) -> dict:
    """The gradients, parameters and buffers after a step: rank 0's arrays,
    and every rank's digests (the ranks must agree to the bit)."""
    state = {"grads": {k: p.grad for k, p in model.named_parameters()},
             "params": dict(model.named_parameters()), "buffers": dict(model.named_buffers())}
    out = {"digest": {kind: {k: _digest(v) for k, v in d.items()} for kind, d in state.items()}}
    if rank == 0:
        out.update({kind: {k: _np(v) for k, v in d.items()} for kind, d in state.items()})
    return out


def supervised_step(rank, world, payload):
    """One float64 supervised step of the port's model (with
    ``payload["kwargs"]``) on this rank's shard of the global batch, from
    the flax weights, under a (world, 1) mesh or the (data, model) of
    ``payload["mesh"]`` (H split over ``model``, the spatial axis); and the
    step's all-reduces and halo exchanges by site.  Given ``thin_batch``,
    a second step from the same weights on it (under ``"thin"``) and, with
    ``gcnet_lr``, the eval forward of a seeded ``GCNetLR`` of that
    maxdisparity on its pairs, each map's bands gathered (under ``"lr"``)."""
    from dsmnet_tpu_torch.parallel import ShardingContext, make_mesh
    from dsmnet_tpu_torch.parallel.mesh import axis_index

    data, model = payload.get("mesh", (world, 1))
    mesh = make_mesh(data=data, model=model)
    ctx = ShardingContext(mesh, "data", "model" if model > 1 else None)
    out = _supervised_step(rank, mesh, ctx, payload, payload["batch"])
    if "thin_batch" in payload:
        out["thin"] = _supervised_step(rank, mesh, ctx, payload, payload["thin_batch"])
    if "gcnet_lr" in payload:
        out["lr"] = _gcnet_lr_eval(mesh, ctx, payload["gcnet_lr"], payload["thin_batch"])
        out["data_index"] = axis_index(mesh, "data")
    return out


def _supervised_step(rank, mesh, ctx, payload, global_batch):
    from dsmnet_tpu_torch import interop
    from dsmnet_tpu_torch.models import create_model
    from dsmnet_tpu_torch.parallel import activate, context, replicate, shard_batch
    from dsmnet_tpu_torch.train import create_train_state, make_supervised_train_step

    tm = create_model(payload["net"], payload["maxdisp"], **payload.get("kwargs", {})).double()
    interop.load_flax_variables(tm, payload["params"], payload.get("batch_stats"))
    state, opt = create_train_state(tm, device="cpu")
    replicate(state, mesh)
    batch = shard_batch(global_batch, mesh)
    before = dict(context.COLLECTIVES)
    with activate(ctx):
        m = make_supervised_train_step(tm, opt)(state, batch, payload["lr"], payload["weights"])
    return {**{k: v.item() for k, v in m.items()}, **_grads_params_buffers(tm, rank),
            "step": state.step, "collectives": {
                k: v - before.get(k, 0) for k, v in context.COLLECTIVES.items()}}


def _gcnet_lr_eval(mesh, ctx, maxdisp: int, global_batch):
    """A seeded float64 ``GCNetLR``'s (dispL, dispR) of this data index's
    pairs, H banded over ``model``, the bands gathered."""
    from dsmnet_tpu_torch.models.gcnet import GCNetLR
    from dsmnet_tpu_torch.parallel import activate, banded, gather_band, shard_batch

    model = GCNetLR(maxdisp).reset_parameters(torch.Generator().manual_seed(0)).double().eval()
    batch = shard_batch(global_batch, mesh)
    with activate(ctx), torch.no_grad():
        maps = model(batch[..., :3], batch[..., 3:6])
        with banded(batch.shape[1]):
            return [_np(gather_band(d)) for d in maps]


def selfsup_step(rank, world, payload):
    """One float64 self-supervised step from the flax weights (or the
    seed-0 weights without ``params``) on this rank's shard, with its rows
    of the global batch's draws, under a (world, 1) mesh or the (data,
    model) of ``payload["mesh"]`` (H split over ``model``: a model that
    bands runs its loss on its band of the crop); given ``eval_batch``,
    first the eval step on it from the same weights (its disparity whole);
    and the step's collectives by site and the gradient bucket's group
    size."""
    import torch.distributed as dist

    from dsmnet_tpu_torch import interop
    from dsmnet_tpu_torch.losses import parse_loss_name
    from dsmnet_tpu_torch.models import create_model
    from dsmnet_tpu_torch.parallel import (ShardingContext, activate, context, make_mesh,
                                           shard_batch)
    from dsmnet_tpu_torch.parallel.mesh import axis_index
    from dsmnet_tpu_torch.train import (create_train_state, make_selfsup_eval_step,
                                        make_selfsup_train_step)

    tm = create_model(payload["net"], payload["maxdisp"])
    if "params" in payload:
        interop.load_flax_variables(tm.double(), payload["params"], payload.get("batch_stats"))
    else:  # the weights seeded by 0, as the caller's
        tm = tm.reset_parameters(torch.Generator().manual_seed(0)).double()
    spec = parse_loss_name(payload["loss_name"], tm.count_levels, 10)
    data, model = payload.get("mesh", (world, 1))
    mesh = make_mesh(data=data, model=model)
    state, opt = create_train_state(tm, device="cpu")
    batch = shard_batch(payload["batch"], mesh)
    n, index = batch.shape[0], axis_index(mesh, "data")
    draws = payload["draws"].rows(index * n, (index + 1) * n)
    out = {}
    with activate(ShardingContext(mesh, "data", "model" if model > 1 else None)):
        if "eval_batch" in payload:
            ev = make_selfsup_eval_step(tm, spec.photo)(
                state, shard_batch(payload["eval_batch"], mesh), payload["weights"])
            out["eval"] = {k: _np(v) for k, v in ev.items()}
        before = dict(context.COLLECTIVES)
        m = make_selfsup_train_step(tm, opt, spec.photo, payload["nedge"])(
            state, batch, payload["lr"], payload["weights"], draws)
        out["grad_group_size"] = dist.get_world_size(context.gradient_group(tm))
    out["collectives"] = {k: v - before.get(k, 0) for k, v in context.COLLECTIVES.items()
                          if v != before.get(k, 0)}
    return {**out, **{k: v.item() for k, v in m.items()}, **_grads_params_buffers(tm, rank)}


def trainer(rank, world, payload):
    """The port's Trainer through ``payload["cfg"]`` on a (world, 1) mesh or
    the (data, model) of ``payload["mesh"]``, with loaders cut into the
    data indices' slices (of [0, 1] images with ``selfsup``; validation at
    ``val_hw`` if given): its history, weights and files, and the size of
    the group its gradient bucket sums over; then, given
    ``payload["resume_cfg"]``, what a Trainer of it resumes from."""
    import torch.distributed as dist

    from dsmnet_tpu_torch.data import (BatchLoader, SyntheticStereoDataset, eval_transform,
                                       selfsup_eval_transform)
    from dsmnet_tpu_torch.parallel import activate, make_mesh
    from dsmnet_tpu_torch.parallel import context
    from dsmnet_tpu_torch.parallel.mesh import axis_index
    from dsmnet_tpu_torch.train import TrainConfig, Trainer

    data, model = payload.get("mesh", (world, 1))
    mesh = make_mesh(data=data, model=model)
    transform = selfsup_eval_transform() if payload.get("selfsup") else eval_transform()

    def loader(shuffle):
        hw = payload["hw"] if shuffle else payload.get("val_hw", payload["hw"])
        ds = SyntheticStereoDataset(n=payload["n"], hw=hw, max_disp=16, transform=transform)
        return BatchLoader(ds, batch_size=payload["batch"], shuffle=shuffle, num_workers=1,
                           seed=0, rank_slice=(axis_index(mesh, "data"), data))

    t = Trainer(TrainConfig(**payload["cfg"], device="cpu"), loader_train=loader(True),
                loader_val=loader(False), mesh=mesh)
    out = {"epoch0": t.epoch, "step0": t.state.step}
    out["hist"] = t.start()
    state = t.model.state_dict()
    out["digest"] = {k: _digest(v) for k, v in state.items()}
    if rank == 0:
        out["state"] = {k: _np(v) for k, v in state.items()}
    out["step"] = t.state.step
    out["files"] = sorted(os.listdir(t.dirpath))
    with activate(t._sharding_ctx):
        out["grad_group_size"] = dist.get_world_size(context.gradient_group(t.model))
        out["spatial_axis"] = context.current().spatial_axis
    if "resume_cfg" not in payload:
        return out
    # a resumed Trainer on every rank, from what rank 0 wrote: the state this
    # rank ended with, Adam's moments included
    t2 = Trainer(TrainConfig(**payload["resume_cfg"], device="cpu"), loader_train=loader(True),
                 loader_val=loader(False), mesh=mesh)
    moments = lambda tr: [tr.state.opt.state[p][k] for p in tr.model.parameters()
                          for k in ("exp_avg", "exp_avg_sq")]
    out["resumed"] = {
        "epoch0": t2.epoch, "step0": t2.state.step,
        "same_state": all(torch.equal(v, state[k]) for k, v in t2.model.state_dict().items()),
        "same_moments": all(torch.equal(a, b) for a, b in zip(moments(t2), moments(t))),
        "moments_nonzero": bool(moments(t2)[0].abs().max() > 0)}
    return out
