"""Command-line entry point of the port (``dsmnet_tpu/cli.py``; reference
main.py:14-50 + deploy/deploy.py).

Modes: train / finetune / test / submit / deploy, with the JAX flags and
``--device`` (default CUDA, under a process group the rank's
``cuda:LOCAL_RANK``; without a card every mode raises).  Dataset
and loss selection use the reference's string DSLs
('kitti2015-tr_kitti2012-tr' concatenates datasets; 'supervised', or a
photometric loss such as 'Cap_ds-mask', which trains self-supervised);
``--dataset synthetic`` trains on the procedural dataset,
whose 384x768 samples need ``--shift_max 0`` at a 768-wide crop and a
batch above 1 (a shifted sample is narrower than the crop, and a batch
of mixed widths raises).  ``--path_weight`` takes the port's ``.pt``, an
``.npz`` of flax paths or a JAX ``.msgpack``.

Parallel runs: one process per card, each a rank of a ``(data, model)``
mesh (``parallel.make_mesh``), launched by torchrun on one host, or with
``--multihost`` by hand on each host.  ``--mesh-data`` is the data axis (0:
every rank the model axis leaves), ``--mesh-model`` the spatial axis, and
the mesh must cover every rank.  Above 1, ``--mesh-model`` splits H over
its ranks: PSMNet and GCNet run their 2-D tower on the whole images and
the cost volume, the 3-D part, the regression and the loss on a band of
rows per rank, exchanging halo rows; a band must be a whole multiple of
4 rows at 1/4 resolution (PSMNet) or of 16 at 1/2 (GCNet), else it
raises ``ValueError``; the other models run whole on every model rank.
A photometric ``--loss_name`` runs its two forwards' towers on the whole
crops and its loss on each rank's band of the crop's rows.  The ranks
of one data index read the same samples.  Without ``--multihost``
``--batchsize`` is the global batch, which every data index cuts from
the same seeded order, decoding only its slice; with it every rank reads
its data index's share of the datasets (strided) and ``--batchsize`` is
its own batch, so the global batch is ``--mesh-data`` times it.  The
files (checkpoints, history, curves, submit's) are written by rank 0.

Usage:
    python -m dsmnet_tpu_torch.cli --mode train --net psmnet --dataset synthetic \
        --batchsize 4 --shift_max 0 --dtype bfloat16 --lr 1e-3 --epochs 2
    torchrun --nproc_per_node 4 -m dsmnet_tpu_torch.cli --mode train --net psmnet \
        --dataset synthetic --batchsize 16 --shift_max 0 --dtype bfloat16 --mesh-data 4
    torchrun --nproc_per_node 2 -m dsmnet_tpu_torch.cli --mode train --net psmnet \
        --dataset synthetic --batchsize 4 --shift_max 0 --dtype bfloat16 --mesh-model 2
    torchrun --nproc_per_node 2 -m dsmnet_tpu_torch.cli --mode train --net psmnet \
        --loss_name depthmono-mask --dataset synthetic --batchsize 4 --shift_max 0 \
        --dtype bfloat16 --lr 1e-4 --mesh-model 2
    python -m dsmnet_tpu_torch.cli --mode train ... --multihost --coordinator host0:29500 \
        --num_processes 2 --process_id 0      # and --process_id 1 on the other host
    python -m dsmnet_tpu_torch.cli --mode train --net dispnetcorr --dataset synthetic \
        --loss_name Cap_ds-mask --batchsize 4 --shift_max 0 --dtype bfloat16 --epochs 2
    python -m dsmnet_tpu_torch.cli --mode deploy --net gcnet \
        --maxdisparity 192 --path_left 10L.png --path_right 10R.png \
        [--path_weight w.pt] [--device cuda|cpu] [--dtype float32|bfloat16]

``main`` returns the deploy's disparity, or (trainer, result) for the other
modes: the loss history (train, finetune), the validation's (loss, epe,
d1) (test) or the submission's results (submit).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch
import torch.distributed as dist


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch/CUDA deep stereo matching")
    p.add_argument("--mode", default="train",
                   choices=["train", "finetune", "test", "submit", "deploy"])
    p.add_argument("--epochs", default=150, type=int)
    p.add_argument("--dataset", default="kitti2015-tr", type=str,
                   help="'_'-joined dataset names, or 'synthetic'")
    p.add_argument("--root", default="./kitti", type=str)
    p.add_argument("--dataset_val", default="kitti2015-tr", type=str)
    p.add_argument("--root_val", default="", type=str)
    p.add_argument("--val_freq", default=1, type=int)
    p.add_argument("--print_freq", default=20, type=int)
    p.add_argument("--batchsize", default=1, type=int)
    p.add_argument("--loss_name", default="supervised", type=str,
                   help="supervised/(depthmono/SsSMnet/Cap_ds_lr)[-mask]")
    p.add_argument("--net", default="dispnet", type=str,
                   help="psmnet/psmnet_basic/gcnet/dispnet/dispnetcorr/iresnet")
    p.add_argument("--maxdisparity", default=192, type=int)
    p.add_argument("--path_weight", default="", type=str,
                   help="weights: the port's '.pt', an '.npz' of '/'-joined flax paths, "
                        "or a JAX '.msgpack'")
    p.add_argument("--flag_model", default="", type=str)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--beta1", default=0.9, type=float)
    p.add_argument("--beta2", default=0.999, type=float)
    p.add_argument("--lr_epoch0", default=50, type=int)
    p.add_argument("--lr_stride", default=20, type=int)
    p.add_argument("--output", default="output", type=str)
    p.add_argument("--seed", default=0, type=int, help="weight seed when no --path_weight")
    p.add_argument("--crop_w", default=768, type=int)
    p.add_argument("--crop_h", default=384, type=int)
    p.add_argument("--shift_max", default=32, type=int)
    p.add_argument("--scale_delt", default=0.0, type=float)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--plot_curves", action="store_true")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of the convolutions; float32 as the JAX CLI")
    p.add_argument("--profile_dir", default="", type=str,
                   help="write a torch.profiler trace of train steps 10-15 here")
    p.add_argument("--remat", action="store_true",
                   help="recompute heavy blocks in the backward (FLOPs for memory)")
    p.add_argument("--device", default=None, type=str,
                   help="default: cuda (under a process group cuda:LOCAL_RANK)")
    # data parallelism over processes, one card each
    p.add_argument("--mesh-data", default=0, type=int,
                   help="data-parallel mesh size (0 = every rank); the mesh must cover "
                        "every rank")
    p.add_argument("--mesh-model", default=1, type=int,
                   help="spatial/model mesh size: above 1, PSMNet and GCNet split H into "
                        "one band of rows per rank (supervised losses)")
    p.add_argument("--multihost", action="store_true",
                   help="make the process group from --coordinator (else torchrun's "
                        "environment); shard the datasets per rank, --batchsize per rank")
    p.add_argument("--coordinator", default="", type=str,
                   help="multihost: rank 0's address host:port (empty = torchrun's "
                        "environment)")
    p.add_argument("--num_processes", default=0, type=int,
                   help="multihost: the number of ranks")
    p.add_argument("--process_id", default=-1, type=int, help="multihost: this rank")
    # deploy
    p.add_argument("--path_left", default="10L.png", type=str)
    p.add_argument("--path_right", default="10R.png", type=str)
    p.add_argument("--flip", action="store_true",
                   help="deploy: predict the right view's disparity (mirrored pair)")
    return p


def _make_loaders(args, spec, rank_slice=None):
    """(train loader or None, validation loader) for ``args.mode``
    (``dsmnet_tpu/cli.py:85-126``); ``rank_slice`` (index, count) cuts each
    train and validation batch into the ranks' slices."""
    from .data import (
        BatchLoader,
        SyntheticStereoDataset,
        dataset_by_name,
        eval_transform,
        selfsup_eval_transform,
        selfsup_train_transform,
        supervised_train_transform,
    )

    size_crop = (args.crop_w, args.crop_h)
    root_val = args.root_val or args.root
    supervised = spec.supervised

    if args.mode in ("test", "submit"):
        tf = eval_transform() if supervised else selfsup_eval_transform()
        if args.dataset == "synthetic":
            ds = SyntheticStereoDataset(n=16, transform=tf)
        else:
            ds = dataset_by_name(args.dataset, args.root, tf, train=False)
        return None, BatchLoader(ds, args.batchsize, shuffle=False,
                                 num_workers=args.num_workers, rank_slice=rank_slice)

    if supervised:
        tf_train = supervised_train_transform(size_crop, args.scale_delt, args.shift_max)
        tf_val = eval_transform()
    else:
        tf_train = selfsup_train_transform(size_crop, args.scale_delt, args.shift_max)
        tf_val = selfsup_eval_transform()

    if args.dataset == "synthetic":
        ds_train = SyntheticStereoDataset(n=64, transform=tf_train)
        ds_val = SyntheticStereoDataset(n=8, transform=tf_val, seed=1)
    else:
        ds_train = dataset_by_name(args.dataset, args.root, tf_train, train=True)
        ds_val = dataset_by_name(args.dataset_val, root_val, tf_val, train=False)
    loader_train = BatchLoader(ds_train, args.batchsize, shuffle=True,
                               num_workers=args.num_workers, seed=args.seed,
                               rank_slice=rank_slice)
    loader_val = BatchLoader(ds_val, args.batchsize, shuffle=False,
                             num_workers=args.num_workers, rank_slice=rank_slice)
    return loader_train, loader_val


def deploy(args) -> np.ndarray:
    """Single-pair inference (deploy/deploy.py:15-68): ``dispL.png``
    (``dispR.png`` with ``--flip``) in the current directory."""
    from .images import imread, write_png
    from .serve import Predictor

    predictor = Predictor(net=args.net, maxdisparity=args.maxdisparity,
                          weights=args.path_weight or None, seed=args.seed,
                          device=args.device, dtype=getattr(torch, args.dtype))
    imgL = np.float32(imread(args.path_left)) / 255.0
    imgR = np.float32(imread(args.path_right)) / 255.0
    if args.flip:
        imgL, imgR = np.flip(imgR, 1).copy(), np.flip(imgL, 1).copy()
    disp = predictor.predict(imgL, imgR)[0]
    name = "dispR.png" if args.flip else "dispL.png"
    write_png(name, np.flip(disp, axis=-1) if args.flip else disp)
    print(f"wrote {name}  min={disp.min():.2f} max={disp.max():.2f}")
    return disp


def _make_mesh(args):
    """The (data, model) mesh over the ranks of the process group, or None
    for a single process.  A mesh that does not cover every rank raises
    ``ValueError`` (a rank outside it would train alone on the same files:
    JAX leaves spare devices idle)."""
    from .parallel import make_mesh

    if dist.is_available() and dist.is_initialized():
        return make_mesh(data=args.mesh_data or None, model=args.mesh_model)
    for flag, n in (("--mesh-data", args.mesh_data), ("--mesh-model", args.mesh_model)):
        if n > 1:
            raise ValueError(f"{flag} {n} exceeds the one rank of a single process: launch "
                             "the ranks with torchrun or --multihost")
    return None


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO, format=" %(asctime)s - %(levelname)s - %(message)s"
    )
    args = build_parser().parse_args(argv)
    from .parallel import init_distributed

    had_group = dist.is_available() and dist.is_initialized()
    if args.multihost:
        init_distributed(coordinator_address=args.coordinator or None,
                         num_processes=args.num_processes or None,
                         process_id=args.process_id if args.process_id >= 0 else None)
    else:
        init_distributed()  # torchrun's environment, or a single process: no group
    try:
        return _run(args)
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args):
    if args.mode == "deploy":
        return deploy(args)

    from .config import resolve_device
    from .losses import parse_loss_name
    from .models import create_model
    from .parallel import shard_dataset_for_host
    from .parallel.mesh import axis_index, axis_size
    from .train import TrainConfig, Trainer

    resolve_device(args.device)  # no card: raise before building any loader
    mesh = _make_mesh(args)
    spec = parse_loss_name(args.loss_name, create_model(args.net, args.maxdisparity).count_levels)
    # every rank evaluates submit's batches whole; otherwise, without
    # --multihost, each cuts its slice of every global batch, and with it
    # each reads its own share of the datasets
    rank_slice = None
    if mesh is not None and not args.multihost and args.mode != "submit":
        rank_slice = (axis_index(mesh, "data"), axis_size(mesh, "data"))
    loader_train, loader_val = _make_loaders(args, spec, rank_slice)
    if mesh is not None and args.multihost and args.mode != "submit":
        for loader in (loader_train, loader_val):
            if loader is not None:
                shard_dataset_for_host(loader.dataset, mesh)
    cfg = TrainConfig(
        mode=args.mode, epochs=args.epochs, net=args.net,
        maxdisparity=args.maxdisparity, loss_name=args.loss_name, lr=args.lr,
        beta1=args.beta1, beta2=args.beta2, lr_epoch0=args.lr_epoch0,
        lr_stride=args.lr_stride, val_freq=args.val_freq,
        print_freq=args.print_freq, batchsize=args.batchsize,
        output=args.output, dataset=args.dataset, dataset_val=args.dataset_val,
        path_weight=args.path_weight, flag_model=args.flag_model,
        seed=args.seed, plot_curves=args.plot_curves, dtype=args.dtype,
        profile_dir=args.profile_dir, remat=args.remat, device=args.device,
        multihost=args.multihost and mesh is not None,
    )
    trainer = Trainer(cfg, loader_train=loader_train, loader_val=loader_val, mesh=mesh)
    result = trainer.submit() if args.mode == "submit" else trainer.start()
    return trainer, result


if __name__ == "__main__":
    main()
