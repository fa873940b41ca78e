"""Command-line entry point of the port (``dsmnet_tpu/cli.py``; reference
main.py:14-50 + deploy/deploy.py).

Modes: train / finetune / test / submit / deploy, with the JAX flags
except the mesh and multihost ones (ROADMAP.md queue 1, "Parallel"), and
``--device`` (default CUDA; without a card every mode raises).  Dataset
and loss selection use the reference's string DSLs
('kitti2015-tr_kitti2012-tr' concatenates datasets; 'supervised', or a
photometric loss such as 'Cap_ds-mask', which trains self-supervised);
``--dataset synthetic`` trains on the procedural dataset,
whose 384x768 samples need ``--shift_max 0`` at a 768-wide crop and a
batch above 1 (a shifted sample is narrower than the crop, and a batch
of mixed widths raises).  ``--path_weight`` takes the port's ``.pt``, an
``.npz`` of flax paths or a JAX ``.msgpack``.

Usage:
    python -m dsmnet_tpu_torch.cli --mode train --net psmnet --dataset synthetic \
        --batchsize 4 --shift_max 0 --dtype bfloat16 --lr 1e-3 --epochs 2
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
    p.add_argument("--device", default=None, type=str, help="default: cuda")
    # deploy
    p.add_argument("--path_left", default="10L.png", type=str)
    p.add_argument("--path_right", default="10R.png", type=str)
    p.add_argument("--flip", action="store_true",
                   help="deploy: predict the right view's disparity (mirrored pair)")
    return p


def _make_loaders(args, spec):
    """(train loader or None, validation loader) for ``args.mode``
    (``dsmnet_tpu/cli.py:85-126``)."""
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
                                 num_workers=args.num_workers)

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
                               num_workers=args.num_workers, seed=args.seed)
    loader_val = BatchLoader(ds_val, args.batchsize, shuffle=False,
                             num_workers=args.num_workers)
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


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO, format=" %(asctime)s - %(levelname)s - %(message)s"
    )
    args = build_parser().parse_args(argv)
    if args.mode == "deploy":
        return deploy(args)

    from .config import resolve_device
    from .losses import parse_loss_name
    from .models import create_model
    from .train import TrainConfig, Trainer

    resolve_device(args.device)  # no card: raise before building any loader
    spec = parse_loss_name(args.loss_name, create_model(args.net, args.maxdisparity).count_levels)
    loader_train, loader_val = _make_loaders(args, spec)
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
    )
    trainer = Trainer(cfg, loader_train=loader_train, loader_val=loader_val)
    result = trainer.submit() if args.mode == "submit" else trainer.start()
    return trainer, result


if __name__ == "__main__":
    main()
