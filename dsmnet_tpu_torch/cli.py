"""Command-line entry point of the port.

Only ``--mode deploy`` is ported (the JAX package's ``dsmnet_tpu/cli.py``
deploy mode): one stereo pair in, ``dispL.png`` (``dispR.png`` with
``--flip``) out, written to the current directory.  ``--net`` is any
ported model: psmnet, psmnet_basic, gcnet, dispnet, dispnetcorr,
iresnet.

Usage:
    python -m dsmnet_tpu_torch.cli --mode deploy --net gcnet \
        --maxdisparity 192 --path_left 10L.png --path_right 10R.png \
        [--path_weight w.npz] [--device cuda|cpu] [--dtype float32|bfloat16]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PyTorch/CUDA deep stereo matching (serving)")
    p.add_argument("--mode", default="deploy", choices=["deploy"])
    p.add_argument("--net", default="psmnet", type=str)
    p.add_argument("--maxdisparity", default=192, type=int)
    p.add_argument("--path_weight", default="", type=str,
                   help="'.npz' of '/'-joined flax paths (params/..., batch_stats/...)")
    p.add_argument("--path_left", default="10L.png", type=str)
    p.add_argument("--path_right", default="10R.png", type=str)
    p.add_argument("--flip", action="store_true",
                   help="predict the right view's disparity (mirrored pair)")
    p.add_argument("--seed", default=0, type=int, help="weight seed when no --path_weight")
    p.add_argument("--device", default=None, type=str, help="default: cuda")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="conv compute dtype; float32 as the JAX deploy computes")
    return p


def deploy(args) -> np.ndarray:
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


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    deploy(args)


if __name__ == "__main__":
    main()
