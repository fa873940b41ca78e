"""Serving path of the PyTorch port on the CPU: Predictor and the deploy CLI.

Seeded weights, maxdisparity 16, a 256x256 pair (whose 1/4-scale features
fit every SPP pool of PSMNet, 64x64 the largest).  The answer must be a
finite (1, H, W) disparity inside the clamp range [1e-6, maxdisparity].
"""

import cv2
import numpy as np
import pytest
import torch

from dsmnet_tpu_torch import cli
from dsmnet_tpu_torch.serve import Predictor

MAXDISP, H, W = 16, 256, 256


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(rng):
    return rng.rand(H, W, 3).astype(np.float32), rng.rand(H, W, 3).astype(np.float32)


def _check_disparity(disp, shape):
    assert disp.shape == shape and disp.dtype == np.float32
    assert np.isfinite(disp).all()
    assert disp.min() >= np.float32(1e-6) and disp.max() <= MAXDISP


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_predictor_answers_request(dtype, rng):
    server = Predictor(maxdisparity=MAXDISP, device="cpu", dtype=dtype)
    assert not server.model.training
    imL, imR = _pair(rng)
    disp = server.predict(imL, imR)
    _check_disparity(disp, (1, H, W))
    # a second request on the same server gives the same answer
    np.testing.assert_array_equal(server.predict(imL, imR), disp)


def test_predictor_loads_npz_weights(tmp_path):
    """--path_weight: an .npz of '/'-joined flax paths replaces the seeded
    weights and BN statistics, leaf for leaf."""
    src = Predictor(maxdisparity=MAXDISP, seed=1, device="cpu").model
    with torch.no_grad():
        for name, buf in src.named_buffers():
            buf.copy_(torch.rand(buf.shape) + 0.5)
    path = tmp_path / "w.npz"
    arrays = {f"{root}/" + k.replace(".", "/"): v.detach().numpy()
              for root, named in (("params", src.named_parameters()),
                                  ("batch_stats", src.named_buffers()))
              for k, v in named}
    np.savez(path, **arrays)
    server = Predictor(maxdisparity=MAXDISP, seed=0, weights=str(path), device="cpu")
    got = {**dict(server.model.named_parameters()), **dict(server.model.named_buffers())}
    want = {**dict(src.named_parameters()), **dict(src.named_buffers())}
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


def test_cli_deploy_writes_disparity_png(rng, tmp_path, monkeypatch):
    imL, imR = _pair(rng)
    for name, im in (("L.png", imL), ("R.png", imR)):
        cv2.imwrite(str(tmp_path / name), np.uint8(im[..., ::-1] * 255))
    monkeypatch.chdir(tmp_path)
    disp = cli.deploy(cli.build_parser().parse_args(
        ["--mode", "deploy", "--net", "psmnet", "--maxdisparity", str(MAXDISP),
         "--path_left", "L.png", "--path_right", "R.png", "--device", "cpu"]))
    _check_disparity(disp, (H, W))
    png = cv2.imread(str(tmp_path / "dispL.png"), cv2.IMREAD_UNCHANGED)
    assert png is not None and png.shape == (H, W, 4) and png.dtype == np.uint8


@pytest.mark.parametrize("flip", [False, True], ids=["left", "flip"])
def test_cli_deploy_png_is_plt_imsave(flip, rng, tmp_path, monkeypatch):
    """The deploy PNG holds the pixels the JAX deploy's ``plt.imsave`` writes
    for the same disparity (``dsmnet_tpu/cli.py:166-171``): matplotlib's
    default colormap over min..max, RGBA, the right view's map mirrored."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, w = 64, 128
    for name in ("L.png", "R.png"):
        cv2.imwrite(str(tmp_path / name), np.uint8(rng.rand(h, w, 3) * 255))
    monkeypatch.chdir(tmp_path)
    disp = cli.deploy(cli.build_parser().parse_args(
        ["--mode", "deploy", "--net", "dispnetcorr", "--maxdisparity", str(MAXDISP),
         "--path_left", "L.png", "--path_right", "R.png", "--device", "cpu"]
        + (["--flip"] if flip else [])))
    name = "dispR.png" if flip else "dispL.png"
    plt.imsave("ref.png", np.flip(disp, axis=-1) if flip else disp)
    got, ref = (cv2.imread(str(tmp_path / f), cv2.IMREAD_UNCHANGED) for f in (name, "ref.png"))
    assert got.shape == ref.shape == (h, w, 4) and got.dtype == ref.dtype == np.uint8
    assert len(np.unique(ref.reshape(-1, 4), axis=0)) > 16  # a map, not a flat image
    np.testing.assert_array_equal(got, ref)
