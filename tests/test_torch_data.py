"""The port's data pipeline (``dsmnet_tpu_torch.data``) against the JAX
package's (``dsmnet_tpu.data``), on the same seeds and on files the tests
write (as ``tests/test_data.py`` does).

  * Transforms on the same ``RandomState``: bit-exact, except the
    crop-and-scale resize (cv2 ``INTER_LINEAR`` in JAX, torch ``bilinear``
    here), held to 1e-4 x 255 in image units (float32 weights of both
    libraries: measured ~1e-5).
  * ``SyntheticStereoDataset``: the texture (cv2 ``INTER_CUBIC`` in JAX,
    torch ``bicubic`` here) to 1e-4 x 255, the disparity exactly.
  * ``BatchLoader``: order, per-epoch shuffle, the same batches whatever
    the worker count, the JAX loader's batches, errors raised, and no
    worker thread left when an epoch ends or is closed early.
  * PFM and PNG I/O, ``load_disp(precise=)``, the 16-bit PNG writer, and
    ``paths_for_dataset`` / ``check_dataset`` / ``dataset_by_name`` on a
    small KITTI 2015 tree.
"""

import dataclasses
import os
import threading

import cv2
import numpy as np
import pytest
import torch

from dsmnet_tpu import data as j_data
from dsmnet_tpu.data import transforms as j_tf
from dsmnet_tpu_torch import data as t_data
from dsmnet_tpu_torch.data import transforms as t_tf
from dsmnet_tpu_torch.images import read_png16, write_png16

IMAGE_TOL = 1e-4 * 255  # the resizes, in image units ([0, 255])


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _sample(rng, h=40, w=60, c=7):
    img = rng.rand(h, w, c).astype(np.float32) * 255
    img[..., 6:] = rng.rand(h, w, c - 6) * 30 + 1
    img[:5, :5, 6:] = 0  # invalid disparities stay 0 under the shift
    return img


# name -> (factory(module, rng) -> transform, sample channels)
TRANSFORMS = {
    "spatial_shift_crop": (lambda m, r: m.SpatialStereo((48, 32), 0.0, 16, r), 8),
    "spatial_crop_only": (lambda m, r: m.SpatialStereo((48, 32), 0.0, 0, r), 7),
    "supervised_train": (lambda m, r: m.supervised_train_transform((48, 32), 0.0, 16, r), 7),
    "selfsup_train": (lambda m, r: m.selfsup_train_transform((48, 32), 0.0, 16, r), 6),
    "eval": (lambda m, r: m.eval_transform(), 7),
    "selfsup_eval": (lambda m, r: m.selfsup_eval_transform(), 7),
    "lighting": (lambda m, r: lambda x: m.lighting_np(m.to_unit(x), 0.1, 2, r), 7),
    "normalize": (lambda m, r: lambda x: m.normalize_np(m.to_unit(x), 2), 7),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax_exactly(name, rng):
    make, c = TRANSFORMS[name]
    img = _sample(rng, c=c)
    for seed in range(3):
        want = make(j_tf, np.random.RandomState(seed))(img.copy())
        got = make(t_tf, np.random.RandomState(seed))(img.copy())
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale_delt,shift", [(0.5, 0), (0.3, 12)])
def test_crop_scale_matches_cv2_resize(scale_delt, shift, rng):
    """The random draws are the same; the bilinear resize agrees with cv2's
    to IMAGE_TOL (the disparity channel is scaled after it, so its
    tolerance is IMAGE_TOL x the scale)."""
    img = _sample(rng, 100, 200, 8)
    for seed in range(4):
        want = j_tf.SpatialStereo((96, 48), scale_delt, shift, np.random.RandomState(seed))(img)
        got = t_tf.SpatialStereo((96, 48), scale_delt, shift, np.random.RandomState(seed))(img)
        assert got.shape == want.shape == (48, 96, 8)
        np.testing.assert_allclose(got[..., :6], want[..., :6], rtol=0, atol=IMAGE_TOL)
        np.testing.assert_allclose(got[..., 6:], want[..., 6:], rtol=0, atol=IMAGE_TOL * 2)


@pytest.mark.parametrize("hw,seed,tex_scale",
                         [((32, 48), 0, 4), ((37, 70), 3, 6), ((384, 768), 0, 4)])
def test_synthetic_dataset_matches_jax(hw, seed, tex_scale):
    kw = dict(n=3, hw=hw, max_disp=24, seed=seed, tex_scale=tex_scale)
    want_ds, got_ds = j_data.SyntheticStereoDataset(**kw), t_data.SyntheticStereoDataset(**kw)
    for i in (0, 2):
        (want, want_name), (got, got_name) = want_ds[i], got_ds[i]
        assert got_name == want_name and got.shape == want.shape == (*hw, 7)
        np.testing.assert_allclose(got[..., :6], want[..., :6], rtol=0, atol=IMAGE_TOL)
        np.testing.assert_array_equal(got[..., 6], want[..., 6])


def _names(loader):
    return [n for _, names in loader for n in names]


def test_batch_loader_order_shuffle_and_workers():
    ds = t_data.SyntheticStereoDataset(n=11, hw=(16, 24), max_disp=4)
    plain = t_data.BatchLoader(ds, batch_size=3, num_workers=1)
    batches = list(plain)
    assert [b.shape for b, _ in batches] == [(3, 16, 24, 7)] * 3 + [(2, 16, 24, 7)]
    assert _names(plain) == [f"synthetic_{i:06d}.png" for i in range(11)]
    assert len(plain) == 4 and len(t_data.BatchLoader(ds, 3, drop_last=True)) == 3

    # per-epoch shuffle, the same batches for any worker count, and the JAX
    # loader's order and contents
    def epochs(module, nw):
        loader = module.BatchLoader(ds, batch_size=3, shuffle=True, num_workers=nw, seed=7)
        return [list(loader) for _ in range(2)]

    ref = epochs(j_data, 1)
    assert [n for _, ns in ref[0] for n in ns] != [n for _, ns in ref[1] for n in ns]
    for nw in (1, 2, 4):
        for got_epoch, want_epoch in zip(epochs(t_data, nw), ref):
            assert len(got_epoch) == len(want_epoch)
            for (a, an), (b, bn) in zip(got_epoch, want_epoch):
                assert an == bn
                np.testing.assert_array_equal(a, b)
    assert not [t for t in threading.enumerate() if t.name.startswith("BatchLoader")]


class _Bad:
    """Sample ``wide`` is one column wider than the others; sample 5 raises."""

    def __init__(self, wide):
        self.wide = wide

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise RuntimeError("decode boom")
        return np.zeros((4, 4 + (i == self.wide), 3), np.float32), f"s{i}"


@pytest.mark.parametrize("wide,workers,error,match", [
    (1, 1, ValueError, "heterogeneous"), (3, 3, ValueError, "heterogeneous"),
    (-1, 3, RuntimeError, "decode boom")])
def test_batch_loader_raises_worker_errors(wide, workers, error, match):
    with pytest.raises(error, match=match):
        list(t_data.BatchLoader(_Bad(wide), batch_size=2, num_workers=workers))
    assert not [t for t in threading.enumerate() if t.name.startswith("BatchLoader")]


def test_batch_loader_closed_early_ends_its_workers():
    ds = t_data.SyntheticStereoDataset(n=12, hw=(16, 24), max_disp=4)
    it = iter(t_data.BatchLoader(ds, batch_size=1, num_workers=3, prefetch=1))
    next(it)
    it.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("BatchLoader")]


def test_pfm_png_io_and_load_disp(tmp_path, rng):
    for shape in ((12, 17), (8, 9, 3)):
        img = (rng.rand(*shape) * 100).astype(np.float32)
        p = str(tmp_path / "x.pfm")
        t_data.save_pfm(p, img)
        np.testing.assert_array_equal(t_data.load_pfm(p)[0], j_data.load_pfm(p)[0])
        np.testing.assert_array_equal(t_data.load_pfm(p)[0], img)
    inf = np.full((4, 5), np.inf, np.float32)
    inf[0, 0] = 3.0
    t_data.save_pfm(str(tmp_path / "d.pfm"), inf)
    np.testing.assert_array_equal(t_data.load_disp(str(tmp_path / "d.pfm")),
                                  j_data.load_disp(str(tmp_path / "d.pfm")))
    # a KITTI 16-bit disparity PNG: the reference's 8-bit read and the precise one
    raw = (rng.rand(6, 9) * 60000).astype(np.uint16)
    for name, write in (("cv.png", lambda p, a: cv2.imwrite(p, a)), ("own.png", write_png16)):
        p = str(tmp_path / name)
        write(p, raw)
        for precise in (False, True):
            np.testing.assert_array_equal(t_data.load_disp(p, precise=precise),
                                          j_data.load_disp(p, precise=precise))
        np.testing.assert_array_equal(t_data.load_disp(p, precise=True), raw / np.float32(256))
    assert (read_png16(str(tmp_path / "own.png")) == raw).all()
    # an RGB image through imwrite / imread
    rgb = (rng.rand(5, 7, 3) * 255).astype(np.uint8)
    t_data.imwrite(str(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(t_data.imread(str(tmp_path / "rgb.png")), rgb)
    np.testing.assert_array_equal(j_data.imread(str(tmp_path / "rgb.png")), rgb)


def _make_kitti2015(tmp_path, n=3):
    root = str(tmp_path / "kitti")
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, "data_scene_flow/training", sub))
    rng = np.random.RandomState(0)
    for i in range(n):
        name = f"{i:06d}_10.png"
        for sub in ("image_2", "image_3"):
            cv2.imwrite(os.path.join(root, "data_scene_flow/training", sub, name),
                        (rng.rand(60, 80, 3) * 255).astype(np.uint8))
        disp = (rng.rand(60, 80) * 20 * 256).astype(np.uint16)
        cv2.imwrite(os.path.join(root, "data_scene_flow/training/disp_occ_0", name), disp)
    return root


def test_paths_check_and_dataset_by_name(tmp_path):
    root = _make_kitti2015(tmp_path)
    assert sorted(t_data.PROVIDERS) == sorted(j_data.PROVIDERS)
    for name in t_data.PROVIDERS:
        assert dataclasses.asdict(t_data.PROVIDERS[name]) == \
            dataclasses.asdict(j_data.PROVIDERS[name])
    got = t_data.paths_for_dataset("kitti2015-tr", root)
    assert got == j_data.paths_for_dataset("kitti2015-tr", root) and len(got) == 3
    with pytest.raises(ValueError, match="unsupported dataset"):
        t_data.paths_for_dataset("nope", root)

    checked = t_data.check_dataset("kitti2015-tr", root)
    cols, size_min = checked.columns()
    assert len(cols[0]) == 3 and cols[3] is None and size_min == (60, 80)
    assert os.path.exists(os.path.join(root, "paths", "kitti2015-tr.json"))
    # the cache is JAX's format: each package reads the other's
    assert j_data.check_dataset("kitti2015-tr", root).columns() == (cols, size_min)

    t_ds = t_data.dataset_by_name("kitti2015-tr", root, transform=t_data.eval_transform(),
                                  train=False)
    j_ds = j_data.dataset_by_name("kitti2015-tr", root, transform=j_data.eval_transform(),
                                  train=False)
    for i in range(len(j_ds)):
        (a, an), (b, bn) = t_ds[i], j_ds[i]
        assert an == bn and a.shape == (60, 80, 7)
        np.testing.assert_array_equal(a, b)
    both = t_data.dataset_by_name("kitti2015-tr_kitti2015-tr", root)
    assert isinstance(both, t_data.ConcatDataset) and len(both) == 6
