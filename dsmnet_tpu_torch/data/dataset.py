"""Stereo datasets and a threaded prefetching batch loader
(``dsmnet_tpu/data/dataset.py``).

The reference's torch Dataset/DataLoader pair (myDatasets_stereo/
Dataset_stereo.py + DataLoader(num_workers=4)) as a numpy pipeline:
worker threads decode and augment samples (cv2, numpy and torch's CPU
ops release the GIL), a reorder buffer hands batches out in a fixed
order, and batches arrive as contiguous (N, H, W, C) float32 arrays.

``SyntheticStereoDataset`` makes stereo pairs with exact ground truth,
so the whole train loop runs without SceneFlow or KITTI on disk.  Its
texture is upsampled by torch's ``bicubic`` (cv2's ``INTER_CUBIC`` in
JAX: the same half-pixel cubic with a = -0.75 and edge replication), so
it needs no cv2.
"""

from __future__ import annotations

import logging
import os
import threading

import numpy as np

from .check import check_dataset
from .io import imread, load_disp
from .transforms import resize_image

__all__ = [
    "StereoDataset",
    "SyntheticStereoDataset",
    "ConcatDataset",
    "BatchLoader",
    "dataset_by_name",
]

log = logging.getLogger(__name__)


class StereoDataset:
    """File-backed dataset (Dataset_stereo.py:47-131): per sample, load L/R
    images (+0-2 disparities), crop centre-bottom to the dataset's least
    size, stack to (H, W, 6/7/8), hop to another index on a bad file, flip
    GT-free training samples left-right at random, then the transform."""

    def __init__(self, paths_img_left, paths_img_right, paths_disp_left=None,
                 paths_disp_right=None, transform=None, size_min=None,
                 train=False, rng=None):
        self.paths_img_left = paths_img_left
        self.paths_img_right = paths_img_right
        self.paths_disp_left = paths_disp_left
        self.paths_disp_right = paths_disp_right
        self.transform = transform
        self.size_min = size_min
        self.train = train
        self.rng = rng or np.random.RandomState()

    def __len__(self):
        return len(self.paths_img_left)

    def _crop_cb(self, img):
        """Centre-bottom crop to the dataset's least size (Dataset_stereo.py:63-74)."""
        if self.size_min is None:
            return img
        h_min, w_min = self.size_min
        h, w = img.shape[:2]
        ws = (w - w_min) // 2
        return img[-h_min:, ws : ws + w_min]

    def _load(self, index):
        imL = self._crop_cb(imread(self.paths_img_left[index]))
        imR = self._crop_cb(imread(self.paths_img_right[index]))
        parts = [np.float32(imL), np.float32(imR)]
        if self.paths_disp_left is not None:
            dL = self._crop_cb(load_disp(self.paths_disp_left[index]))
            parts.append(np.float32(dL)[:, :, None])
            if self.paths_disp_right is not None:
                dR = self._crop_cb(load_disp(self.paths_disp_right[index]))
                parts.append(np.float32(dR)[:, :, None])
        return np.concatenate(parts, axis=2)

    def __getitem__(self, index):
        while True:
            try:
                img = self._load(index)
                break
            except Exception as err:  # noqa: BLE001 -- hop to another index
                log.error("load error at %s: %s", self.paths_img_left[index], err)
                if index > 10:
                    index -= int(self.rng.randint(index // 2, index))
                else:
                    index += int(self.rng.randint(10, 20))
                index = min(max(index, 0), len(self) - 1)
        # random horizontal flip only when there is no GT channel
        # (Dataset_stereo.py:119-123: channel parity check)
        if self.train and img.shape[2] % 2 == 0 and self.rng.rand() > 0.5:
            img = np.flip(img, axis=1).copy()
        if self.transform is not None:
            img = self.transform(img)
        return img, os.path.basename(self.paths_img_left[index])


class SyntheticStereoDataset:
    """Procedural stereo pairs with exact GT disparity.

    A smooth random texture is sampled for the (wider) right view; the
    left view is the texture shifted by a per-sample fronto-parallel
    disparity ramp.  Output channels [imL, imR, dispL] in [0, 255] image
    units, so the standard transforms apply unchanged.
    """

    def __init__(self, n=32, hw=(384, 768), max_disp=48, transform=None, seed=0,
                 with_gt=True, tex_scale=4):
        self.n = n
        self.hw = hw
        self.max_disp = max_disp
        self.transform = transform
        self.seed = seed
        self.with_gt = with_gt
        # texture feature wavelength ~2*tex_scale px: the photometric
        # basin of attraction is about half a wavelength, so GT-free
        # photometric training needs tex_scale >= max disparity
        self.tex_scale = tex_scale
        # a host's share of a path-less dataset is an index stride: host i
        # of p sees samples i, i+p, i+2p, ...
        self.index_offset = 0
        self.index_stride = 1

    def __len__(self):
        return (self.n - self.index_offset + self.index_stride - 1) // self.index_stride

    def __getitem__(self, index):
        index = self.index_offset + index * self.index_stride
        h, w = self.hw
        rng = np.random.RandomState(self.seed * 100003 + index)
        d0 = rng.uniform(4, self.max_disp * 0.5)
        d1 = rng.uniform(d0, self.max_disp)
        # disparity increases toward the bottom (floor-like ramp)
        disp = np.linspace(d0, d1, h, dtype=np.float32)[:, None] * np.ones(
            (1, w), np.float32
        )
        pad = int(np.ceil(self.max_disp)) + 1
        ts = self.tex_scale
        tex = rng.rand(h // ts + 2, (w + pad) // ts + 2, 3).astype(np.float32)
        tex = resize_image(tex, (h, w + pad), mode="bicubic")
        tex = np.clip(tex, 0, 1) * 255.0
        # row-constant disparity: imL[x] = tex[x], imR[x] = tex[x + d]
        # => imL[x] == imR[x - d] (the reference warp convention)
        imL = tex[:, :w]
        xs = np.arange(w, dtype=np.float32)[None, :] + disp
        x0 = np.floor(xs).astype(np.int64)
        frac = (xs - x0)[..., None]
        xi = np.clip(x0, 0, tex.shape[1] - 2)
        rows = np.arange(h)[:, None]
        imR = tex[rows, xi] * (1 - frac) + tex[rows, xi + 1] * frac
        parts = [imL.astype(np.float32), imR.astype(np.float32)]
        if self.with_gt:
            parts.append(disp[:, :, None])
        img = np.concatenate(parts, axis=2)
        if self.transform is not None:
            img = self.transform(img)
        return img, f"synthetic_{index:06d}.png"


class ConcatDataset:
    """Concatenation of datasets (Dataset_stereo.py:19-45 Datasets_stereo)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index):
        i = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self.datasets[i][index - self._offsets[i]]


class BatchLoader:
    """Threaded shuffling batch loader with prefetch.

    ``num_workers`` threads each claim whole batches from a shared cursor,
    decode and augment them, and publish them into a reorder buffer, so the
    consumer sees batches in the same order whatever the worker count: the
    reference's ``DataLoader(num_workers=4)`` contract
    (stereo_supervised.py:29-39) without fork workers.  At most
    ``prefetch + num_workers`` batches are in flight.  A worker's error is
    raised in the consumer.  The workers (threads named
    ``BatchLoader-worker-<i>``) have ended when an epoch's iteration ends,
    also when it is closed early.

    Yields (batch (N, H, W, C) float32, list of file names);
    ``drop_last=False`` like the reference's DataLoaders.

    ``rank_slice=(index, count)``: each batch of ``batch_size`` is the
    global batch of a data-parallel step over ``count`` ranks, cut into
    ``count`` equal slices in rank order; this loader decodes and yields
    slice ``index`` only.  Every rank's loader has the same seed, so the
    ranks cut the same global batches.  A batch that ``count`` does not
    divide raises.
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=4,
                 drop_last=False, seed=0, prefetch=4, rank_slice=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.rank_slice = rank_slice
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _decode_batch(self, idxs):
        samples = [self.dataset[int(i)] for i in idxs]
        arrs = [s[0] for s in samples]
        shapes = {a.shape for a in arrs}
        if len(shapes) > 1:
            raise ValueError(
                f"heterogeneous sample shapes in one batch: {shapes} "
                "(crop size must be strictly smaller than "
                "image width minus shift_max)"
            )
        imgs = np.stack(arrs).astype(np.float32)
        names = [s[1] for s in samples]
        return imgs, names

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        batches = [
            order[i : i + self.batch_size] for i in range(0, n, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.rank_slice is not None:
            index, count = self.rank_slice
            for b in batches:
                if len(b) % count:
                    raise ValueError(f"a batch of {len(b)} does not split over {count} ranks")
            batches = [b[index * (len(b) // count):(index + 1) * (len(b) // count)]
                       for b in batches]

        nw = min(self.num_workers, max(1, len(batches)))
        stop = threading.Event()
        slots = threading.Semaphore(self.prefetch + nw)
        cursor_lock = threading.Lock()
        cursor = [0]
        done: dict = {}
        cond = threading.Condition()

        def claim():
            with cursor_lock:
                i = cursor[0]
                if i >= len(batches):
                    return None, None
                cursor[0] = i + 1
                return i, batches[i]

        def worker():
            while not stop.is_set():
                slots.acquire()
                if stop.is_set():
                    return
                seq, idxs = claim()
                if seq is None:
                    slots.release()
                    return
                try:
                    item = self._decode_batch(idxs)
                except Exception as exc:  # noqa: BLE001 -- raised in the consumer
                    item = exc
                with cond:
                    done[seq] = item
                    cond.notify_all()
                if isinstance(item, Exception):
                    return

        threads = [threading.Thread(target=worker, name=f"BatchLoader-worker-{i}", daemon=True)
                   for i in range(nw)]
        for t in threads:
            t.start()
        try:
            for seq in range(len(batches)):
                with cond:
                    while seq not in done:
                        cond.wait(timeout=0.5)
                        if seq not in done and not any(
                            t.is_alive() for t in threads
                        ):
                            raise RuntimeError(
                                "BatchLoader workers died without output"
                            )
                    item = done.pop(seq)
                if isinstance(item, Exception):
                    raise item
                yield item
                slots.release()
        finally:
            stop.set()
            # unblock any worker parked on the semaphore, then wait for each
            # to finish the batch it holds
            for _ in threads:
                slots.release()
            for t in threads:
                t.join()


def dataset_by_name(names: str, root: str, transform=None, train=True):
    """'_'-joined dataset concat factory (myDatasets_stereo/__init__.py:7-15)."""
    parts = names.split("_")
    datasets = []
    size_min = None
    for name in parts:
        checked = check_dataset(name, root)
        cols, sm = checked.columns()
        size_min = sm if size_min is None else (
            min(size_min[0], sm[0]), min(size_min[1], sm[1])
        )
        datasets.append(cols)
    built = []
    for cols in datasets:
        built.append(
            StereoDataset(cols[0], cols[1], cols[2], cols[3],
                          transform=transform, size_min=size_min, train=train)
        )
    return built[0] if len(built) == 1 else ConcatDataset(built)
