"""Dataset validation + path cache (``dsmnet_tpu/data/check.py``; reference
myDatasets_stereo/stereo_check.py).

Loads every sample once, quarantines unreadable files and disparity maps
where more than 20% of pixels exceed width/3 (stereo_check.py:33-40),
tracks the global minimum H/W (used for center-bottom cropping), and
caches the result to ``<root>/paths/<name>.json`` for instant reuse
(json rather than the reference's pickle: human-inspectable and safe to
load).  Validation fans out over a thread pool — cv2/numpy release the
GIL during decode.
"""

from __future__ import annotations

import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor

from .io import imread, load_disp
from .paths import paths_for_dataset

__all__ = ["check_dataset", "CheckedDataset"]

log = logging.getLogger(__name__)


class CheckedDataset:
    """Validated path groups + min size for one dataset."""

    def __init__(self, name: str, root: str, workers: int = 8, use_cache: bool = True):
        self.name = name
        self.root = root
        cache = os.path.join(root, "paths", f"{name}.json")
        if use_cache and os.path.exists(cache):
            with open(cache) as f:
                payload = json.load(f)
            self.paths_good = payload["good"]
            self.paths_bad = payload["bad"]
            self.size_min = tuple(payload["size_min"])
            return
        groups = paths_for_dataset(name, root)
        if not groups:
            raise FileNotFoundError(f"dataset '{name}' not found under {root}")
        good, bad = [], []
        h_min = w_min = 10**9

        def check(group):
            try:
                for j, path in enumerate(group):
                    if not os.path.exists(path):
                        return None
                    if j < 2:
                        img = imread(path)
                        if img.ndim < 2:
                            return None
                        hw = img.shape[:2]
                    else:
                        disp = load_disp(path)
                        th = disp.shape[1] / 3.0
                        if (disp > th).mean() > 0.2:  # stereo_check.py:33-40
                            return None
                return hw
            except Exception as err:  # noqa: BLE001 — quarantine any bad file
                log.warning("bad sample %s: %s", group[0], err)
                return None

        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(check, groups))
        for group, hw in zip(groups, results):
            if hw is None:
                bad.append(group)
            else:
                good.append(group)
                h_min = min(h_min, hw[0])
                w_min = min(w_min, hw[1])
        self.paths_good = good
        self.paths_bad = bad
        self.size_min = (h_min, w_min)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        tmp = cache + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"good": good, "bad": bad, "size_min": [h_min, w_min]}, f)
        os.replace(tmp, cache)
        log.info("dataset %s: %d good, %d bad", name, len(good), len(bad))

    def columns(self):
        """Transpose groups into up to 4 path columns padded with None
        (stereo_check.py:159-167 getpaths)."""
        if not self.paths_good:
            return [None] * 4, self.size_min
        n = len(self.paths_good[0])
        cols = [[g[j] for g in self.paths_good] for j in range(n)]
        while len(cols) < 4:
            cols.append(None)
        return cols, self.size_min


def check_dataset(name: str, root: str, **kw) -> CheckedDataset:
    return CheckedDataset(name, root, **kw)
