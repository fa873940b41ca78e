"""Dataset path providers (``dsmnet_tpu/data/paths.py``; reference
myDatasets_stereo/stereo_paths.py).

Each provider encodes one dataset's left->right / image->disparity
path-substitution rules plus a glob filter, yielding groups
[img_left, img_right, disp_left?, disp_right?].
"""

from __future__ import annotations

import dataclasses
import glob
import os

__all__ = ["PathProvider", "PROVIDERS", "paths_for_dataset"]


@dataclasses.dataclass(frozen=True)
class PathProvider:
    """Substitution-rule path provider (stereo_paths.py:14-103)."""

    name: str
    glob_pattern: str  # relative to root
    img_lr: tuple[str, str] | None = None  # left->right substitution
    img_disp: tuple[str, str] | None = None  # image->disparity substitution
    disp_lr: tuple[str, str] | None = None  # left->right disparity
    img_type: str = ".png"
    disp_type: str = ".png"
    sort: bool = False

    def groups(self, root: str) -> list[list[str]]:
        lefts = glob.glob(os.path.join(root, self.glob_pattern))
        if self.sort:
            lefts.sort()
        n_root = len(root)
        out = []
        for left in lefts:
            sub = left[n_root:]
            group = [left]
            group.append(root + sub.replace(*self.img_lr))
            if self.img_disp is not None:
                dsub = sub.replace(*self.img_disp)
                if self.img_type != self.disp_type:
                    dsub = dsub.replace(self.img_type, self.disp_type)
                group.append(root + dsub)
                if self.disp_lr is not None:
                    group.append(root + dsub.replace(*self.disp_lr))
            out.append(group)
        return out


_SCENEFLOW = dict(
    img_lr=("left", "right"),
    img_disp=("frames_finalpass_webp", "disparity"),
    disp_lr=("left", "right"),
    img_type=".webp",
    disp_type=".pfm",
)

PROVIDERS = {
    "monkaa": PathProvider(
        "monkaa", "monkaa/frames_finalpass_webp/*/left/*.webp", **_SCENEFLOW
    ),
    "driving": PathProvider(
        "driving", "driving/frames_finalpass_webp/*/*/*/left/*.webp", **_SCENEFLOW
    ),
    "flyingthings3d-tr": PathProvider(
        "flyingthings3d-tr",
        "flyingthings3d/frames_finalpass_webp/TRAIN/*/*/left/*.webp",
        **_SCENEFLOW,
    ),
    "flyingthings3d-te": PathProvider(
        "flyingthings3d-te",
        "flyingthings3d/frames_finalpass_webp/TEST/*/*/left/*.webp",
        **_SCENEFLOW,
    ),
    "kitti2015-tr": PathProvider(
        "kitti15-tr",
        "data_scene_flow/training/image_2/*_10.png",
        img_lr=("image_2", "image_3"),
        img_disp=("image_2", "disp_occ_0"),
        sort=True,
    ),
    "kitti2015-te": PathProvider(
        "kitti15-te",
        "data_scene_flow/testing/image_2/*_10.png",
        img_lr=("image_2", "image_3"),
        sort=True,
    ),
    "kitti2012-tr": PathProvider(
        "kitti12-tr",
        "data_stereo_flow/training/colored_0/*_10.png",
        img_lr=("colored_0", "colored_1"),
        img_disp=("colored_0", "disp_occ"),
        sort=True,
    ),
    "kitti2012-te": PathProvider(
        "kitti12-te",
        "data_stereo_flow/testing/colored_0/*_10.png",
        img_lr=("colored_0", "colored_1"),
        sort=True,
    ),
    "kitti-raw": PathProvider(
        "kitti-raw",
        "raw/*/*/image_02/data/*.png",
        img_lr=("image_02", "image_03"),
    ),
}


def _paths_from_list(root: str) -> list[list[str]]:
    """'stereo-list' manifest format (stereo_paths.py:66-103):
    <root>/paths_stereo.txt names one file per column; each lists one
    path per row."""
    manifest = os.path.join(root, "paths_stereo.txt")
    if not os.path.isfile(manifest):
        return []
    columns = []
    with open(manifest) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    for name in names:
        p = os.path.join(root, name)
        with open(p) as f:
            col = [ln.strip() for ln in f if ln.strip()]
        for fp in col:
            if not os.path.isfile(fp):
                raise FileNotFoundError(fp)
        if columns and len(col) != len(columns[-1]):
            raise ValueError(f"column length mismatch in {manifest}")
        columns.append(col)
    return [list(row) for row in zip(*columns)]


def paths_for_dataset(name: str, root: str) -> list[list[str]]:
    """Name -> path groups (stereo_paths.py:247-302)."""
    key = name.lower()
    if key == "stereo-list":
        return _paths_from_list(root)
    if key not in PROVIDERS:
        raise ValueError(f"unsupported dataset '{name}'; options: "
                         f"{sorted(PROVIDERS) + ['stereo-list']}")
    return PROVIDERS[key].groups(root)
