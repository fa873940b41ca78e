"""Data pipeline of the port (``dsmnet_tpu/data/``): path providers,
validation cache, datasets, transforms and the threaded batch loader.
numpy and torch's CPU ops only; cv2 is imported where an image file is
read or written."""

from .check import CheckedDataset, check_dataset
from .dataset import (
    BatchLoader,
    ConcatDataset,
    StereoDataset,
    SyntheticStereoDataset,
    dataset_by_name,
)
from .io import imread, imwrite, load_disp, load_pfm, save_pfm
from .paths import PROVIDERS, paths_for_dataset
from .transforms import (
    SpatialStereo,
    eval_transform,
    selfsup_eval_transform,
    selfsup_train_transform,
    supervised_train_transform,
)

__all__ = [
    "CheckedDataset",
    "check_dataset",
    "BatchLoader",
    "ConcatDataset",
    "StereoDataset",
    "SyntheticStereoDataset",
    "dataset_by_name",
    "imread",
    "imwrite",
    "load_disp",
    "load_pfm",
    "save_pfm",
    "PROVIDERS",
    "paths_for_dataset",
    "SpatialStereo",
    "eval_transform",
    "selfsup_eval_transform",
    "selfsup_train_transform",
    "supervised_train_transform",
]
