"""Carry flax variable trees into the port's modules.

The port's modules keep the flax parameter names and layouts, so a flax
``{params, batch_stats}`` tree maps onto ``named_parameters`` /
``named_buffers`` path for path: ``params/feature_extraction/firstconv0/
Conv_0/kernel`` is ``feature_extraction.firstconv0.Conv_0.kernel``.  The
copy is checked: a missing, unused or mis-shaped leaf raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["flatten", "load_flax_variables", "load_npz"]


def flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested mapping -> {'.'-joined path: numpy array}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _copy_checked(targets: dict[str, torch.Tensor], leaves: dict[str, np.ndarray],
                  kind: str) -> None:
    missing = sorted(set(targets) - set(leaves))
    unused = sorted(set(leaves) - set(targets))
    if missing or unused:
        raise KeyError(f"{kind} tree does not match the model: missing {missing}, "
                       f"unused {unused}")
    for path, t in targets.items():
        a = leaves[path]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{kind} leaf {path}: shape {tuple(a.shape)}, "
                             f"model expects {tuple(t.shape)}")
    with torch.no_grad():
        for path, t in targets.items():
            t.copy_(torch.from_numpy(np.array(leaves[path])).to(t.dtype))


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping | None = None) -> nn.Module:
    """Copy a flax ``params`` tree (and, if given, ``batch_stats``) into
    ``model``.  Leaves are array-likes; every parameter / buffer must be
    matched exactly once with the same shape."""
    _copy_checked(dict(model.named_parameters()), flatten(params), "params")
    if batch_stats is not None:
        _copy_checked(dict(model.named_buffers()), flatten(batch_stats), "batch_stats")
    return model


def load_npz(model: nn.Module, path: str) -> nn.Module:
    """Load an ``.npz`` whose keys are '/'-joined flax paths
    (``params/...`` and optionally ``batch_stats/...``)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    trees: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, value in flat.items():
        root, _, rest = key.partition("/")
        if root not in trees or not rest:
            raise KeyError(f"{path}: key {key!r} is not under params/ or batch_stats/")
        node = trees[root]
        *parents, leaf = rest.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return load_flax_variables(model, trees["params"], trees["batch_stats"] or None)

