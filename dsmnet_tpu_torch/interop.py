"""Carry flax variable trees into the port's modules.

The port's modules keep the flax parameter names and layouts, so a flax
``{params, batch_stats}`` tree maps onto ``named_parameters`` /
``named_buffers`` path for path: ``params/feature_extraction/firstconv0/
Conv_0/kernel`` is ``feature_extraction.firstconv0.Conv_0.kernel``.  The
copy is checked: a missing, unused or mis-shaped leaf raises.

``load_msgpack`` reads the JAX package's ``.msgpack`` files
(``flax.serialization.msgpack_serialize``: ``weight_best.msgpack``'s
``{params}``, ``model_*.msgpack``'s ``{epoch, best_prec, state}``) with
the ``msgpack`` package alone, imported when called.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

__all__ = ["flatten", "load_flax_variables", "load_msgpack", "load_npz"]


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



# flax's msgpack extension codes (flax/serialization.py ``_MsgpackExtType``)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        # numpy has no bfloat16: widen its bits to float32's upper half
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    raise ValueError(f"unknown msgpack extension type {code}")


def _unchunk(tree):
    """flax splits a leaf over 2**30 bytes into ``__msgpack_chunked_array__``
    dicts; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_msgpack(path: str) -> dict:
    """A flax ``.msgpack`` file -> its tree of dicts with numpy leaves."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_unpack, raw=False)
    return _unchunk(tree)
