"""Model registry of the port (counterpart of ``dsmnet_tpu/models/__init__.py``).

Every model obeys the JAX package's contract, ``scales, disps =
model(imL, imR, clamp=...)`` with NHWC images and ``disps[0]`` the
full-resolution (N, H, W, 1) disparity.  Every model of the JAX zoo is
ported; ``GCNetLR``, the bidirectional GCNet, returns (dispL, dispR) and
is outside the factory, as in JAX.
"""

from __future__ import annotations

from .dispnet import DispNet, DispNetC
from .gcnet import GCNet, GCNetLR
from .iresnet import IResNet
from .psmnet import PSMNet
from .psmnet_basic import PSMNetBasic

MODELS = {
    "dispnet": DispNet,
    "dispnetcorr": DispNetC,
    "gcnet": GCNet,
    "iresnet": IResNet,
    "psmnet": PSMNet,
    "psmnet_basic": PSMNetBasic,
}


def create_model(name: str, maxdisparity: int = 192, **kwargs):
    """Name -> nn.Module (parameters uninitialized until ``reset_parameters``
    or a weight load); ``kwargs`` go to the model's constructor, as in JAX
    (``dsmnet_tpu/models/__init__.py:30``): ``count_levels`` (every model),
    ``remat`` (PSMNet, GCNet), ``fused_stem`` (PSMNet), ``corr_d`` (DispNetC),
    ``iterations`` (iResNet)."""
    if name not in MODELS:
        raise ValueError(f"unknown model '{name}'; supported: {sorted(MODELS)}")
    return MODELS[name](maxdisparity=maxdisparity, **kwargs)


__all__ = ["MODELS", "create_model", "DispNet", "DispNetC", "GCNet", "GCNetLR", "IResNet",
           "PSMNet", "PSMNetBasic"]
