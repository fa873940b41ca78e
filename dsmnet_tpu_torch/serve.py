"""Serving: a model held on the device in eval mode that answers disparity requests.

Counterpart of the JAX package's deploy path (``dsmnet_tpu/cli.py:129-173``:
``model.apply(..., train=False, clamp=True)``, first head).  A request is
a left/right RGB pair in [0, 1]; the answer is the model's full-resolution
``disps[0]`` (PSMNet's ``pred3``), clamped to [1e-6, max(maxdisparity, W)].
Any model of ``models.MODELS`` serves: psmnet, psmnet_basic, gcnet,
dispnet, dispnetcorr, iresnet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .images import normalize_imagenet
from .models import create_model
from .models.layers import compute_dtype
from .train.state import load_weights

__all__ = ["Predictor"]


class Predictor:
    """Holds a model on ``device`` (``None`` = CUDA) and answers ``predict``.

    ``model`` may be given ready-made (weights and BN statistics already
    set); otherwise ``net`` is created with weights drawn from ``seed`` or
    loaded from ``weights`` (``train.state.load_weights``: the port's ``.pt``,
    an ``.npz`` of '/'-joined flax paths or a JAX ``.msgpack``).  The
    convolutions run in ``dtype``: float32 by default, as the JAX deploy
    computes, or bfloat16; parameters, BN statistics and the regression
    stay float32."""

    def __init__(self, model: torch.nn.Module | None = None, *, net: str = "psmnet",
                 maxdisparity: int = 192, weights: str | None = None, seed: int = 0,
                 device=None, dtype: torch.dtype = torch.float32):
        self.device = config.resolve_device(device)
        if model is None:
            model = create_model(net, maxdisparity)
            model.reset_parameters(torch.Generator().manual_seed(seed))
            if weights:
                load_weights(weights, model)
        self.model = model.to(self.device).eval()
        self.dtype = dtype

    def _batch(self, im) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(im, np.float32) if not torch.is_tensor(im) else im)
        if t.dim() == 3:
            t = t[None]
        if t.dim() != 4 or t.shape[-1] != 3:
            raise ValueError(f"expected an (H,W,3) or (N,H,W,3) image, got {tuple(t.shape)}")
        return normalize_imagenet(t.to(self.device, torch.float32))

    @torch.no_grad()
    def predict(self, imL, imR) -> np.ndarray:
        """Disparity (N, H, W) float32 for RGB pairs in [0, 1]."""
        iL, iR = self._batch(imL), self._batch(imR)
        with compute_dtype(None if self.dtype == torch.float32 else self.dtype):
            _, disps = self.model(iL, iR, clamp=True)
        return disps[0][..., 0].float().cpu().numpy()
