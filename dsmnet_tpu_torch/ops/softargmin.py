"""Soft-argmin disparity regression over a cost axis (GCNet).

PyTorch counterpart of ``dsmnet_tpu/ops/softargmin.py``: softmax over the
disparity axis (of the negated cost for GCNet, where a low cost is a
likely match), then the expectation sum_d d * p(d), in float32 whatever
the compute dtype (float64 for a float64 cost).
"""

from __future__ import annotations

import torch

__all__ = ["soft_argmin"]


def soft_argmin(cost: torch.Tensor, negate: bool = True) -> torch.Tensor:
    """Expected disparity from a (N, D, H, W) cost -> (N, H, W, 1)."""
    x = cost.to(torch.promote_types(cost.dtype, torch.float32))
    p = torch.softmax(-x if negate else x, dim=1)
    dvals = torch.arange(x.shape[1], dtype=x.dtype, device=x.device)
    return torch.einsum("ndhw,d->nhw", p, dvals)[..., None]
