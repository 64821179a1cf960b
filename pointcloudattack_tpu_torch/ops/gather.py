"""Batched point gathering.

Counterpart of ``pointcloudattack_tpu/ops/gather.py::index_points``.  The
backward is autograd's: a scatter-add of the cotangent rows onto the
gathered points (duplicate indices sum).
"""

from __future__ import annotations

import torch


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points [B, N, C]``, ``idx [B, S]`` or ``[B, S, K]`` -> ``[B, S, C]``
    or ``[B, S, K, C]``."""
    if idx.dim() not in (2, 3):
        raise ValueError(f"idx must be rank 2 or 3, got shape {tuple(idx.shape)}")
    b = points.shape[0]
    batch = torch.arange(b, device=points.device).view((b,) + (1,) * (idx.dim() - 1))
    return points[batch, idx.long()]
