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


def scatter_rows(base: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``base [B, P, C]`` with ``rows [B, Q, C]`` added at ``idx [B, Q]``, in
    place, in ascending ``q`` (``index_add_``'s order on the CPU)."""
    b, p, c = base.shape
    flat = (idx.long() + torch.arange(b, device=base.device)[:, None] * p).reshape(-1)
    return base.view(-1, c).index_add_(0, flat, rows.reshape(-1, c)).view(base.shape)
