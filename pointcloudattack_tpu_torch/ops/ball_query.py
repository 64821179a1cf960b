"""Radius-ball neighbourhood query with static shapes.

Counterpart of ``pointcloudattack_tpu/ops/ball_query.py::query_ball_point``
(its rank + top-k path): take the first ``nsample`` in-radius points in
index order, and pad a short neighbourhood with its first in-radius index,
or with index 0 for an empty ball.  Plain PyTorch on both devices: the JAX
package computes it outside any kernel too.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloudattack_tpu_torch.ops.pairwise import pairwise_sqdist


def ball_r2(radius: float) -> np.float32:
    """The squared radius a point's squared distance is compared with:
    ``radius * radius`` in double, then float32, as the JAX package's
    ``sqr <= radius * radius`` takes it."""
    return np.float32(radius * radius)


def query_ball_point(
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    new_xyz: torch.Tensor,
    sqr: torch.Tensor | None = None,
) -> torch.Tensor:
    """``xyz [B, N, 3]``, ``new_xyz [B, S, 3]`` -> ``[B, S, nsample]`` int32
    indices into N.  ``sqr``, a precomputed ``pairwise_sqdist(new_xyz,
    xyz)``, lets several radii share one distance matrix (MSG)."""
    n = xyz.shape[1]
    if sqr is None:
        sqr = pairwise_sqdist(new_xyz.detach(), xyz.detach())  # [B, S, N]
    in_ball = sqr <= torch.tensor(ball_r2(radius), device=sqr.device)
    point_idx = torch.arange(n, dtype=torch.int32, device=sqr.device)
    rank = torch.where(in_ball, point_idx, n)
    k = min(nsample, n)
    group_idx = torch.topk(rank, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        # N < nsample: pad with out-of-ball sentinels, filled below
        pad = group_idx.new_full(group_idx.shape[:-1] + (nsample - k,), n)
        group_idx = torch.cat([group_idx, pad], dim=-1)
    first = group_idx[..., :1]
    first = torch.where(first == n, 0, first)
    return torch.where(group_idx == n, first, group_idx)
