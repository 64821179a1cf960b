"""FPS + ball-query grouping for PointNet++ set abstraction.

Counterpart of ``pointcloudattack_tpu/ops/grouping.py``: the unfused path,
which builds the grouped ``[B, S, K, C]`` tensor.  Train mode and the CPU
reference take it; eval mode on the card builds the rows inside the
gather + chain kernel instead (``ops/gather_chain.py``).
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
from pointcloudattack_tpu_torch.ops.fps import farthest_point_sample
from pointcloudattack_tpu_torch.ops.gather import index_points


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: torch.Tensor,
    points: torch.Tensor | None,
    return_fps: bool = False,
):
    """FPS-select ``npoint`` centroids and group their radius neighbourhoods:
    ``new_xyz [B, S, 3]``, ``new_points [B, S, K, 3(+D)]`` (xyz minus the
    centroid first, features after); with ``return_fps`` also
    ``grouped_xyz`` and ``fps_idx``."""
    fps_idx = farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)  # [B, S, 3]
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx)  # [B, S, K, 3]
    grouped_norm = grouped_xyz - new_xyz[:, :, None, :]
    if points is not None:
        new_points = torch.cat([grouped_norm, index_points(points, idx)], dim=-1)
    else:
        new_points = grouped_norm
    if return_fps:
        return new_xyz, new_points, grouped_xyz, fps_idx
    return new_xyz, new_points


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None):
    """One group holding the whole cloud: ``new_xyz [B, 1, 3]`` of zeros and
    ``new_points [B, 1, N, 3(+D)]``."""
    b, _, c = xyz.shape
    new_xyz = xyz.new_zeros((b, 1, c))
    grouped = xyz[:, None]
    if points is not None:
        return new_xyz, torch.cat([grouped, points[:, None]], dim=-1)
    return new_xyz, grouped
