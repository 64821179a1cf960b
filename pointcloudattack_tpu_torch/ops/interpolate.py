"""3-NN inverse-distance feature interpolation (PointNet++'s and PU-Net's
feature propagation).

Counterpart of ``pointcloudattack_tpu/ops/interpolate.py``.  Plain PyTorch
on every device, as the JAX package computes it outside any Pallas kernel:
the three nearest source points of each destination point
(``ops/knn.py::knn_points``: squared distances ascending, ties to the lower
index), weights ``1 / (d + 1e-8)`` normalised over the three, and the
weighted sum of the gathered feature rows in slot order.  The distances
carry the gradient; the indices none.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.knn import knn_points
from pointcloudattack_tpu_torch.ops.pairwise import sum_neighbours


def three_nn(xyz_dst: torch.Tensor, xyz_src: torch.Tensor):
    """``(dists [B, N, 3], idx [B, N, 3] int32)``: each destination point's
    three nearest source points.  A module-level function, so that a caller
    can record the picks on one device and replay them on another."""
    return knn_points(xyz_dst, xyz_src, k=3)


def three_nn_interpolate(xyz_dst: torch.Tensor, xyz_src: torch.Tensor, feat_src: torch.Tensor) -> torch.Tensor:
    """``xyz_dst [B, N, 3]``, ``xyz_src [B, S, 3]``, ``feat_src [B, S, D]``
    -> ``[B, N, D]``: the inverse-distance weighted mean of each destination
    point's three nearest source rows."""
    dists, idx = three_nn(xyz_dst, xyz_src)
    recip = 1.0 / (dists + 1e-8)
    weight = recip / sum_neighbours(recip[..., None])  # [B, N, 3]
    gathered = index_points(feat_src, idx)  # [B, N, 3, D]
    return sum_neighbours(gathered * weight[..., None])
