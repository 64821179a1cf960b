"""Point-cloud normals by local PCA.

Counterpart of ``pointcloudattack_tpu/geometry/normals.py::_local_cov`` and
``estimate_normal``: each point's ``k`` nearest neighbours (self excluded)
through ``ops/knn.py::knn`` (the kNN kernel on a CUDA tensor), their
covariance, and its smallest eigenvector by the closed-form 3x3 solver.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.geometry.eig3 import sym_eigh_3x3
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.knn import knn
from pointcloudattack_tpu_torch.ops.pairwise import sum_neighbours


def _local_cov(pc: torch.Tensor, k: int):
    """``(cov [B, N, 3, 3], centered neighbour sum [B, N, 3])`` of each
    point's ``k`` nearest neighbours, self excluded; the covariance divides
    by ``k - 1``, as the reference does.  The centered sum that orients a
    normal is 0 up to rounding, so its sign comes from the rounding: the mean
    (the sum times ``1/k``) and the sum run in the JAX package's order on the
    CPU, so both pick the same sign."""
    idx = knn(pc, k + 1)[..., 1:]
    nbrs = index_points(pc, idx)  # [B, N, k, 3]
    centered = nbrs - (sum_neighbours(nbrs) * (1.0 / k))[:, :, None]
    cov = (centered[..., :, None] * centered[..., None, :]).sum(dim=2) / (k - 1)
    return cov, sum_neighbours(centered)


def estimate_normal(pc: torch.Tensor, k: int = 3) -> torch.Tensor:
    """``[B, N, 3]`` unit normals, detached: the smallest-eigenvalue
    eigenvector of each local covariance, flipped to point away from the
    centered neighbour mass; where that mass is exactly balanced (a sign of
    0) the eigenvector keeps its orientation.  ``k`` counts neighbours
    without the point itself (GeoA3 passes 3)."""
    cov, nbr_sum = _local_cov(pc.detach(), k)
    normal = sym_eigh_3x3(cov)[1][..., :, 0]
    sign = -torch.sign((normal * nbr_sum).sum(dim=-1, keepdim=True))
    return torch.where(sign == 0.0, 1.0, sign) * normal
