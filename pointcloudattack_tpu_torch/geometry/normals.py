"""Point-cloud normals and tangent-plane jitter by local PCA.

Counterpart of ``pointcloudattack_tpu/geometry/normals.py::_local_cov``,
``estimate_normal`` and ``estimate_perpendicular_jitter``: each point's
``k`` nearest neighbours (self excluded) through ``ops/knn.py::knn`` (the
kNN kernel on a CUDA tensor), their covariance, and its eigenvectors by the
closed-form 3x3 solver: the smallest is the normal, the two largest span
the tangent plane that the jitter moves in.
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


def jitter_from_noise(pc: torch.Tensor, k: int, a1: torch.Tensor, a2: torch.Tensor, clip: float = 0.05):
    """``[B, N, 3]``, detached: each point's largest and second largest
    local-covariance eigenvectors scaled by ``a1`` and ``a2 [B, N, 1]``,
    each product clipped to ``[-clip, clip]`` per coordinate, summed."""
    cov, _ = _local_cov(pc.detach(), k)
    vecs = sym_eigh_3x3(cov)[1]  # ascending eigenvalues
    v1, v2 = vecs[..., :, 2], vecs[..., :, 1]
    return torch.clamp(v1 * a1, -clip, clip) + torch.clamp(v2 * a2, -clip, clip)


def estimate_perpendicular_jitter(pc: torch.Tensor, k: int, generator: torch.Generator | None = None,
                                  sigma: float = 0.01, clip: float = 0.05) -> torch.Tensor:
    """Random jitter in each point's tangent plane, ``[B, N, 3]``: the
    ``jitter_from_noise`` of two ``sigma N(0, 1)`` draws per point from
    ``generator``."""
    b, n, _ = pc.shape
    a1, a2 = (sigma * torch.randn((b, n, 1), generator=generator, device=pc.device, dtype=pc.dtype)
              for _ in range(2))
    return jitter_from_noise(pc, k, a1, a2, clip)
