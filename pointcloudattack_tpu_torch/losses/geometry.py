"""Geometry-aware losses of the GeoA3 attack and their helpers.

Counterpart of ``pointcloudattack_tpu/losses/geometry.py``: ``nn1_idx``,
``self_knn_idx``, the curvature proxies ``kappa_ori`` / ``kappa_adv``,
``curvature_loss``, ``displacement_loss`` and ``knn_smoothing_loss``.  The
curvature runs through ``ops/kappa.py::kappa_knn_mean``, or with a given
neighbour set ``kappa_knn_mean_from_idx`` (the kernels on a CUDA tensor,
their plain versions on a CPU tensor), the JAX package's TPU routes.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.kappa import kappa_knn_mean, kappa_knn_mean_from_idx
from pointcloudattack_tpu_torch.ops.knn import knn, knn_points
from pointcloudattack_tpu_torch.ops.pairwise import first_argmin, pairwise_sqdist


def nn1_idx(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Index of each ``x`` point's nearest ``y`` point, ``[B, N]`` int32:
    the first index on ties, over ``pairwise_sqdist`` of the detached
    inputs."""
    return first_argmin(pairwise_sqdist(x.detach(), y.detach()))[1]


def self_knn_idx(pc: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN indices without the first pick (the point itself),
    ``[B, N, k]`` int32."""
    return knn(pc, k + 1)[..., 1:]


def kappa_ori(pc: torch.Tensor, normal: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Curvature proxy of the clean cloud, ``[B, N]``: the mean projection
    of its ``k`` unit neighbour offsets on the point's normal."""
    return kappa_knn_mean(pc, normal, k)


def kappa_adv(adv, ori, ori_normal, k: int = 2, nn_idx=None, self_idx=None):
    """Curvature proxy of the adversarial cloud, each point taking the
    normal of its nearest clean point: ``(kappa [B, N], normal [B, N, 3])``.
    ``nn_idx [B, N]`` supplies that nearest index (GeoA3 takes it from its
    Chamfer bundle).  ``self_idx [B, N, k]`` supplies the cloud's own
    neighbour set (GeoA3's cache, refreshed every ``curv_knn_refresh``
    iterations); absent, the curvature selects it itself."""
    if nn_idx is None:
        nn_idx = nn1_idx(adv, ori)
    normal = index_points(ori_normal, nn_idx)
    if self_idx is None:
        return kappa_knn_mean(adv, normal, k), normal
    return kappa_knn_mean_from_idx(adv, normal, self_idx, k), normal


def curvature_loss(adv, ori, adv_kappa, ori_kappa, nn_idx=None) -> torch.Tensor:
    """Mean squared curvature mismatch between each adversarial point and
    its nearest clean point, ``[B]``."""
    if nn_idx is None:
        nn_idx = nn1_idx(adv, ori)
    matched = torch.gather(ori_kappa, 1, nn_idx.long())
    return ((adv_kappa - matched) ** 2).mean(dim=-1)


def displacement_loss(adv: torch.Tensor, ori: torch.Tensor, k: int = 16) -> torch.Tensor:
    """``[B, N]``: each point's mean squared gap between its displacement
    ``theta_i = |adv_i - ori_i|^2`` and those of its ``k`` clean-cloud
    neighbours."""
    idx = self_knn_idx(ori, k)
    theta = ((adv - ori) ** 2).sum(dim=-1)  # [B, N]
    nbr = torch.gather(theta, 1, idx.reshape(theta.shape[0], -1).long()).reshape(idx.shape)
    return ((nbr - theta[:, :, None]) ** 2).mean(dim=-1)


def knn_smoothing_loss(adv: torch.Tensor, k: int = 5, threshold_coef: float = 1.05) -> torch.Tensor:
    """``[B]``: the mean over points of each point's mean distance to its
    ``k`` nearest neighbours, counting only the points above the cloud's
    mean plus ``threshold_coef`` standard deviations (Bessel-corrected);
    that mask takes no gradient."""
    dists, _ = knn_points(adv, adv, k=k, exclude_self=True)
    value = dists.mean(dim=-1)  # [B, N]
    mean = value.mean(dim=-1, keepdim=True)
    std = value.std(dim=-1, keepdim=True, correction=1)
    mask = (value > mean + threshold_coef * std).to(adv.dtype).detach()
    return (value * mask).mean(dim=-1)
