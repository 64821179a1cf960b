"""Geometry-aware losses of the GeoA3 attack and their helpers.

Counterpart of ``pointcloudattack_tpu/losses/geometry.py``: ``nn1_idx``,
``self_knn_idx``, the curvature proxies ``kappa_ori`` / ``kappa_adv`` and
``curvature_loss``.  The curvature runs through ``ops/kappa.py::
kappa_knn_mean`` (the kernel on a CUDA tensor, its plain version on a CPU
tensor), the JAX package's TPU route.  ``displacement_loss`` and
``knn_smoothing_loss`` are not ported yet.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.kappa import kappa_knn_mean
from pointcloudattack_tpu_torch.ops.knn import knn
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
    Chamfer bundle).  A cached neighbour set (``self_idx``) needs the
    fixed-index kernel, not ported yet."""
    if self_idx is not None:
        raise NotImplementedError(
            "kappa_adv(self_idx=...) needs kappa_knn_mean_from_idx, not ported yet (ROADMAP Queue 1 item 5)"
        )
    if nn_idx is None:
        nn_idx = nn1_idx(adv, ori)
    normal = index_points(ori_normal, nn_idx)
    return kappa_knn_mean(adv, normal, k), normal


def curvature_loss(adv, ori, adv_kappa, ori_kappa, nn_idx=None) -> torch.Tensor:
    """Mean squared curvature mismatch between each adversarial point and
    its nearest clean point, ``[B]``."""
    if nn_idx is None:
        nn_idx = nn1_idx(adv, ori)
    matched = torch.gather(ori_kappa, 1, nn_idx.long())
    return ((adv_kappa - matched) ** 2).mean(dim=-1)
