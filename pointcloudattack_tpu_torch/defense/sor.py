"""SOR: statistical outlier removal (the DUP-Net paper's denoiser).

Counterpart of ``pointcloudattack_tpu/defense/sor.py`` (reference
attack/SIadv/baselines/defense/drop_points/SOR.py:24-84): a point's value is
the mean squared distance to its ``k`` nearest other points; points whose
value exceeds ``mean + alpha * std`` over the cloud are dropped, and the
survivors, in their order, are repeated cyclically up to ``npoint``.

The ``k + 1`` nearest points come from ``ops/knn.py::knn`` (the kNN kernel
on a CUDA tensor, a stable sort on a CPU tensor; no full sort of the
distance matrix), and their squared distances are computed again in
``pairwise_sqdist``'s op order, so they are the plain sort's values bit for
bit.  The keep mask is ``sor_keep``, a module-level function.  The output
is a gather of the input, so the gradient reaches the kept points.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.knn import knn
from pointcloudattack_tpu_torch.ops.pairwise import dot_last


def knn_values(pc: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, N]``, detached: each point's mean squared distance to its ``k``
    nearest points, the nearest of ``k + 1`` (itself) left out."""
    x = pc.detach().float()
    idx = knn(x, k + 1)  # ascending, ties to the lower index
    nb = index_points(x, idx)  # [B, N, k + 1, 3]
    xx = dot_last(x, x)[..., None]
    d = xx - 2.0 * dot_last(x[:, :, None, :], nb) + dot_last(nb, nb)  # pairwise_sqdist's order
    total = d[..., 1]
    for j in range(2, k + 1):
        total = total + d[..., j]
    return total / torch.full_like(total, k)  # a true division on every device


def sor_keep(value: torch.Tensor, alpha: float) -> torch.Tensor:
    """``[B, N]`` bool: the points whose value is at most ``mean + alpha *
    std`` (``ddof=1``) over their cloud.  A module-level function, so that a
    caller can record the mask on one device and replay it on another (a
    value within rounding of the threshold may fall on either side)."""
    mean = value.mean(dim=-1, keepdim=True)
    std = value.std(dim=-1, keepdim=True, unbiased=True)
    return value <= mean + alpha * std


def sor_defense(pc: torch.Tensor, k: int = 2, alpha: float = 1.1, npoint: int = 1024) -> torch.Tensor:
    """``pc [B, N, 3]`` -> ``[B, npoint, 3]``: the kept points in their
    order, repeated cyclically to ``npoint``."""
    keep = sor_keep(knn_values(pc, k), alpha)
    order = torch.sort((~keep).to(torch.int32), dim=-1, stable=True).indices  # kept points first
    num_kept = keep.sum(dim=-1, keepdim=True).clamp_min(1)
    slot = torch.arange(npoint, device=pc.device)[None, :] % num_kept  # [B, npoint]
    return index_points(pc, order.gather(1, slot))
