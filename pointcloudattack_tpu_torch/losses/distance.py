"""Distance penalties between adversarial and original clouds.

Counterpart of ``pointcloudattack_tpu/losses/distance.py``: ``l2_dist``,
the Chamfer and Hausdorff distances.  Channels-last ``[B, N, 3]`` in,
per-example ``[B]`` out.

A single direction of Chamfer or Hausdorff is a row min of
``ops/chamfer.py::min_sqdist_rows``; both directions at once
(``chamfer_both`` and GeoA3's bundle ``chamfer_hausdorff_nn``) come from one
``min_sqdist_both`` call, as the JAX package routes them on the TPU.  Each
is the kernel on a CUDA tensor and its plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.chamfer import min_sqdist_both, min_sqdist_rows


def l2_dist(adv: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
    """Global L2 norm of the perturbation, ``[B]``."""
    return torch.sqrt(((adv - ori) ** 2).sum(dim=(1, 2)))


def _min_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return min_sqdist_rows(x, y)[0]


def chamfer_both(adv: torch.Tensor, ori: torch.Tensor):
    """``(adv->ori, ori->adv)`` mean-of-min squared distances, each ``[B]``."""
    row_min, col_min, _ = min_sqdist_both(adv, ori)
    return row_min.mean(dim=-1), col_min.mean(dim=-1)


def chamfer_hausdorff_nn(adv: torch.Tensor, ori: torch.Tensor):
    """GeoA3's bundle from one two-direction call: ``(a2o [B], o2a [B],
    hd [B], nn_idx [B, N])``, the symmetric Chamfer terms (mean of the
    mins), the adv->ori Hausdorff (max of the same row mins) and each
    adversarial point's nearest clean index (int32, no gradient)."""
    row_min, col_min, nn_idx = min_sqdist_both(adv, ori)
    return row_min.mean(dim=-1), col_min.mean(dim=-1), row_min.amax(dim=-1), nn_idx


def chamfer_dist(adv: torch.Tensor, ori: torch.Tensor, method: str = "adv2ori") -> torch.Tensor:
    """Single-direction (``adv2ori``, ``ori2adv``) or symmetric (``both``)
    Chamfer distance, ``[B]``."""
    if method == "adv2ori":
        return _min_rows(adv, ori).mean(dim=-1)
    if method == "ori2adv":
        return _min_rows(ori, adv).mean(dim=-1)
    a2o, o2a = chamfer_both(adv, ori)
    return 0.5 * (a2o + o2a)


def hausdorff_both(adv: torch.Tensor, ori: torch.Tensor):
    """``(adv->ori, ori->adv)`` max-of-min squared distances, each ``[B]``."""
    return _min_rows(adv, ori).amax(dim=-1), _min_rows(ori, adv).amax(dim=-1)


def hausdorff_dist(adv: torch.Tensor, ori: torch.Tensor, method: str = "adv2ori") -> torch.Tensor:
    a2o, o2a = hausdorff_both(adv, ori)
    if method == "adv2ori":
        return a2o
    if method == "ori2adv":
        return o2a
    return 0.5 * (a2o + o2a)
