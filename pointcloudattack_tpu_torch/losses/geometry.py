"""Geometry helpers of the attack losses.

Counterpart of ``pointcloudattack_tpu/losses/geometry.py`` (``nn1_idx`` so
far).
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.pairwise import first_argmin, pairwise_sqdist


def nn1_idx(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Index of each ``x`` point's nearest ``y`` point, ``[B, N]`` int32:
    the first index on ties, over ``pairwise_sqdist`` of the detached
    inputs."""
    return first_argmin(pairwise_sqdist(x.detach(), y.detach()))[1]
