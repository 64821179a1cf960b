"""Distance penalties between adversarial and original clouds.

Counterpart of ``pointcloudattack_tpu/losses/distance.py`` (``l2_dist``
so far).  Channels-last ``[B, N, 3]`` in, per-example ``[B]`` out.
"""

from __future__ import annotations

import torch


def l2_dist(adv: torch.Tensor, ori: torch.Tensor) -> torch.Tensor:
    """Global L2 norm of the perturbation, ``[B]``."""
    return torch.sqrt(((adv - ori) ** 2).sum(dim=(1, 2)))
