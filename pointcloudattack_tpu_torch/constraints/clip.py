"""Perturbation clipping.

Counterpart of ``pointcloudattack_tpu/constraints/clip.py``
(``clip_points_linf`` so far).  Attack loops apply it under
``torch.no_grad()`` after each optimizer step.  Channels-last ``[B, N, 3]``.
"""

from __future__ import annotations

import torch


def clip_points_linf(pc: torch.Tensor, ori: torch.Tensor, budget: float) -> torch.Tensor:
    """Scale each point's displacement onto an L2 ball of radius ``budget``
    (the reference calls this "Linf" because the budget applies per point)."""
    diff = pc - ori
    norm = torch.sqrt((diff**2).sum(dim=-1, keepdim=True))  # [B, N, 1]
    scale = torch.clamp_max(budget / (norm + 1e-9), 1.0)
    return ori + diff * scale
