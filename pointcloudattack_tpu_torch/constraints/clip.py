"""Perturbation clipping and surface projection.

Counterpart of ``pointcloudattack_tpu/constraints/clip.py``.  Attack loops
apply these under ``torch.no_grad()`` after each optimizer step.
Channels-last ``[B, N, 3]``.
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


def clip_points_l2(pc: torch.Tensor, ori: torch.Tensor, budget: float) -> torch.Tensor:
    """Scale the whole-cloud displacement onto a global L2 ball."""
    diff = pc - ori
    norm = torch.sqrt((diff**2).sum(dim=(1, 2), keepdim=True))  # [B, 1, 1]
    scale = torch.clamp_max(budget / (norm + 1e-9), 1.0)
    return ori + diff * scale


def project_inner_points(pc: torch.Tensor, ori: torch.Tensor, normal: torch.Tensor | None) -> torch.Tensor:
    """Project displacements that point inside the surface back onto it.

    A point whose displacement has a negative dot with the outward normal
    takes ``diff * vref / |vref|`` instead, ``vref = (normal x diff) x
    normal`` (the reference divides elementwise, and so does this); one
    whose displacement is anti-parallel to the normal is not moved.
    """
    if normal is None:
        return pc
    diff = pc - ori
    inner_mask = (diff * normal).sum(dim=-1) < 0.0  # [B, N]
    vng = torch.linalg.cross(normal, diff, dim=-1)
    vng_norm = torch.sqrt((vng**2).sum(dim=-1))
    vref = torch.linalg.cross(vng, normal, dim=-1)
    vref_norm = torch.sqrt((vref**2).sum(dim=-1))
    proj = diff * vref / (vref_norm[..., None] + 1e-9)
    opposite = inner_mask & (vng_norm < 1e-6)
    proj = torch.where(opposite[..., None], 0.0, proj)
    return ori + torch.where(inner_mask[..., None], proj, diff)


def project_inner_clip_linf(
    pc: torch.Tensor, ori: torch.Tensor, budget: float, normal: torch.Tensor | None = None
) -> torch.Tensor:
    """Surface projection, then the per-point clip."""
    return clip_points_linf(project_inner_points(pc, ori, normal), ori, budget)
