"""Tangent-plane (spin-axis) frames of the SIadv attack.

Counterpart of ``pointcloudattack_tpu/geometry/tangent.py``: every point gets
an orthonormal frame ``U`` whose third row is its normal; the attack works
on ``P' = U (P + (P.N) N)`` and zeroes the normal (z) component of the
gradient, so its steps stay in the tangent plane.

The 3-term sums run one elementwise op at a time in ascending index order
(``ops/pairwise.py::dot_last``), so the card and the CPU give the same bits.
"""

from __future__ import annotations

import math

import torch

from pointcloudattack_tpu_torch.ops.pairwise import dot_last


def spin_axis_matrix(normal: torch.Tensor) -> torch.Tensor:
    """Orthonormal frame per point, ``[..., N, 3, 3]``; row 2 is the normal.
    Where ``|z^2 - 1| < 1e-4`` (the pole) the tangent plane is the xy plane,
    as in the reference."""
    x, y, z = normal[..., 0], normal[..., 1], normal[..., 2]
    zero = torch.zeros_like(z)
    denom = torch.sqrt(torch.clamp_min(1.0 - z**2, 1e-12))
    row0 = torch.stack([y / denom, -x / denom, zero], dim=-1)
    row1 = torch.stack([x * z / denom, y * z / denom, -denom], dim=-1)
    u = torch.stack([row0, row1, normal], dim=-2)

    s = 1.0 / math.sqrt(2.0)
    pole = torch.stack([
        torch.stack([torch.full_like(z, s), torch.full_like(z, -s), zero], dim=-1),
        torch.stack([z * s, z * s, zero], dim=-1),
        torch.stack([zero, zero, z], dim=-1),
    ], dim=-2)
    at_pole = ((z**2 - 1.0).abs() < 1e-4)[..., None, None]
    return torch.where(at_pole, pole, u)


def to_tangent_frame(points: torch.Tensor, normal: torch.Tensor):
    """``P -> P' = U (P + (P.N) N)``: ``(new_points, U, translation)``,
    everything :func:`from_tangent_frame` needs to invert it."""
    intercept = dot_last(points, normal)[..., None]
    u = spin_axis_matrix(normal)
    translation = intercept * normal
    shifted = points + translation
    return dot_last(u, shifted[..., None, :]), u, translation


def from_tangent_frame(new_points: torch.Tensor, u: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """``P = U^T P' - (P.N) N``, the inverse of :func:`to_tangent_frame`."""
    return dot_last(u.transpose(-1, -2), new_points[..., None, :]) - translation
