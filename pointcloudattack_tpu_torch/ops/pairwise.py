"""All-pairs squared Euclidean distance.

Counterpart of ``pointcloudattack_tpu/ops/pairwise.py``.  The op order is
the JAX package's, ``xx - 2*xy + yy^T``, and every term is summed over
the coordinates in a fixed order, one elementwise op at a time: no GEMM
whose summation order is the library's, and no fused multiply-add.  So the
CPU and the card give the same bits, and a point near a ball's radius
falls on the same side of it on both.
"""

from __future__ import annotations

import torch


def dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_c a[..., c] * b[..., c]``, coordinates in ascending order."""
    out = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        out = out + a[..., c] * b[..., c]
    return out


def sum_neighbours(t: torch.Tensor) -> torch.Tensor:
    """``t [B, N, k, ...]`` summed over ``k`` in ascending order."""
    out = t[:, :, 0]
    for j in range(1, t.shape[2]):
        out = out + t[:, :, j]
    return out


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x [..., N, C]``, ``y [..., M, C]`` -> ``[..., N, M]`` squared
    distances."""
    xx = dot_last(x, x)[..., :, None]  # [..., N, 1]
    yy = dot_last(y, y)[..., None, :]  # [..., 1, M]
    xy = dot_last(x[..., :, None, :], y[..., None, :, :])  # [..., N, M]
    return xx - 2.0 * xy + yy


def first_argmin(d: torch.Tensor):
    """``(min, argmin)`` over the last axis of ``d``, ``argmin`` int32 and
    the first index attaining the minimum, on every device."""
    m = d.amin(dim=-1)
    cols = torch.arange(d.shape[-1], device=d.device, dtype=torch.int32)
    big = torch.full((), d.shape[-1], device=d.device, dtype=torch.int32)
    return m, torch.where(d == m[..., None], cols, big).amin(dim=-1)
