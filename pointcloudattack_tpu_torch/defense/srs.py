"""SRS: simple random sampling.

Counterpart of ``pointcloudattack_tpu/defense/srs.py`` (reference
attack/SIadv/baselines/defense/drop_points/SRS.py:23-39): ``drop_num``
random points of each cloud are dropped, without replacement.  The draw is
``srs_draw``, a module-level function that takes an explicit generator.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.gather import index_points


def srs_draw(pc: torch.Tensor, keep: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """``[B, keep]`` int64: per cloud of ``pc [B, N, 3]``, ``keep`` distinct
    indices in a random order (the first ``keep`` of a random permutation)
    from ``generator``, on ``pc``'s device."""
    b, n, _ = pc.shape
    u = torch.rand((b, n), generator=generator, device=pc.device)
    return torch.sort(u, dim=1, stable=True).indices[:, :keep]


def srs_defense(pc: torch.Tensor, generator: torch.Generator | None = None, drop_num: int = 500) -> torch.Tensor:
    """``pc [B, N, 3]`` -> ``[B, N - drop_num, 3]``, the kept points in the
    draw's order."""
    return index_points(pc, srs_draw(pc, pc.shape[1] - drop_num, generator))
