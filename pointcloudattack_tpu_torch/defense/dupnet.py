"""DUP-Net: SOR, then the PU-Net upsampler.

Counterpart of ``pointcloudattack_tpu/defense/dupnet.py`` (reference
attack/SIadv/baselines/defense/DUP_Net/DUP_Net.py:14-34: ``sor_k=2``,
``sor_alpha=1.1``, ``npoint=1024``, ``up_ratio=4``).  The reference loads
its trained upsampler from ``pu-in_1024-up_4.pth``; its state dict loads
into ``DUPNet.punet`` strictly (``train/weights.py::load_checkpoint``).
"""

from __future__ import annotations

import torch
from torch import nn

from pointcloudattack_tpu_torch.defense.sor import sor_defense
from pointcloudattack_tpu_torch.models.punet import PUNet


class DUPNet(nn.Module):
    """``[B, N, 3] -> [B, npoint * up_ratio, 3]``."""

    def __init__(self, sor_k: int = 2, sor_alpha: float = 1.1, npoint: int = 1024, up_ratio: int = 4):
        super().__init__()
        self.sor_k, self.sor_alpha, self.npoint = sor_k, sor_alpha, npoint
        self.punet = PUNet(npoint=npoint, up_ratio=up_ratio)

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        return self.punet(sor_defense(pc, k=self.sor_k, alpha=self.sor_alpha, npoint=self.npoint))
