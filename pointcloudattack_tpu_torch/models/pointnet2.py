"""PointNet++ SSG / MSG classifiers.

Counterpart of ``pointcloudattack_tpu/models/pointnet2.py`` (reference
model/pointnet2_SSG.py and model/pointnet2_MSG.py): farthest point
sampling, ball query, a shared MLP over each neighbourhood and a max over
it, then a group-all set abstraction and the FC head.  Submodules carry
the reference state-dict names (``sa1.mlp_convs.0``, ``sa1.conv_blocks.0.0``,
``fc1``, ...), so a reference-layout state dict loads strictly as it is.

In eval mode each neighbourhood set abstraction runs as one fused ball
query + gather + chain + max (``ball_gather_chain_groupmax``,
``ops/gather_chain.py``; MSG once per radius), and the group-all one as
one fused chain + max-pool (``ops/chain_maxpool.py``): on a CUDA tensor
the kernels, on a CPU tensor their plain versions.  In train mode
``query_ball_point`` picks the balls (MSG's radii on one shared distance
matrix) and the layers run unfused over the grouped ``[B, S, K, C]``
tensor.  FPS starts at point 0.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointcloudattack_tpu_torch.models.common import (
    PointConv,
    PointMLP,
    batch_norm,
    init_parameters,
    relu,
)
from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
from pointcloudattack_tpu_torch.ops.fps import farthest_point_sample
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.gather_chain import gather_rows
from pointcloudattack_tpu_torch.ops.grouping import sample_and_group, sample_and_group_all
from pointcloudattack_tpu_torch.ops.pairwise import pairwise_sqdist


def _stack(cin: int, widths: Sequence[int]):
    """Conv2d-layout 1x1 convolutions and BatchNorms for ``cin -> widths``."""
    dims = [cin, *widths]
    convs = nn.ModuleList(PointConv(a, b, spatial=2) for a, b in zip(dims[:-1], dims[1:]))
    bns = nn.ModuleList(nn.BatchNorm1d(c) for c in widths)
    return convs, bns


class SetAbstraction(nn.Module):
    """Single-scale set abstraction: FPS -> ball group -> MLP -> max, or one
    group holding the whole cloud (``group_all``).  ``forward(xyz, points)``
    returns ``(new_xyz [B, S, 3], pooled [B, S, C_L])``."""

    def __init__(self, npoint: int | None, radius: float | None, nsample: int | None,
                 in_channel: int, mlp: Sequence[int], group_all: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.mlp_convs, self.mlp_bns = _stack(in_channel, mlp)
        self.mlp = PointMLP(list(zip(self.mlp_convs, self.mlp_bns)), pool_max=group_all)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None):
        if self.group_all:
            new_xyz, grouped = sample_and_group_all(xyz, points)
            # one group: the chain + max-pool over the cloud's points
            return new_xyz, self.mlp(grouped[:, 0], self.training)[:, None]
        if self.training:
            new_xyz, grouped = sample_and_group(self.npoint, self.radius, self.nsample, xyz, points)
            return new_xyz, self.mlp(grouped, train=True).amax(dim=2)
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
        # xyz minus the centroid first, features after (ops/grouping.py)
        if points is not None:
            src = torch.cat([xyz, points], dim=-1)
            layout = (("diff", 0, 3, 0), ("pass", 3, src.shape[-1]))
        else:
            src, layout = xyz, (("diff", 0, 3, 0),)
        return new_xyz, self.mlp.ball_group_max(src, new_xyz, xyz, layout, self.radius, self.nsample)


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping set abstraction: one FPS, then a ball group, an
    MLP and a max for each radius, concatenated.  The reference puts the
    features first and the xyz offsets last (model/pointnet2_MSG.py:45-52)."""

    def __init__(self, npoint: int, radius_list: Sequence[float], nsample_list: Sequence[int],
                 in_channel: int, mlp_list: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = tuple(radius_list), tuple(nsample_list)
        self.conv_blocks, self.bn_blocks = nn.ModuleList(), nn.ModuleList()
        for widths in mlp_list:
            convs, bns = _stack(in_channel + 3, widths)
            self.conv_blocks.append(convs)
            self.bn_blocks.append(bns)
        self.mlps = [PointMLP(list(zip(c, b))) for c, b in zip(self.conv_blocks, self.bn_blocks)]

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None):
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
        if points is not None:
            src = torch.cat([xyz, points], dim=-1)
            layout = (("pass", 3, src.shape[-1]), ("diff", 0, 3, 0))
        else:
            src, layout = xyz, (("diff", 0, 3, 0),)
        scales = zip(self.radius_list, self.nsample_list, self.mlps)
        if not self.training:
            outs = [mlp.ball_group_max(src, new_xyz, xyz, layout, radius, k) for radius, k, mlp in scales]
            return new_xyz, torch.cat(outs, dim=-1)
        # one distance matrix for every radius
        sqr = pairwise_sqdist(new_xyz.detach(), xyz.detach())
        outs = []
        for radius, k, mlp in scales:
            idx = query_ball_point(radius, k, xyz, new_xyz, sqr=sqr)
            outs.append(mlp(gather_rows(src, new_xyz, idx, layout), train=True).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class _ClsHead(nn.Module):
    """The shared 1024 -> 512 -> 256 -> k head with dropout, under the
    reference's top-level names (``fc1``, ``bn1``, ``fc2``, ``bn2``,
    ``fc3``); PointNet2SSG and PointNet2MSG add their set abstractions."""

    def __init__(self, num_classes: int, drop2: float):
        super().__init__()
        self.fc1 = nn.Linear(1024, 512)
        self.bn1 = nn.BatchNorm1d(512)
        self.drop1 = nn.Dropout(0.4)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = nn.BatchNorm1d(256)
        self.drop2 = nn.Dropout(drop2)
        self.fc3 = nn.Linear(256, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw all weights from ``generator``."""
        init_parameters(self, generator)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop1(relu(batch_norm(self.fc1(x), self.bn1, self.training)))
        x = self.drop2(relu(batch_norm(self.fc2(x), self.bn2, self.training)))
        return self.fc3(x)

    def classify(self, l3: torch.Tensor):
        """``(log_probs [B, K], {})`` from the group-all feature ``[B, 1, 1024]``."""
        return torch.log_softmax(self.head(l3[:, 0]), dim=-1), {}


class PointNet2SSG(_ClsHead):
    """PointNet++ single-scale grouping: SA 512/0.2/32 [64, 64, 128], SA
    128/0.4/64 [128, 128, 256], group-all SA [256, 512, 1024], FC head
    (reference model/pointnet2_SSG.py:230-254)."""

    def __init__(self, num_classes: int = 40):
        super().__init__(num_classes, drop2=0.4)
        self.sa1 = SetAbstraction(512, 0.2, 32, 3, [64, 64, 128])
        self.sa2 = SetAbstraction(128, 0.4, 64, 128 + 3, [128, 128, 256])
        self.sa3 = SetAbstraction(None, None, None, 256 + 3, [256, 512, 1024], group_all=True)

    def forward(self, xyz: torch.Tensor):
        l1_xyz, l1 = self.sa1(xyz, None)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        _, l3 = self.sa3(l2_xyz, l2)
        return self.classify(l3)


class PointNet2MSG(_ClsHead):
    """PointNet++ multi-scale grouping (reference model/pointnet2_MSG.py:
    194-227, without normals): MSG SA 512 at radii 0.1/0.2/0.4, MSG SA 128
    at radii 0.2/0.4/0.8, group-all SA [256, 512, 1024], FC head."""

    def __init__(self, num_classes: int = 40):
        super().__init__(num_classes, drop2=0.5)
        self.sa1 = SetAbstractionMSG(512, [0.1, 0.2, 0.4], [16, 32, 128], 0,
                                     [[32, 32, 64], [64, 64, 128], [64, 96, 128]])
        self.sa2 = SetAbstractionMSG(128, [0.2, 0.4, 0.8], [32, 64, 128], 64 + 128 + 128,
                                     [[64, 64, 128], [128, 128, 256], [128, 128, 256]])
        self.sa3 = SetAbstraction(None, None, None, 640 + 3, [256, 512, 1024], group_all=True)

    def forward(self, xyz: torch.Tensor):
        l1_xyz, l1 = self.sa1(xyz, None)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        _, l3 = self.sa3(l2_xyz, l2)
        return self.classify(l3)
