"""PU-Net point-cloud upsampler (CVPR'18), the DUP-Net defense's second stage.

Counterpart of ``pointcloudattack_tpu/models/punet.py`` (reference
attack/SIadv/baselines/defense/DUP_Net/pu_net.py:8-131): four set
abstractions (``npoint``, ``npoint / 2``, ``/ 4``, ``/ 8`` centres, radii
0.05, 0.1, 0.2, 0.3, K = 32), three feature propagations of levels 2-4
back to the input points, ``up_ratio`` expansion MLPs concatenated along
the point axis, and the coordinate head.  No BatchNorm (DUP-Net builds
PU-Net with ``use_bn=False``), so every layer is a 1x1 convolution with a
bias.  Submodules carry the reference state-dict names
(``SA_modules.K.mlps.0.layerI.conv``, ``FP_Modules.K.mlp.layer0.conv``,
``FC_Modules.K.layerI.conv``, ``pcd_layer.{0,1}.layer0.conv``), so the
reference's ``pu-in_1024-up_4.pth`` loads strictly as it is.

A set abstraction is ``ops/grouping.py::sample_and_group`` (FPS, the ball
query, relative xyz first) and one fused chain + max over each group's K
rows (``ops/group_chain.py::mlp_chain_groupmax``, identity BatchNorm
vectors, ReLU between the layers): on a CUDA tensor the multi-layer group
chain kernels, on a CPU tensor their plain versions.  The trailing ReLU
commutes with the max and runs on the pooled output, as the JAX package's
fused branch does.  The per-point MLPs (feature propagation, expansion,
head) are plain products.  Every ReLU goes through this module's ``relu``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pointcloudattack_tpu_torch.models.common import PointConv, init_parameters
from pointcloudattack_tpu_torch.ops.group_chain import mlp_chain_groupmax
from pointcloudattack_tpu_torch.ops.grouping import sample_and_group
from pointcloudattack_tpu_torch.ops.interpolate import three_nn_interpolate

SA_MLPS = ((32, 32, 64), (64, 64, 128), (128, 128, 256), (256, 256, 512))
SA_RADII = (0.05, 0.1, 0.2, 0.3)
SA_NSAMPLE = 32
FP_WIDTH = 64
EXPAND = (256, 128)
HEAD = 64


def relu(x: torch.Tensor) -> torch.Tensor:
    """Every ReLU of PU-Net: a module-level name, so that a caller can
    record the signs of its input on one device and replay them on
    another."""
    return torch.relu(x)


class _Layer(nn.Module):
    """One reference ``_ConvBase`` layer without BN: ``conv``, a Conv2d 1x1."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = PointConv(cin, cout, spatial=2)


class SharedMLP(nn.Module):
    """The reference's ``SharedMLP`` without BN: layers ``layer0``,
    ``layer1``, ... of ``cin -> widths``, each followed by a ReLU unless it
    is the last and ``last_act`` is false."""

    def __init__(self, cin: int, widths: Sequence[int], last_act: bool = True):
        super().__init__()
        dims = [cin, *widths]
        self.depth, self.last_act = len(widths), last_act
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"layer{i}", _Layer(a, b))

    def convs(self) -> list[PointConv]:
        return [getattr(self, f"layer{i}").conv for i in range(self.depth)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs()):
            x = conv(x)
            if self.last_act or i < self.depth - 1:
                x = relu(x)
        return x


class PUNetSA(nn.Module):
    """PU-Net set abstraction: FPS -> ball group -> MLP -> max over each
    group, ``forward(xyz, feats) -> (new_xyz [B, S, 3], [B, S, C_L])``."""

    def __init__(self, npoint: int, radius: float, nsample: int, cin: int, mlp: Sequence[int]):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlps = nn.ModuleList([SharedMLP(cin, mlp)])

    def fused_layers(self):
        """``(w [in, out], b, mean, mul, beta)`` per layer, BatchNorm the identity."""
        layers = []
        for conv in self.mlps[0].convs():
            zero = conv.bias.new_zeros(conv.bias.shape)
            layers.append((conv.kernel(), conv.bias, zero, torch.ones_like(zero), zero))
        return layers

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor | None):
        new_xyz, grouped = sample_and_group(self.npoint, self.radius, self.nsample, xyz, feats)
        return new_xyz, relu(mlp_chain_groupmax(grouped, self.fused_layers()))


class _FP(nn.Module):
    """A feature propagation's MLP (``mlp.layer0.conv``, one layer of 64)."""

    def __init__(self, cin: int):
        super().__init__()
        self.mlp = SharedMLP(cin, [FP_WIDTH])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class PUNet(nn.Module):
    """Upsamples ``[B, npoint, 3] -> [B, npoint * up_ratio, 3]``."""

    def __init__(self, npoint: int = 1024, up_ratio: int = 4):
        super().__init__()
        self.npoint, self.up_ratio = npoint, up_ratio
        npoints = [npoint, npoint // 2, npoint // 4, npoint // 8]
        cins = [3] + [3 + mlp[-1] for mlp in SA_MLPS[:-1]]
        self.SA_modules = nn.ModuleList(
            PUNetSA(npoints[k], SA_RADII[k], SA_NSAMPLE, cins[k], SA_MLPS[k]) for k in range(4))
        self.FP_Modules = nn.ModuleList(_FP(SA_MLPS[k + 1][-1]) for k in range(3))
        cin = 3 + SA_MLPS[0][-1] + 3 * FP_WIDTH
        self.FC_Modules = nn.ModuleList(SharedMLP(cin, EXPAND) for _ in range(up_ratio))
        self.pcd_layer = nn.ModuleList([SharedMLP(EXPAND[-1], [HEAD]), SharedMLP(HEAD, [3], last_act=False)])

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        xyz = points[..., :3]
        l_xyz, l_feats = [xyz], [None]
        for sa in self.SA_modules:
            lx, lf = sa(l_xyz[-1], l_feats[-1])
            l_xyz.append(lx)
            l_feats.append(lf)
        # levels 2-4 back to the input points
        up = [fp(three_nn_interpolate(xyz, l_xyz[k + 2], l_feats[k + 2])) for k, fp in enumerate(self.FP_Modules)]
        feats = torch.cat([xyz, l_feats[1], *up], dim=-1)
        r = torch.cat([fc(feats) for fc in self.FC_Modules], dim=1)  # [B, up_ratio * N, 128]
        for head in self.pcd_layer:
            r = head(r)
        return r

