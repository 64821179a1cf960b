"""PointNet classifier with spatial transformer(s).

Counterpart of ``pointcloudattack_tpu/models/pointnet.py``: channels-last
``[B, N, 3]`` input, per-point layers as matmuls, global max pool over the
points.  Submodules carry the reference state-dict names
(``feat.stn.conv1``, ``feat.bn1``, ``fc3``, ...), so a reference-layout
state dict loads with ``load_state_dict(strict=True)`` as it is.

In eval mode each spine (the STN's 3 -> 64 -> 128 -> 1024 and the
feature spine's) runs as one fused chain with its max pool
(``ops/chain_maxpool.py``).  The STN applies ReLU after its pool; the
feature spine does not.
"""

from __future__ import annotations

import torch
from torch import nn

from pointcloudattack_tpu_torch.models.common import (
    PointConv,
    PointMLP,
    batch_norm,
    init_parameters,
    relu,
)


class STN(nn.Module):
    """Spatial transformer predicting a ``k x k`` alignment matrix."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.k = k
        self.conv1 = PointConv(k, 64)
        self.conv2 = PointConv(64, 128)
        self.conv3 = PointConv(128, 1024)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, k * k)
        for i, c in enumerate((64, 128, 1024, 512, 256), start=1):
            self.add_module(f"bn{i}", nn.BatchNorm1d(c))
        self.mlp = PointMLP(
            [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)],
            pool_max=True,
        )
        self.fc = PointMLP([(self.fc1, self.bn4), (self.fc2, self.bn5)])
        self.zero_transform_()

    def zero_transform_(self) -> None:
        """Start at the identity transform (the JAX model's zero init)."""
        with torch.no_grad():
            self.fc3.weight.zero_()
            self.fc3.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mlp(x, self.training)  # [B, 1024]
        h = self.fc(h, self.training)
        mat = self.fc3(h)
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(1, -1)
        return (mat + eye).reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    """Global PointNet feature extractor: ``(feat [B, 1024], trans,
    trans_feat)``."""

    def __init__(self, feature_transform: bool = False):
        super().__init__()
        self.feature_transform = feature_transform
        self.stn = STN(3)
        self.conv1 = PointConv(3, 64)
        self.conv2 = PointConv(64, 128)
        self.conv3 = PointConv(128, 1024)
        self.bn1 = nn.BatchNorm1d(64)
        self.bn2 = nn.BatchNorm1d(128)
        self.bn3 = nn.BatchNorm1d(1024)
        if feature_transform:
            self.fstn = STN(64)
        self.mlp1 = PointMLP([(self.conv1, self.bn1)])
        # conv2 -> conv3 -> max, and the whole conv1 -> conv3 -> max spine
        self.tail = PointMLP(
            [(self.conv2, self.bn2), (self.conv3, self.bn3)],
            relu_last=False, pool_max=True,
        )
        self.spine = PointMLP(
            [(self.conv1, self.bn1), *self.tail.pairs],
            relu_last=False, pool_max=True,
        )

    def forward(self, x: torch.Tensor):
        trans = self.stn(x)
        x = torch.bmm(x, trans)
        if not self.feature_transform:
            return self.spine(x, self.training), trans, None
        x = self.mlp1(x, self.training)
        trans_feat = self.fstn(x)
        x = torch.bmm(x, trans_feat)
        return self.tail(x, self.training), trans, trans_feat


class PointNetCls(nn.Module):
    """PointNet classification head: ``(log_probs [B, K], aux)``."""

    def __init__(self, num_classes: int = 2, feature_transform: bool = False):
        super().__init__()
        self.feat = PointNetFeat(feature_transform)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, num_classes)
        self.bn1 = nn.BatchNorm1d(512)
        self.bn2 = nn.BatchNorm1d(256)
        self.dropout = nn.Dropout(0.3)
        self.head = PointMLP([(self.fc1, self.bn1)])

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw all weights from ``generator``; the STNs start at the
        identity."""
        init_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, STN):
                m.zero_transform_()

    def forward(self, x: torch.Tensor):
        feat, trans, trans_feat = self.feat(x)
        h = self.head(feat, self.training)
        h = self.dropout(self.fc2(h))
        h = relu(batch_norm(h, self.bn2, self.training))
        log_probs = torch.log_softmax(self.fc3(h), dim=-1)
        return log_probs, {"trans": trans, "trans_feat": trans_feat}
