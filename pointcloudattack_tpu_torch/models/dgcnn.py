"""Dynamic Graph CNN classifier.

Counterpart of ``pointcloudattack_tpu/models/dgcnn.py`` (reference
model/dgcnn.py): four EdgeConv stages, each rebuilding a kNN graph in
feature space (k=20) over the edge features ``[x_j - x_i, x_i]``, a
per-edge 1x1 convolution + BatchNorm + LeakyReLU(0.2) and a max over the
neighbours (64, 64, 128, 256 channels); then ``conv5`` to 1024 channels,
global max and mean pools, and the LeakyReLU head 512-256-k with dropout,
ending in log-softmax.  Submodules carry the reference state-dict names
(``conv1.0`` ... ``conv5.0``, ``bn1`` ... ``bn7``, ``linear1`` ...
``linear3``), so a state dict in that layout loads strictly.

In eval mode an EdgeConv runs the kNN (``ops/knn.py``) and then one fused
gather + layer + max over the neighbours (``ops/gather_chain.py``, layout
``diff, center`` on ``src = centers = x``), with the LeakyReLU on the
pooled output, where it commutes with the max: on a CUDA tensor the
one-layer route's kernels (``ops/gather_hoist.py``: the layer once a
point, a backward without atomics), on a CPU tensor the plain versions.
In train mode it runs unfused over the ``[B, N, k, 2C]`` edge tensor.  The
gather is exact f32: the JAX package's bf16 limb gathers exist only for
the TPU's matrix unit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudattack_tpu_torch.models.common import PointConv, batch_norm, bn_mul, init_parameters
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.gather_chain import gather_chain_groupmax
from pointcloudattack_tpu_torch.ops.knn import knn

SLOPE = 0.2


def graph_feature(x: torch.Tensor, k: int, idx: torch.Tensor | None = None) -> torch.Tensor:
    """Edge features of the kNN graph, ``[B, N, k, 2C]``: ``[x_j - x_i,
    x_i]`` over each point's ``k`` nearest (``idx``, or ``knn(x, k)``),
    self included."""
    if idx is None:
        idx = knn(x, k)
    nbr = index_points(x, idx)  # [B, N, k, C]
    ctr = x[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=-1)


class EdgeConv:
    """kNN graph -> per-edge 1x1 conv (no bias) + BN + LeakyReLU -> max over
    the neighbours, over a ``(conv, bn)`` pair that the owning module
    registers under the reference names.  A plain callable, like
    ``PointMLP``, so it adds no prefix to them."""

    def __init__(self, conv: PointConv, bn: nn.BatchNorm1d, k: int):
        self.conv, self.bn, self.k = conv, bn, k

    def fused_layer(self):
        """``(w [2C, out], b = 0, mean, mul, beta)`` for the gather kernel."""
        bn = self.bn
        return (self.conv.kernel(), torch.zeros_like(bn.running_mean), bn.running_mean, bn_mul(bn), bn.bias)

    def unfused(self, x: torch.Tensor, idx: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The layer over the ``[B, N, k, 2C]`` edge tensor, then the max."""
        h = batch_norm(self.conv(graph_feature(x, self.k, idx)), self.bn, train)
        return F.leaky_relu(h, SLOPE).amax(dim=2)

    def __call__(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        idx = knn(x, self.k)
        if train:
            return self.unfused(x, idx, train=True)
        c = x.shape[-1]
        layout = (("diff", 0, c, 0), ("center", 0, c))
        return F.leaky_relu(gather_chain_groupmax(x, x, idx, [self.fused_layer()], layout), SLOPE)


class DGCNN(nn.Module):
    """DGCNN classifier; ``forward(x [B, N, 3]) -> (log_probs [B, K], {})``.
    Defaults follow the reference: k=20, emb_dims=1024, dropout 0.5."""

    def __init__(self, num_classes: int = 40, k: int = 20, emb_dims: int = 1024, dropout: float = 0.5):
        super().__init__()
        self.k = k
        widths = ((3, 64), (64, 64), (64, 128), (128, 256))
        for i, (cin, cout) in enumerate(widths, start=1):
            setattr(self, f"conv{i}", nn.Sequential(PointConv(2 * cin, cout, spatial=2, bias=False)))
            setattr(self, f"bn{i}", nn.BatchNorm1d(cout))
        self.edges = [EdgeConv(getattr(self, f"conv{i}")[0], getattr(self, f"bn{i}"), k) for i in range(1, 5)]
        self.conv5 = nn.Sequential(PointConv(512, emb_dims, spatial=1, bias=False))
        self.bn5 = nn.BatchNorm1d(emb_dims)
        self.linear1 = nn.Linear(2 * emb_dims, 512, bias=False)
        self.bn6 = nn.BatchNorm1d(512)
        self.dp1 = nn.Dropout(dropout)
        self.linear2 = nn.Linear(512, 256)
        self.bn7 = nn.BatchNorm1d(256)
        self.dp2 = nn.Dropout(dropout)
        self.linear3 = nn.Linear(256, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw all weights from ``generator``."""
        init_parameters(self, generator)

    def forward(self, x: torch.Tensor):
        feats = []
        for edge in self.edges:
            x = edge(x, self.training)
            feats.append(x)
        h = batch_norm(self.conv5(torch.cat(feats, dim=-1)), self.bn5, self.training)
        h = F.leaky_relu(h, SLOPE)  # [B, N, emb]
        g = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        g = self.dp1(F.leaky_relu(batch_norm(self.linear1(g), self.bn6, self.training), SLOPE))
        g = self.dp2(F.leaky_relu(batch_norm(self.linear2(g), self.bn7, self.training), SLOPE))
        return torch.log_softmax(self.linear3(g), dim=-1), {}
