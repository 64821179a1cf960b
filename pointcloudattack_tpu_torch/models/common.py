"""Shared model building blocks.

Counterpart of ``pointcloudattack_tpu/models/common.py``.  Inputs are
channels-last ``[B, N, C]``, so every per-point layer is a matmul over the
last axis.  The reference's 1x1 convolutions keep their ``[out, in, 1]``
weight (``PointConv``), so reference state dicts load as they are, but no
convolution runs: cuDNN would compute an f32 convolution in TF32.
BatchNorm follows torch defaults (eps 1e-5, momentum 0.1).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudattack_tpu_torch.ops.chain_maxpool import mlp_chain_maxpool
from pointcloudattack_tpu_torch.ops.gather_chain import ball_gather_chain_groupmax


def relu(x: torch.Tensor) -> torch.Tensor:
    """The ReLU after a fused max pool, between the unfused layers of a
    ``PointMLP`` and in PointNet's head: a module-level name, so that a
    caller can record the signs of its input on one device and replay them
    on another."""
    return torch.relu(x)


class PointConv(nn.Module):
    """Per-point linear layer holding a 1x1 convolution's weight, Conv1d
    layout ``[out, in, 1]`` (``spatial=1``) or Conv2d layout ``[out, in, 1,
    1]`` (``spatial=2``), computed as ``x @ W^T + b`` over the last axis of
    ``x`` (``x @ W^T`` without ``bias``)."""

    def __init__(self, cin: int, cout: int, spatial: int = 1, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + (1,) * spatial))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        bound = 1.0 / math.sqrt(cin)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound)
            if bias:
                self.bias.uniform_(-bound, bound)

    def kernel(self) -> torch.Tensor:
        """The weight as a ``[in, out]`` matrix (a view)."""
        return self.weight.flatten(1).t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel()
        return y if self.bias is None else y + self.bias


def bn_mul(bn: nn.BatchNorm1d) -> torch.Tensor:
    """Folded eval-mode scale ``rsqrt(var + eps) * scale``."""
    return torch.rsqrt(bn.running_var + bn.eps) * bn.weight


def batch_norm(z: torch.Tensor, bn: nn.BatchNorm1d, train: bool) -> torch.Tensor:
    """BatchNorm over the last axis of ``z [..., C]``.

    Eval computes ``(z - mean) * mul + bias`` in the reference's op order;
    train normalises with the batch statistics of every leading position
    and updates the running statistics.
    """
    if not train:
        return (z - bn.running_mean) * bn_mul(bn) + bn.bias
    c = z.shape[-1]
    out = F.batch_norm(
        z.reshape(-1, c), bn.running_mean, bn.running_var, bn.weight,
        bn.bias, True, bn.momentum, bn.eps,
    )
    bn.num_batches_tracked.add_(1)
    return out.reshape(z.shape)


class PointMLP:
    """A stack of per-point Linear+BN+ReLU layers (the reference's 1x1
    convolutions), over ``(linear, bn)`` pairs that the owning module
    registers under the reference's state-dict names; a pooled stack's
    linears are ``PointConv``s.

    It is a plain callable, not an ``nn.Module``, so it adds no prefix to
    those names.  With ``pool_max`` the last layer's output is max-pooled
    over the point axis (axis 1) to ``[B, C]``; ``relu_last`` applies after
    the pool (ReLU and max commute).  In eval mode a pooled ``[B, N, C]``
    input runs the whole stack as one fused chain (``mlp_chain_maxpool``:
    the kernel on a CUDA tensor, its plain version on a CPU tensor); in
    train mode the layers run unfused.  ``ball_group_max`` runs the stack
    over radius balls with a max over each ball (eval mode).
    """

    def __init__(
        self,
        pairs: Sequence[tuple[nn.Module, nn.BatchNorm1d]],
        relu_last: bool = True,
        pool_max: bool = False,
    ):
        self.pairs = tuple(pairs)
        self.relu_last = relu_last
        self.pool_max = pool_max

    def fused_layers(self) -> list[tuple[torch.Tensor, ...]]:
        """``(w [in, out], b, mean, mul, beta)`` per layer for the chain;
        ``w`` is a transposed view of the module's ``[out, in]`` weight,
        the layout the backward kernel reads."""
        return [
            (conv.kernel(), conv.bias, bn.running_mean, bn_mul(bn), bn.bias)
            for conv, bn in self.pairs
        ]

    def ball_group_max(self, src, centers, xyz, layout, radius: float, nsample: int) -> torch.Tensor:
        """The stack over each ball's rows, then the max over the ball:
        ``[B, G, C_L]``.  The balls are ``query_ball_point``'s, of ``xyz [B,
        N, 3]`` around ``centers[..., :3]``; the rows are built from ``src
        [B, N, Cs]`` and ``centers [B, G, Cc]`` by ``layout`` (see
        ``ops/gather_chain.py``).  The ball query, the gather, the stack and
        the max run as one fused op (``ball_gather_chain_groupmax``: the
        kernel on a CUDA tensor, its plain version on a CPU tensor); eval
        mode only."""
        y = ball_gather_chain_groupmax(src, centers, xyz, self.fused_layers(), layout, radius, nsample)
        return relu(y) if self.relu_last else y

    def __call__(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.pool_max and not train and x.dim() == 3:
            y = mlp_chain_maxpool(x, self.fused_layers())
            return relu(y) if self.relu_last else y
        n = len(self.pairs)
        for i, (lin, bn) in enumerate(self.pairs):
            last = i == n - 1
            x = batch_norm(lin(x), bn, train)
            if last and self.pool_max:
                x = x.amax(dim=1)
            if self.relu_last or not last:
                x = relu(x)
        return x


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """``|| T T^t - I ||_F`` penalty, mean over the batch."""
    d = trans.shape[-1]
    eye = torch.eye(d, dtype=trans.dtype, device=trans.device)
    ttt = torch.bmm(trans, trans.transpose(1, 2))
    return torch.linalg.matrix_norm(ttt - eye[None]).mean()


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every linear weight and bias from ``generator`` with PyTorch's
    default distribution, U(+-1/sqrt(fan_in)), and reset every BatchNorm."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (PointConv, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight.shape[1])
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
