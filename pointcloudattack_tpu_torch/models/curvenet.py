"""CurveNet: curve-aggregation point-cloud classifier.

Counterpart of ``pointcloudattack_tpu/models/curvenet.py`` (reference
model/curvenet.py, curvenet_util.py, walk.py): an initial LPFA embedding,
eight CIC residual blocks (the first four, in the ``default`` setting,
walk curves over the kNN graph) and a head over the global max and mean
pools.  Channels-last ``[B, N, C]`` throughout; every 1x1 convolution is a
``PointConv`` holding the reference's weight, so the submodules carry the
reference state-dict names (``lpfa.mlp.0.0``, ``cic11.conv1.1``,
``cic21.curvegrouping.walk.agent_mlp.0``, ``conv0.0``, ``conv1``, ...).

In eval mode each LPFA runs its chain and pool over the ``[B, N, k, C]``
neighbour rows as one fused op (``ops/group_chain.py``): the initial block
a chain + max over k (``mlp_chain_groupmax``, the LeakyReLU applied to the
pooled output, where it commutes with the max), the residual blocks a
LeakyReLU chain + mean over k (``mlp_chain_groupmean``); the kernels on a
CUDA tensor, their plain versions on a CPU tensor.  With ``fused_gather``
the LPFAs gather their rows inside the kernel instead
(``ops/gather_chain.py``): the initial block as a gather + chain + max
with the layout center / pass / diff on the points themselves, the
residual blocks as a gather + chain + mean after folding ``xyz2feature``
and its BatchNorm into the gather's sources (``LPFA.fold``).  The kNN
(``ops/knn.py``) and the masked max pool's FPS (``ops/fps.py``) run their
kernels too.  In train mode the LPFAs run unfused.

As in the JAX package:
  * the straight-through softmax is ``(hard - y).detach() + y``, which is
    not exactly ``hard`` in f32;
  * the curve starts are the ``curve_num`` highest attention scores, ties
    to the lower index (``lax.top_k``): a stable descending sort;
  * ``walk_compat=True`` reproduces the reference Walk's scrambled
    momentum view (walk.py:103-105); the default is the per-curve softmax;
  * the classifier returns raw logits, not log-probs
    (``models.OUTPUT_KIND``);
  * the differentiated gathers are ``index_points``, whose backward is
    autograd's scatter-add (the JAX package's one-hot matmul backward is a
    TPU workaround).
The discrete choices of a forward (``hard_pick``, ``curve_starts``, the
max pools' ``max_pool``, the activations' ``leaky_relu``, whose input
signs pick a slope, and the fused ops ``mlp_chain_groupmean`` and
``gather_chain_groupmean``, whose activations' input signs do) are
module-level names, so that a caller can record them on one device and
replay them on another.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pointcloudattack_tpu_torch.models.common import PointConv, batch_norm, bn_mul, init_parameters
from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
from pointcloudattack_tpu_torch.ops.fps import farthest_point_sample
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.gather_chain import gather_chain_groupmax, gather_chain_groupmean
from pointcloudattack_tpu_torch.ops.group_chain import mlp_chain_groupmax, mlp_chain_groupmean
from pointcloudattack_tpu_torch.ops.knn import knn
from pointcloudattack_tpu_torch.ops.pairwise import dot_last

CURVE_CONFIG = {
    "default": [[100, 5], [100, 5], None, None],
    "long": [[10, 30], None, None, None],
}
SLOPE = 0.2
# the initial LPFA's rows [ctr_xyz, nbr_xyz, nbr_xyz - ctr_xyz] as a gather
# layout over the points themselves (sources and centers alike)
INITIAL_LAYOUT = (("center", 0, 3), ("pass", 0, 3), ("diff", 0, 3, 0))


def hard_pick(y: torch.Tensor) -> torch.Tensor:
    """Each row's first argmax over the last axis: the walk's next step."""
    return y.argmax(dim=-1)


def curve_starts(att: torch.Tensor, curve_num: int) -> torch.Tensor:
    """``att [B, N]`` -> the ``curve_num`` indices of the highest scores,
    in descending order, ties to the lower index (as ``lax.top_k``;
    ``torch.topk`` gives no tie order on the card)."""
    return torch.sort(att.detach(), dim=-1, descending=True, stable=True).indices[:, :curve_num]


def max_pool(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The max over ``dim``; its gradient splits a tie evenly, as
    ``jnp.max``'s does."""
    return x.amax(dim=dim)


def leaky_relu(x: torch.Tensor, slope: float = SLOPE) -> torch.Tensor:
    """``max(x, slope * x)``: LeakyReLU(slope), a ReLU at slope 0; its
    gradient takes slope 1 where ``x > 0`` and ``slope`` elsewhere."""
    return F.leaky_relu(x, slope)


def straight_through_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Hard one-hot forward, softmax gradients backward, over the last
    axis."""
    y = torch.softmax(logits, dim=-1)
    hard = F.one_hot(hard_pick(y), y.shape[-1]).to(y.dtype)
    return (hard - y).detach() + y


def bn_dense(cin: int, cout: int, spatial: int = 1) -> nn.Sequential:
    """A bias-free 1x1 convolution and its BatchNorm, the reference's
    ``nn.Sequential(conv, bn)`` (``<name>.0`` and ``<name>.1``)."""
    return nn.Sequential(PointConv(cin, cout, spatial=spatial, bias=False), nn.BatchNorm1d(cout))


def run_bn_dense(seq: nn.Sequential, x: torch.Tensor, train: bool, act: bool = True) -> torch.Tensor:
    """``seq`` over the last axis of ``x``, then LeakyReLU(0.2) with ``act``
    (the JAX package's ``_BNDense``)."""
    h = batch_norm(seq[0](x), seq[1], train)
    return leaky_relu(h) if act else h


class LPFA(nn.Module):
    """Local point-feature aggregation (reference curvenet_util.py:175-236).

    ``forward(x, xyz, idx=None) -> [B, N, out]``.  Each point's ``k``
    neighbour rows are ``[ctr_xyz, nbr_xyz, nbr_xyz - ctr_xyz]`` (initial)
    or ``leaky(nbr_x - x + BN(xyz2feature(those 9 columns)))`` (residual);
    then ``mlp_num`` Dense + BN + LeakyReLU layers and a max (initial) or a
    mean (residual) over the neighbours.  ``fused_gather``: in eval mode
    the rows are gathered inside the kernel (``ops/gather_chain.py``).
    """

    def __init__(self, cin: int, out: int, k: int, mlp_num: int = 2, initial: bool = False,
                 fused_gather: bool = False):
        super().__init__()
        self.k, self.initial, self.fused_gather = k, initial, fused_gather
        if not initial:
            self.xyz2feature = bn_dense(9, cin, spatial=2)
        widths = [cin] + [out] * mlp_num
        self.mlp = nn.ModuleList(bn_dense(a, b, spatial=2) for a, b in zip(widths[:-1], widths[1:]))

    def fused_layers(self):
        """``(w [in, out], b = 0, mean, mul, beta)`` per layer for the chain."""
        return [(seq[0].kernel(), torch.zeros_like(seq[1].running_mean), seq[1].running_mean, bn_mul(seq[1]),
                 seq[1].bias) for seq in self.mlp]

    def rows(self, x, xyz, idx) -> torch.Tensor:
        """The ``[B, N, k, C]`` neighbour rows the chain runs on."""
        nbr_xyz = index_points(xyz, idx)
        ctr = xyz[:, :, None, :].expand_as(nbr_xyz)
        pf = torch.cat([ctr, nbr_xyz, nbr_xyz - ctr], dim=-1)  # [B, N, k, 9]
        if self.initial:
            return pf
        diff = index_points(x, idx) - x[:, :, None, :]
        return leaky_relu(diff + run_bn_dense(self.xyz2feature, pf, self.training, act=False))

    def fold(self, x, xyz):
        """The residual rows as a gather: ``xyz2feature`` and its eval
        BatchNorm are affine in the neighbour's and the center's xyz, so
        with its weight split into the 3-row blocks Wc, Wn, Wd of ``[ctr,
        nbr, nbr - ctr]`` and the BatchNorm into ``(mul, const)``, the row
        ``diff + BN(xyz2feature(pf))`` is ``S[idx] - T`` with

            S = x + xyz @ ((Wn + Wd) * mul)
            T = x - xyz @ ((Wc - Wd) * mul) - const

        (JAX ``models/curvenet.py:201-213``).  The 3-term products are sums
        over the coordinates in order (``dot_last``), so the card and the
        CPU give the same bits.  Returns ``(S, T)``, each ``[B, N, C]``."""
        w9 = self.xyz2feature[0].kernel()  # [9, C]
        bn = self.xyz2feature[1]
        mul = bn_mul(bn)
        const = bn.bias - bn.running_mean * mul
        a_n = (w9[3:6] + w9[6:9]) * mul
        a_c = (w9[0:3] - w9[6:9]) * mul
        p = xyz[:, :, None, :]
        return x + dot_last(p, a_n.t()), x - dot_last(p, a_c.t()) - const

    def unfused(self, h: torch.Tensor) -> torch.Tensor:
        """The chain over the rows, layer by layer, then the pool."""
        for seq in self.mlp:
            h = run_bn_dense(seq, h, self.training)
        return h.amax(dim=2) if self.initial else h.mean(dim=2)

    def forward(self, x, xyz, idx=None):
        if idx is None:
            idx = knn(xyz, self.k + 1)[:, :, : self.k]
        if self.fused_gather and not self.training:
            if self.initial:
                return leaky_relu(gather_chain_groupmax(xyz, xyz, idx, self.fused_layers(), INITIAL_LAYOUT, SLOPE))
            s, t = self.fold(x, xyz)
            return gather_chain_groupmean(s, t, idx, self.fused_layers(), (("diff", 0, x.shape[-1], 0),), SLOPE, True)
        h = self.rows(x, xyz, idx)
        if self.training:
            return self.unfused(h)
        if self.initial:
            return leaky_relu(mlp_chain_groupmax(h, self.fused_layers(), SLOPE))
        return mlp_chain_groupmean(h, self.fused_layers(), SLOPE)


class Walk(nn.Module):
    """Guided walk on the kNN graph (reference model/walk.py:35-152):
    ``forward(xyz, x, adj, start) -> [B, curve_num, curve_length, C]``.
    ``agent_mlp`` scores a curve's ``k`` candidate next points each step;
    ``momentum_mlp`` blends the curve state from the second step on."""

    def __init__(self, c: int, k: int, curve_num: int, curve_length: int, momentum_compat: bool = False):
        super().__init__()
        self.k, self.curve_num, self.curve_length = k, curve_num, curve_length
        self.momentum_compat = momentum_compat
        self.agent_mlp = bn_dense(2 * c, 1, spatial=2)
        self.momentum_mlp = bn_dense(2 * c, 2)

    def forward(self, xyz, x, adj, start):
        b, _, c = x.shape
        train = self.training
        cur_idx = start  # [B, cn]
        pre_feature = index_points(x, cur_idx)  # [B, cn, C]
        cur_feature = None
        steps = []
        for step in range(self.curve_length):
            if step > 0:
                cat = torch.cat([cur_feature, pre_feature], dim=-1)
                att = torch.softmax(run_bn_dense(self.momentum_mlp, cat, train, act=False), dim=-1)
                if self.momentum_compat:
                    # reference walk.py:103-105: curve m reads flat positions
                    # 2m and 2m+1 of the row-major [2, cn] softmax
                    att = att.transpose(1, 2).reshape(b, self.curve_num, 2)
                pre_feature = att[..., 0:1] * cur_feature + att[..., 1:2] * pre_feature
            pick_idx = index_points(adj, cur_idx)  # [B, cn, k] neighbour ids
            pick_values = index_points(x, pick_idx.reshape(b, -1)).reshape(b, self.curve_num, self.k, c)
            pre_exp = pre_feature[:, :, None, :].expand_as(pick_values)
            score = run_bn_dense(self.agent_mlp, torch.cat([pick_values, pre_exp], dim=-1), train,
                                 act=False)[..., 0]  # [B, cn, k]
            if step > 0:
                # crossover suppression (reference walk.py:57-72)
                v_walk = (cur_feature - pre_feature).detach()
                v_next = (pick_values - cur_feature[:, :, None, :]).detach()
                dot = (v_walk[:, :, None, :] * v_next).sum(dim=-1)
                denom = torch.clamp(v_walk.norm(dim=-1)[:, :, None] * v_next.norm(dim=-1), min=1e-8)
                score = score * torch.clamp(1.0 + dot / denom, 0.0, 1.0)
            w = straight_through_softmax(score)  # [B, cn, k]
            cur_feature = (pick_values * w[..., None]).sum(dim=2)
            choice = w.argmax(dim=-1)
            cur_idx = pick_idx.gather(-1, choice[..., None])[..., 0]
            steps.append(cur_feature)
        return torch.stack(steps, dim=2)


class CurveAggregation(nn.Module):
    """Inter- and intra-curve attention feature update (reference
    curvenet_util.py:379-437): ``forward(x [B, N, C], curves [B, cn, cl, C])
    -> [B, N, C]``."""

    def __init__(self, c: int):
        super().__init__()
        mid = c // 2
        for name in ("conva", "convb", "convc"):
            setattr(self, name, PointConv(c, mid, bias=False))
        self.convn = PointConv(mid, mid, bias=False)
        self.convl = PointConv(mid, mid, bias=False)
        self.convd = bn_dense(2 * mid, c)
        self.line_conv_att = PointConv(c, 1, spatial=2, bias=False)

    def forward(self, x, curves):
        att = self.line_conv_att(curves)  # [B, cn, cl, 1]
        inter = (curves * torch.softmax(att, dim=2)).sum(dim=2)  # [B, cn, C]
        intra = (curves * torch.softmax(att, dim=1)).sum(dim=1)  # [B, cl, C]
        inter_a, intra_b, xl = self.conva(inter), self.convb(intra), self.convc(x)
        w_inter = torch.softmax(torch.einsum("bnm,bcm->bnc", xl, inter_a), dim=-1)  # [B, N, cn]
        w_intra = torch.softmax(torch.einsum("bnm,blm->bnl", xl, intra_b), dim=-1)  # [B, N, cl]
        f_inter = torch.einsum("bnc,bcm->bnm", w_inter, self.convn(inter_a))
        f_intra = torch.einsum("bnl,blm->bnm", w_intra, self.convl(intra_b))
        upd = run_bn_dense(self.convd, torch.cat([f_inter, f_intra], dim=-1), self.training, act=False)
        return leaky_relu(x + upd)


class CurveGrouping(nn.Module):
    """Curve starts by sigmoid attention, then the walk (reference
    curvenet_util.py:440-466)."""

    def __init__(self, c: int, k: int, curve_num: int, curve_length: int, momentum_compat: bool = False):
        super().__init__()
        self.curve_num = curve_num
        self.att = PointConv(c, 1, bias=False)
        self.walk = Walk(c, k, curve_num, curve_length, momentum_compat)

    def forward(self, x, xyz, adj):
        att = torch.sigmoid(self.att(x))  # [B, N, 1]
        start = curve_starts(att[..., 0], self.curve_num)
        return self.walk(xyz, x * att, adj, start)


class MaskedMaxPool(nn.Module):
    """FPS to ``npoint`` centres, a ball query of ``k`` and the features' max
    over each ball (reference curvenet_util.py:469-485)."""

    def __init__(self, npoint: int, radius: float, k: int):
        super().__init__()
        self.npoint, self.radius, self.k = npoint, radius, k

    def forward(self, xyz, feats):
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
        idx = query_ball_point(self.radius, self.k, xyz, new_xyz)
        return new_xyz, max_pool(index_points(feats, idx), 2)


class CIC(nn.Module):
    """Curve-intervention-convolution residual block (reference
    curvenet_util.py:303-376): ``forward(xyz, x) -> (xyz, x)``, subsampled to
    ``npoint`` first when the cloud is larger."""

    def __init__(self, npoint, radius, k, cin, cout, bottleneck_ratio=2, mlp_num=2, curve_cfg=None,
                 momentum_compat=False, fused_gather=False):
        super().__init__()
        self.npoint, self.k, self.curves = npoint, k, curve_cfg is not None
        planes = cin // bottleneck_ratio
        self.conv1 = bn_dense(cin, planes)
        if self.curves:
            self.curvegrouping = CurveGrouping(planes, k, curve_cfg[0], curve_cfg[1], momentum_compat)
            self.curveaggregation = CurveAggregation(planes)
        self.lpfa = LPFA(planes, planes, k, mlp_num=mlp_num, fused_gather=fused_gather)
        self.conv2 = bn_dense(planes, cout)
        self.shortcut = bn_dense(cin, cout) if cin != cout else None
        self.maxpool = MaskedMaxPool(npoint, radius, k)

    def forward(self, xyz, x):
        train = self.training
        if xyz.shape[1] != self.npoint:
            xyz, x = self.maxpool(xyz, x)
        shortcut = x
        h = run_bn_dense(self.conv1, x, train)
        idx = knn(xyz, self.k + 1)  # [B, N, k+1], the point itself first
        if self.curves:
            h = self.curveaggregation(h, self.curvegrouping(h, xyz, idx[:, :, 1:]))
        h = run_bn_dense(self.conv2, self.lpfa(h, xyz, idx[:, :, : self.k]), train, act=False)
        if self.shortcut is not None:
            shortcut = run_bn_dense(self.shortcut, shortcut, train, act=False)
        return xyz, leaky_relu(h + shortcut)


class CurveNet(nn.Module):
    """CurveNet classifier; ``forward(x [B, N, 3]) -> (logits [B, K], {})``,
    raw logits as in the reference (model/curvenet.py:11-73).  Published
    widths: k=20, the ``default`` curve setting, N=1024.  ``fused_gather``:
    the nine LPFAs' route, the grouped one unless set."""

    def __init__(self, num_classes: int = 40, k: int = 20, setting: str = "default", walk_compat: bool = False,
                 fused_gather: bool = False):
        super().__init__()
        cfg = CURVE_CONFIG[setting]
        self.lpfa = LPFA(9, 32, k, mlp_num=1, initial=True, fused_gather=fused_gather)
        blocks = (  # name, npoint, radius, in, out, bottleneck ratio, curve setting
            ("cic11", 1024, 0.05, 32, 64, 2, cfg[0]), ("cic12", 1024, 0.05, 64, 64, 4, cfg[0]),
            ("cic21", 1024, 0.05, 64, 128, 2, cfg[1]), ("cic22", 1024, 0.1, 128, 128, 4, cfg[1]),
            ("cic31", 256, 0.1, 128, 256, 2, cfg[2]), ("cic32", 256, 0.2, 256, 256, 4, cfg[2]),
            ("cic41", 64, 0.2, 256, 512, 2, cfg[3]), ("cic42", 64, 0.4, 512, 512, 4, cfg[3]),
        )
        self.blocks = [name for name, *_ in blocks]
        for name, npoint, radius, cin, cout, ratio, curve in blocks:
            setattr(self, name, CIC(npoint, radius, k, cin, cout, ratio, 1, curve, walk_compat, fused_gather))
        self.conv0 = bn_dense(512, 1024)
        self.conv1 = nn.Linear(2048, 512, bias=False)
        self.bn1 = nn.BatchNorm1d(512)
        self.dp1 = nn.Dropout(0.5)
        self.conv2 = nn.Linear(512, num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw all weights from ``generator``."""
        init_parameters(self, generator)

    def forward(self, xyz: torch.Tensor):
        train = self.training
        h = self.lpfa(None, xyz)
        for name in self.blocks:
            xyz, h = getattr(self, name)(xyz, h)
        h = leaky_relu(batch_norm(self.conv0[0](h), self.conv0[1], train), 0.0)  # [B, 64, 1024]
        g = torch.cat([max_pool(h, 1), h.mean(dim=1)], dim=-1)
        g = self.dp1(leaky_relu(batch_norm(self.conv1(g), self.bn1, train), 0.0))
        return self.conv2(g), {}
