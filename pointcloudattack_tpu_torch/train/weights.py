"""Weights in the reference's state-dict layout.

The port's modules carry the reference names, so a reference ``.pth`` and
the JAX package's exported variables both load with
``load_state_dict(strict=True)`` and no mapping code.

The name correspondence of each model (torch name <-> flax path) is a
``_Spec``, the port's own numpy-only copy of the one in
``pointcloudattack_tpu/train/torch_port.py``; the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    """torch.Tensor | array -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class _DenseEntry:
    torch_name: str
    flax_path: tuple
    spatial: int  # 0 = Linear, 1 = Conv1d 1x1, 2 = Conv2d 1x1


@dataclasses.dataclass(frozen=True)
class _BNEntry:
    torch_name: str
    flax_path: tuple


class _Spec:
    """Records the torch-name <-> flax-path correspondence of one model."""

    def __init__(self):
        self.entries: list = []

    def dense(self, torch_name, flax_path, kind="conv1d"):
        spatial = {"lin": 0, "conv1d": 1, "conv2d": 2}[kind]
        self.entries.append(_DenseEntry(torch_name, tuple(flax_path), spatial))

    def bn(self, torch_name, flax_path):
        self.entries.append(_BNEntry(torch_name, tuple(flax_path)))


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _apply_export(spec: _Spec, variables: Mapping) -> dict:
    """flax variables -> reference-layout numpy state_dict along the spec."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict = {}
    for e in spec.entries:
        leaf = _get(params, e.flax_path)
        if isinstance(e, _DenseEntry):
            w = _np(leaf["kernel"]).T  # [out, in]
            sd[e.torch_name + ".weight"] = w.reshape(w.shape + (1,) * e.spatial)
            if "bias" in leaf:
                sd[e.torch_name + ".bias"] = _np(leaf["bias"])
        else:
            st = _get(stats, e.flax_path)
            sd[e.torch_name + ".weight"] = _np(leaf["scale"])
            sd[e.torch_name + ".bias"] = _np(leaf["bias"])
            sd[e.torch_name + ".running_mean"] = _np(st["mean"])
            sd[e.torch_name + ".running_var"] = _np(st["var"])
            sd[e.torch_name + ".num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return sd


def _stn_spec(s: _Spec, prefix: str, path: tuple):
    for i in range(3):
        s.dense(f"{prefix}.conv{i+1}", path + ("mlp", f"dense{i}"))
        s.bn(f"{prefix}.bn{i+1}", path + ("mlp", f"bn{i}"))
    for i in range(2):
        s.dense(f"{prefix}.fc{i+1}", path + ("fc", f"dense{i}"), kind="lin")
        s.bn(f"{prefix}.bn{i+4}", path + ("fc", f"bn{i}"))
    s.dense(f"{prefix}.fc3", path + ("out",), kind="lin")


def pointnet_spec(feature_transform: bool = False) -> _Spec:
    """model/pointnet.py PointNetCls layout."""
    s = _Spec()
    _stn_spec(s, "feat.stn", ("feat", "stn"))
    if feature_transform:
        _stn_spec(s, "feat.fstn", ("feat", "fstn"))
    for i, mlp in enumerate(["mlp1", "mlp2", "mlp3"]):
        s.dense(f"feat.conv{i+1}", ("feat", mlp, "dense0"))
        s.bn(f"feat.bn{i+1}", ("feat", mlp, "bn0"))
    s.dense("fc1", ("fc1", "dense0"), kind="lin")
    s.bn("bn1", ("fc1", "bn0"))
    s.dense("fc2", ("fc2",), kind="lin")
    s.bn("bn2", ("bn2",))
    s.dense("fc3", ("fc3",), kind="lin")
    return s


def _cls_head_spec(s: _Spec):
    s.dense("fc1", ("head", "fc1", "dense0"), kind="lin")
    s.bn("bn1", ("head", "fc1", "bn0"))
    s.dense("fc2", ("head", "fc2", "dense0"), kind="lin")
    s.bn("bn2", ("head", "fc2", "bn0"))
    s.dense("fc3", ("head", "fc3"), kind="lin")


def pointnet2_ssg_spec() -> _Spec:
    """model/pointnet2_SSG.py PointNet_Ssg layout."""
    s = _Spec()
    for k in range(1, 4):
        for i in range(3):
            s.dense(f"sa{k}.mlp_convs.{i}", (f"sa{k}", "mlp", f"dense{i}"), kind="conv2d")
            s.bn(f"sa{k}.mlp_bns.{i}", (f"sa{k}", "mlp", f"bn{i}"))
    _cls_head_spec(s)
    return s


def pointnet2_msg_spec() -> _Spec:
    """model/pointnet2_MSG.py PointNet_Msg layout."""
    s = _Spec()
    for k in (1, 2):  # MSG layers with 3 branches x 3 convs
        for br in range(3):
            for i in range(3):
                s.dense(
                    f"sa{k}.conv_blocks.{br}.{i}", (f"sa{k}", f"branch{br}", f"dense{i}"),
                    kind="conv2d",
                )
                s.bn(f"sa{k}.bn_blocks.{br}.{i}", (f"sa{k}", f"branch{br}", f"bn{i}"))
    for i in range(3):  # final group-all SA
        s.dense(f"sa3.mlp_convs.{i}", ("sa3", "mlp", f"dense{i}"), kind="conv2d")
        s.bn(f"sa3.mlp_bns.{i}", ("sa3", "mlp", f"bn{i}"))
    _cls_head_spec(s)
    return s


def dgcnn_spec() -> _Spec:
    """model/dgcnn.py DGCNN layout (the EdgeConv BatchNorms at ``bnK``)."""
    s = _Spec()
    for k in range(1, 5):
        s.dense(f"conv{k}.0", (f"conv{k}", "Dense_0"), kind="conv2d")
        s.bn(f"bn{k}", (f"conv{k}", "BatchNorm_0"))
    s.dense("conv5.0", ("conv5",))
    s.bn("bn5", ("bn5",))
    s.dense("linear1", ("linear1",), kind="lin")
    s.bn("bn6", ("bn6",))
    s.dense("linear2", ("linear2",), kind="lin")
    s.bn("bn7", ("bn7",))
    s.dense("linear3", ("linear3",), kind="lin")
    return s


def punet_spec(up_ratio: int = 4) -> _Spec:
    """DUP_Net/pu_net.py PUNet layout (``pu-in_1024-up_4.pth``), no BN: the
    four set abstractions (``SA_modules.K.mlps.0.layerI.conv``), the three
    feature propagations (``FP_Modules.K.mlp.layer0.conv``), ``up_ratio``
    expansion branches (``FC_Modules.K.layerI.conv``) and the coordinate
    head (``pcd_layer.{0,1}.layer0.conv``), every one a Conv2d 1x1."""
    s = _Spec()
    mlps = [[32, 32, 64], [64, 64, 128], [128, 128, 256], [256, 256, 512]]
    for k, mlp in enumerate(mlps):
        for i in range(len(mlp)):
            s.dense(f"SA_modules.{k}.mlps.0.layer{i}.conv", (f"sa{k}", "mlp", f"dense{i}"), kind="conv2d")
    for k in range(3):
        s.dense(f"FP_Modules.{k}.mlp.layer0.conv", (f"fp{k}", "dense0"), kind="conv2d")
    for k in range(up_ratio):
        for i in range(2):
            s.dense(f"FC_Modules.{k}.layer{i}.conv", (f"expand{k}", f"dense{i}"), kind="conv2d")
    s.dense("pcd_layer.0.layer0.conv", ("recon0", "dense0"), kind="conv2d")
    s.dense("pcd_layer.1.layer0.conv", ("recon1",), kind="conv2d")
    return s


# CIC blocks of model/curvenet.py:21-39: (name, in_ch, out_ch, stage);
# curve_config (model/curvenet.py:5-8) runs curves in stages 1-2 for
# 'default' and only in stage 1 for 'long'.
_CURVENET_CICS = [
    ("cic11", 32, 64, 0),
    ("cic12", 64, 64, 0),
    ("cic21", 64, 128, 1),
    ("cic22", 128, 128, 1),
    ("cic31", 128, 256, 2),
    ("cic32", 256, 256, 2),
    ("cic41", 256, 512, 3),
    ("cic42", 512, 512, 3),
]
_CURVENET_HAS_CURVE = {"default": (True, True, False, False),
                       "long": (True, False, False, False)}


def curvenet_spec(setting: str = "default") -> _Spec:
    """model/curvenet.py CurveNet layout: 1x1 convs wrapped with their
    BatchNorm in ``nn.Sequential`` (``<mod>.0`` / ``<mod>.1``), the Walk's
    MLPs at ``cicXY.curvegrouping.walk.{agent,momentum}_mlp``."""
    s = _Spec()
    s.dense("lpfa.mlp.0.0", ("lpfa", "mlp0", "Dense_0"), kind="conv2d")
    s.bn("lpfa.mlp.0.1", ("lpfa", "mlp0", "BatchNorm_0"))
    has_curve = _CURVENET_HAS_CURVE[setting]
    for name, cin, cout, stage in _CURVENET_CICS:
        s.dense(f"{name}.conv1.0", (name, "conv1", "Dense_0"))
        s.bn(f"{name}.conv1.1", (name, "conv1", "BatchNorm_0"))
        if has_curve[stage]:
            cg, walk = (name, "curvegrouping"), f"{name}.curvegrouping.walk"
            s.dense(f"{name}.curvegrouping.att", cg + ("att",))
            s.dense(f"{walk}.agent_mlp.0", cg + ("walk", "agent_mlp", "Dense_0"), kind="conv2d")
            s.bn(f"{walk}.agent_mlp.1", cg + ("walk", "agent_mlp", "BatchNorm_0"))
            s.dense(f"{walk}.momentum_mlp.0", cg + ("walk", "momentum_mlp", "Dense_0"))
            s.bn(f"{walk}.momentum_mlp.1", cg + ("walk", "momentum_mlp", "BatchNorm_0"))
            ca = (name, "curveaggregation")
            for conv in ("conva", "convb", "convc", "convn", "convl"):
                s.dense(f"{name}.curveaggregation.{conv}", ca + (conv,))
            s.dense(f"{name}.curveaggregation.convd.0", ca + ("convd",))
            s.bn(f"{name}.curveaggregation.convd.1", ca + ("convd_bn",))
            s.dense(f"{name}.curveaggregation.line_conv_att", ca + ("line_conv_att",), kind="conv2d")
        s.dense(f"{name}.lpfa.xyz2feature.0", (name, "lpfa", "xyz2feature"), kind="conv2d")
        s.bn(f"{name}.lpfa.xyz2feature.1", (name, "lpfa", "xyz2feature_bn"))
        s.dense(f"{name}.lpfa.mlp.0.0", (name, "lpfa", "mlp0", "Dense_0"), kind="conv2d")
        s.bn(f"{name}.lpfa.mlp.0.1", (name, "lpfa", "mlp0", "BatchNorm_0"))
        s.dense(f"{name}.conv2.0", (name, "conv2", "Dense_0"))
        s.bn(f"{name}.conv2.1", (name, "conv2", "BatchNorm_0"))
        if cin != cout:
            s.dense(f"{name}.shortcut.0", (name, "shortcut", "Dense_0"))
            s.bn(f"{name}.shortcut.1", (name, "shortcut", "BatchNorm_0"))
    s.dense("conv0.0", ("conv0",))
    s.bn("conv0.1", ("bn0",))
    s.dense("conv1", ("conv1",), kind="lin")
    s.bn("bn1", ("bn1",))
    s.dense("conv2", ("conv2",), kind="lin")
    return s


SPECS = {
    "PointNet": pointnet_spec,
    "PointNet++Ssg": pointnet2_ssg_spec,
    "PointNet++Msg": pointnet2_msg_spec,
    "DGCNN": dgcnn_spec,
    "CurveNet": curvenet_spec,
    "PUNet": punet_spec,
}


def state_dict_from_flax(model_name: str, variables: Mapping, **kw) -> dict[str, torch.Tensor]:
    """The JAX model's variables (numpy arrays) -> the port's state dict.

    ``model_name`` is a key of ``SPECS``; ``kw`` goes to its spec
    (``feature_transform`` for PointNet, ``setting`` for CurveNet,
    ``up_ratio`` for PUNet).
    """
    if model_name not in SPECS:
        raise KeyError(f"no weight spec for {model_name!r}; choose from {sorted(SPECS)}")
    sd = _apply_export(SPECS[model_name](**kw), variables)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}  # writable copies


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` state dict, on the CPU, with any
    ``DataParallel`` ``module.`` prefixes stripped."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k.removeprefix("module."): v for k, v in sd.items()}
