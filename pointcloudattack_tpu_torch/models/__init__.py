"""Victim models.

All models share the JAX package's calling convention:
``log_probs, aux = model(x)`` with ``x`` channels-last ``[B, N, 3]``
(CurveNet returns raw logits, as the reference does: see ``OUTPUT_KIND``).
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.models.common import feature_transform_regularizer
from pointcloudattack_tpu_torch.models.curvenet import CurveNet
from pointcloudattack_tpu_torch.models.dgcnn import DGCNN, EdgeConv
from pointcloudattack_tpu_torch.models.pointnet import PointNetCls, PointNetFeat, STN
from pointcloudattack_tpu_torch.models.pointnet2 import (
    PointNet2MSG,
    PointNet2SSG,
    SetAbstraction,
    SetAbstractionMSG,
)

MODEL_REGISTRY = {
    "PointNet": lambda num_classes, **kw: PointNetCls(num_classes=num_classes, **kw),
    "PointNet++Ssg": lambda num_classes, **kw: PointNet2SSG(num_classes=num_classes, **kw),
    "PointNet++Msg": lambda num_classes, **kw: PointNet2MSG(num_classes=num_classes, **kw),
    "DGCNN": lambda num_classes, **kw: DGCNN(num_classes=num_classes, **kw),
    "CurveNet": lambda num_classes, **kw: CurveNet(num_classes=num_classes, **kw),
}

# Whether the model's first output is log-probs or raw logits.
OUTPUT_KIND = {"PointNet": "log_probs", "PointNet++Ssg": "log_probs", "PointNet++Msg": "log_probs",
               "DGCNN": "log_probs", "CurveNet": "logits"}


def make_model(
    name: str,
    num_classes: int,
    generator: torch.Generator | None = None,
    **kw,
):
    """Build a model by CLI name; with ``generator``, draw its weights from
    it (otherwise from PyTorch's global generator)."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; choose from {sorted(MODEL_REGISTRY)}")
    model = MODEL_REGISTRY[name](num_classes, **kw)
    if generator is not None:
        model.reset_parameters(generator)
    return model


__all__ = [
    "MODEL_REGISTRY",
    "OUTPUT_KIND",
    "make_model",
    "CurveNet",
    "DGCNN",
    "EdgeConv",
    "PointNetCls",
    "PointNetFeat",
    "PointNet2MSG",
    "PointNet2SSG",
    "STN",
    "SetAbstraction",
    "SetAbstractionMSG",
    "feature_transform_regularizer",
]
