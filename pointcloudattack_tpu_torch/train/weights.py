"""Weights in the reference's state-dict layout.

The port's modules carry the reference names, so a reference ``.pth`` and
the JAX package's exported variables both load with
``load_state_dict(strict=True)`` and no mapping code.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def state_dict_from_flax(
    variables: Mapping, feature_transform: bool = False
) -> dict[str, torch.Tensor]:
    """JAX PointNet variables (numpy arrays) -> the port's state dict.

    Uses the JAX package's numpy-only exporter, imported here so that the
    port's run-time path never loads that package.
    """
    from pointcloudattack_tpu.train.torch_port import export_pointnet

    sd = export_pointnet(variables, feature_transform)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}  # writable copies


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference-layout ``.pth`` state dict, on the CPU, with any
    ``DataParallel`` ``module.`` prefixes stripped."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k.removeprefix("module."): v for k, v in sd.items()}
