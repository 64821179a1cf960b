"""CW perturbation attack (CVPR'19 "Generating 3D Adversarial Point Clouds").

Counterpart of ``pointcloudattack_tpu/attacks/cw.py``: the shared engine
with the untargeted logit-margin loss (kappa 30), the per-example-weighted
global L2 distance and the per-point budget clip.
"""

from __future__ import annotations

import dataclasses

import torch

from pointcloudattack_tpu_torch.attacks.engine import CWConfig, CWResult, cw_attack
from pointcloudattack_tpu_torch.constraints.clip import clip_points_linf
from pointcloudattack_tpu_torch.losses.adv import adv_loss_fn
from pointcloudattack_tpu_torch.losses.distance import l2_dist


@dataclasses.dataclass(frozen=True)
class CWPerturbConfig(CWConfig):
    """Eval_CW.py defaults: kappa 30, budget 0.18, 10 x 500 iterations."""

    kappa: float = 30.0
    budget: float = 0.18
    adv_func: str = "logits"  # "logits" | "cross_entropy"


def build_cw_attack(model_fn, cfg: CWPerturbConfig):
    """``run(data, target, generator=None, init_noise=None) -> CWResult``
    for the plain CW attack."""
    adv_fn = adv_loss_fn(cfg.adv_func, cfg.targeted, cfg.kappa)

    clip = lambda adv, ori: clip_points_linf(adv, ori, cfg.budget)

    def run(
        data: torch.Tensor,
        target: torch.Tensor,
        generator: torch.Generator | None = None,
        init_noise: torch.Tensor | None = None,
    ) -> CWResult:
        return cw_attack(
            model_fn, data, target, cfg,
            adv_loss_fn=adv_fn, dist_loss_fn=l2_dist, clip_fn=clip,
            init_noise=init_noise, generator=generator,
        )

    return run
