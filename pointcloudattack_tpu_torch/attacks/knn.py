"""kNN attack (AAAI'20 "Robust Adversarial Objects against Deep Learning
Models"): single-phase Adam, no binary search.

Counterpart of ``pointcloudattack_tpu/attacks/knn.py``: the margin loss
(kappa 30) plus the adv->ori Chamfer distance times the number of points,
Adam, then ``project_inner_clip_linf`` against the clean positions, which
stand in for the normals when none are given (the reference's default).
There is no best tracking: the final iterate is the result.
"""

from __future__ import annotations

import dataclasses

import torch

from pointcloudattack_tpu_torch.attacks.engine import adam_step
from pointcloudattack_tpu_torch.constraints.clip import project_inner_clip_linf
from pointcloudattack_tpu_torch.losses.adv import adv_loss_fn
from pointcloudattack_tpu_torch.losses.distance import chamfer_dist
from pointcloudattack_tpu_torch.losses.geometry import nn1_idx
from pointcloudattack_tpu_torch.ops.gather import index_points


@dataclasses.dataclass(frozen=True)
class KNNAttackConfig:
    attack_lr: float = 1e-2
    num_iter: int = 2500  # the reference library default
    kappa: float = 30.0
    budget: float = 0.18
    targeted: bool = False
    adv_func: str = "logits"  # "logits" | "cross_entropy"
    init_noise_scale: float = 1e-7
    # Refresh the Chamfer nearest-clean-point index every R iterations and
    # take the distance to the cached match in between; 1 is the
    # reference's per-iteration Chamfer.
    nn_refresh: int = 1


def build_knn_attack(model_fn, cfg: KNNAttackConfig):
    """``run(data, target, generator=None, init_noise=None, normals=None)
    -> (adv [B, N, 3], success [B])``.  ``init_noise`` is the unscaled
    ``[B, N, 3]`` start noise, drawn from ``generator`` when absent."""
    adv_fn = adv_loss_fn(cfg.adv_func, cfg.targeted, cfg.kappa)
    if cfg.nn_refresh < 1:
        raise ValueError(f"nn_refresh must be >= 1, got {cfg.nn_refresh} (1 = the reference's per-iteration Chamfer)")
    cache_nn = cfg.nn_refresh > 1

    def run(
        data: torch.Tensor,
        target: torch.Tensor,
        generator: torch.Generator | None = None,
        init_noise: torch.Tensor | None = None,
        normals: torch.Tensor | None = None,
    ):
        b, n, _ = data.shape
        ori = data.detach()
        target = target.to(ori.device)
        nrm = ori if normals is None else normals.to(ori.device)
        if init_noise is None:
            noise = torch.randn(ori.shape, generator=generator, device=ori.device, dtype=ori.dtype)
        elif tuple(init_noise.shape) != tuple(ori.shape):
            raise ValueError(f"init_noise must be {list(ori.shape)}, got {tuple(init_noise.shape)}")
        else:
            noise = init_noise.to(device=ori.device, dtype=ori.dtype)
        adv = ori + noise * cfg.init_noise_scale
        mu = torch.zeros_like(adv)
        nu = torch.zeros_like(adv)
        nearest = None
        for it in range(cfg.num_iter):
            if cache_nn and it % cfg.nn_refresh == 0:
                nearest = index_points(ori, nn1_idx(adv, ori))  # constant until the next refresh
            a = adv.detach().requires_grad_(True)
            logits = model_fn(a)
            if cache_nn:
                cham = ((a - nearest) ** 2).sum(dim=-1).mean(dim=-1)
            else:
                cham = chamfer_dist(a, ori)
            # the sum of the row mins: the reference multiplies the mean by N
            loss = (adv_fn(logits, target) + cham * n).sum()
            (grad,) = torch.autograd.grad(loss, a)
            with torch.no_grad():
                adv, mu, nu = adam_step(adv, grad, mu, nu, it + 1, cfg.attack_lr)
                adv = project_inner_clip_linf(adv, ori, cfg.budget, nrm)
        with torch.no_grad():
            pred = model_fn(adv).argmax(dim=-1)
        success = pred == target if cfg.targeted else pred != target
        return adv, success

    return run
