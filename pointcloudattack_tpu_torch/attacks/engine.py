"""Shared C&W binary-search attack engine.

Counterpart of ``pointcloudattack_tpu/attacks/engine.py``: an outer binary
search over the per-example distance weight and an inner Adam loop with
per-iteration best tracking.  The order of work is the reference's: each
iteration evaluates (forward, best update) before the optimizer step, the
clip runs after the step under ``no_grad``, failed examples are back-filled
with the last evaluated iterate, and the bisection follows round success.

All best-so-far state stays on the device as ``[B]`` tensors updated with
``torch.where``: nothing in the loops reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from pointcloudattack_tpu_torch.losses.distance import l2_dist

# model_fn: [B, N, 3] -> logits [B, K]
ModelFn = Callable[[torch.Tensor], torch.Tensor]
# adv_loss_fn: (logits [B, K], target [B]) -> [B]
AdvLossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# dist_loss_fn / track_fn: (adv, ori) -> [B]
DistLossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# clip_fn: (adv, ori) -> adv
ClipFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class CWConfig:
    """Hyperparameters of the binary-search CW engine (the JAX defaults)."""

    attack_lr: float = 1e-2
    init_weight: float = 10.0
    max_weight: float = 80.0
    binary_step: int = 10
    num_iter: int = 500
    targeted: bool = False
    init_noise_scale: float = 1e-7


@dataclasses.dataclass
class CWResult:
    """Per-example attack outcome (tensors on the attack's device)."""

    best_dist: torch.Tensor  # [B] tracking distance of the best adv example
    best_attack: torch.Tensor  # [B, N, 3]
    best_score: torch.Tensor  # [B] predicted class of best adv (-1 = none)
    success: torch.Tensor  # [B] bool
    final_pred: torch.Tensor  # [B] model prediction on best_attack


def _success(pred: torch.Tensor, target: torch.Tensor, targeted: bool) -> torch.Tensor:
    return pred == target if targeted else pred != target


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def adam_step(param, grad, mu, nu, count: int, lr: float):
    """One Adam step in optax's op order (``scale_by_adam``, then ``* -lr``,
    then ``apply_updates``); ``count`` is the 1-based step.  Returns
    ``(param, mu, nu)``."""
    mu = (1 - ADAM_B1) * grad + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * grad**2 + ADAM_B2 * nu
    mu_hat = mu / _bias_correction(ADAM_B1, count)
    nu_hat = nu / _bias_correction(ADAM_B2, count)
    update = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
    return param + update * -lr, mu, nu


def cw_attack(
    model_fn: ModelFn,
    data: torch.Tensor,
    target: torch.Tensor,
    cfg: CWConfig,
    adv_loss_fn: AdvLossFn,
    dist_loss_fn: DistLossFn,
    clip_fn: ClipFn | None = None,
    track_fn: DistLossFn | None = None,
    init_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> CWResult:
    """Run the binary-search CW attack.

    Args:
      model_fn: eval-mode forward returning logits/log-probs ``[B, K]``.
      data: ``[B, N, 3]`` clean clouds.
      target: ``[B]`` int labels: true labels (untargeted) or targets.
      cfg: engine hyperparameters.
      adv_loss_fn / dist_loss_fn / clip_fn: attack-family plug-ins.
      track_fn: best-so-far metric (default: global L2).
      init_noise: ``[binary_step, B, N, 3]`` unscaled start noise per
        round; drawn from ``generator`` (standard normal) when absent.
    """
    b, n, _ = data.shape
    dev, dt = data.device, data.dtype
    ori = data.detach()
    target = target.to(dev)
    track = track_fn or l2_dist
    if init_noise is not None and tuple(init_noise.shape) != (cfg.binary_step, b, n, 3):
        raise ValueError(
            f"init_noise must be [{cfg.binary_step}, {b}, {n}, 3], "
            f"got {tuple(init_noise.shape)}"
        )

    lower = torch.zeros(b, dtype=torch.float32, device=dev)
    upper = torch.full((b,), cfg.max_weight, dtype=torch.float32, device=dev)
    weight = torch.full((b,), cfg.init_weight, dtype=torch.float32, device=dev)
    o_bestdist = torch.full((b,), 1e10, dtype=torch.float32, device=dev)
    o_bestscore = torch.full((b,), -1, dtype=torch.long, device=dev)
    o_bestattack = torch.zeros_like(ori)
    last = ori

    for step in range(cfg.binary_step):
        if init_noise is not None:
            noise = init_noise[step].to(device=dev, dtype=dt)
        else:
            noise = torch.randn((b, n, 3), generator=generator, device=dev, dtype=dt)
        adv = ori + noise * cfg.init_noise_scale
        mu = torch.zeros_like(adv)
        nu = torch.zeros_like(adv)
        bestdist = torch.full((b,), 1e10, dtype=torch.float32, device=dev)
        bestscore = torch.full((b,), -1, dtype=torch.long, device=dev)
        last_eval = adv

        for it in range(cfg.num_iter):
            a = adv.detach().requires_grad_(True)
            logits = model_fn(a)
            loss = (adv_loss_fn(logits, target) + dist_loss_fn(a, ori) * weight).sum()
            (grad,) = torch.autograd.grad(loss, a)
            with torch.no_grad():
                pred = logits.argmax(dim=-1)
                dist = track(adv, ori)
                succ = _success(pred, target, cfg.targeted)

                improved = succ & (dist < bestdist)
                bestdist = torch.where(improved, dist, bestdist)
                bestscore = torch.where(improved, pred, bestscore)

                o_improved = succ & (dist < o_bestdist)
                o_bestdist = torch.where(o_improved, dist, o_bestdist)
                o_bestscore = torch.where(o_improved, pred, o_bestscore)
                o_bestattack = torch.where(o_improved[:, None, None], adv, o_bestattack)

                adv_new, mu, nu = adam_step(adv, grad, mu, nu, it + 1, cfg.attack_lr)
                if clip_fn is not None:
                    adv_new = clip_fn(adv_new, ori)
            # the pre-step iterate is this iteration's evaluated input
            last_eval = adv
            adv = adv_new

        with torch.no_grad():
            round_success = (
                (bestscore != -1)
                & _success(bestscore, target, cfg.targeted)
                & (bestdist <= o_bestdist)
            )
            lower = torch.where(round_success, torch.maximum(lower, weight), lower)
            upper = torch.where(round_success, upper, torch.minimum(upper, weight))
            weight = (lower + upper) / 2.0
        last = last_eval

    with torch.no_grad():
        # back-fill failures with the last evaluated iterate
        failed = lower == 0.0
        o_bestattack = torch.where(failed[:, None, None], last, o_bestattack)
        final_pred = model_fn(o_bestattack).argmax(dim=-1)
        success = _success(final_pred, target, cfg.targeted)

    return CWResult(
        best_dist=o_bestdist,
        best_attack=o_bestattack,
        best_score=o_bestscore,
        success=success,
        final_pred=final_pred,
    )


def shuffle_check(
    model_fn: ModelFn,
    adv: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator | None = None,
    targeted: bool = False,
) -> torch.Tensor:
    """Re-classify with randomly permuted points; ``[B]`` bool: the attack
    still succeeds after shuffling."""
    perm = torch.randperm(adv.shape[1], generator=generator, device=adv.device)
    with torch.no_grad():
        pred = model_fn(adv[:, perm, :]).argmax(dim=-1)
    return _success(pred, target.to(adv.device), targeted)


def transfer_check(
    trans_model_fn: ModelFn,
    adv: torch.Tensor,
    target: torch.Tensor,
    targeted: bool = False,
) -> torch.Tensor:
    """Re-classify on a different victim; ``[B]`` bool success."""
    with torch.no_grad():
        pred = trans_model_fn(adv).argmax(dim=-1)
    return _success(pred, target.to(adv.device), targeted)
