"""Adversarial classification losses (C&W margin family).

Counterpart of ``pointcloudattack_tpu/losses/adv.py``.  All take logits
``[B, K]`` and integer targets ``[B]`` and return ``[B]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _split_target_other(logits: torch.Tensor, targets: torch.Tensor):
    one_hot = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
    real = (one_hot * logits).sum(dim=-1)
    # Mask the target class out of the max with the reference's -10000 trick.
    # amax splits a tie's gradient evenly, as jnp.max does.
    other = ((1.0 - one_hot) * logits - one_hot * 10000.0).amax(dim=-1)
    return real, other


def logits_adv_loss(
    logits: torch.Tensor, targets: torch.Tensor, kappa: float = 0.0
) -> torch.Tensor:
    """Targeted margin loss: push the target logit above all others by kappa."""
    real, other = _split_target_other(logits, targets)
    return torch.clamp_min(other - real + kappa, 0.0)


def untargeted_logits_adv_loss(
    logits: torch.Tensor, targets: torch.Tensor, kappa: float = 0.0
) -> torch.Tensor:
    """Untargeted margin loss: push the true logit below the runner-up by kappa."""
    real, other = _split_target_other(logits, targets)
    return torch.clamp_min(real - other + kappa, 0.0)


def cross_entropy_adv_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """NLL of the target class (the models emit log-probs)."""
    one_hot = F.one_hot(targets.long(), logits.shape[-1]).to(logits.dtype)
    return -(one_hot * logits).sum(dim=-1)


def negative_logits_adv_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Negated NLL: maximise the true-class loss (untargeted CE mode)."""
    return -cross_entropy_adv_loss(logits, targets)


def adv_loss_fn(adv_func: str, targeted: bool, kappa: float):
    """The attack families' classification loss ``(logits, target) -> [B]``:
    ``"logits"``, the margin loss (targeted or untargeted) with confidence
    ``kappa``; ``"cross_entropy"``, the target's NLL (negated when
    untargeted)."""
    if adv_func == "logits":
        if targeted:
            return lambda lg, t: logits_adv_loss(lg, t, kappa)
        return lambda lg, t: untargeted_logits_adv_loss(lg, t, kappa)
    if adv_func == "cross_entropy":
        return cross_entropy_adv_loss if targeted else negative_logits_adv_loss
    raise ValueError(f"unknown adv_func {adv_func!r}")
