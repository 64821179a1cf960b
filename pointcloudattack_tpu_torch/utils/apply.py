"""Model apply helpers: turn (model, state dict) into a plain forward."""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import nn


def make_model_fn(
    model: nn.Module,
    state: Mapping[str, torch.Tensor] | None,
    device: torch.device | str,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval-mode forward closure: ``x [B, N, 3] -> [B, K]``, the model's
    first output: log-probs, or raw logits for CurveNet
    (``models.OUTPUT_KIND``), as in the JAX package.

    Loads ``state`` (a reference-layout state dict, strictly) when given,
    moves the model to ``device``, puts it in eval mode (BatchNorm uses its
    running statistics, as the reference's victims do under attack) and
    freezes its parameters, so attacks differentiate with respect to the
    input only.
    """
    if state is not None:
        model.load_state_dict(state, strict=True)
    model.to(device).eval()
    for p in model.parameters():
        p.requires_grad_(False)

    def fn(x: torch.Tensor) -> torch.Tensor:
        out, _ = model(x)
        return out

    return fn
