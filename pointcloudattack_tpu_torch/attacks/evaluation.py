"""Attack evaluation helpers: defense pre-heads, the transfer panel and the
shuffle check.

Counterpart of ``pointcloudattack_tpu/attacks/evaluation.py``:

* ``with_defense``: classify ``defense(x)`` instead of ``x`` (reference
  attack/SIadv/SIadv_attack.py:189-202);
* ``transfer_matrix``: the transfer ASR of adversarial clouds against a
  panel of victims (reference attack/KNN/KNN_attack.py:175-240,
  attack/GeoA3/GeoA3_attack.py:407-471), the members one after another on
  the one device;
* ``shuffle_robustness``: the attack's success after a random shuffle of
  the points (reference attack/CW/CW_attack.py:227-241), through
  ``attacks/engine.py::shuffle_check``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from pointcloudattack_tpu_torch.attacks.engine import _success, shuffle_check


def with_defense(
    model_fn: Callable,
    defense: str,
    *,
    key: int | None = None,
    npoint: int = 1024,
    srs_drop_num: int = 500,
    dup_variables: Mapping[str, torch.Tensor] | None = None,
) -> Callable:
    """``model_fn`` behind the pre-processing ``defense``: ``"sor"``
    (``k=2``, ``alpha=1.1``, ``npoint`` the input's N), ``"srs"`` (drops
    ``min(srs_drop_num, N // 2)`` points) or ``"dupnet"`` (SOR to ``npoint``,
    then PU-Net with ``up_ratio=4``).

    ``key`` seeds SRS's draw and a randomly initialised PU-Net (0 when
    None).  SRS draws from a generator seeded with ``key`` on every call,
    so every forward of an attack drops the same points for a given batch,
    as the JAX package's fixed key does.  ``dup_variables`` is a PU-Net state
    dict in the reference layout; without it PU-Net's weights are drawn from
    ``key``.  PU-Net moves to the input's device on first use, in eval mode
    with its parameters frozen."""
    from pointcloudattack_tpu_torch.defense import DUPNet, sor_defense, srs_defense

    seed = 0 if key is None else int(key)
    if defense == "sor":
        return lambda x: model_fn(sor_defense(x, k=2, alpha=1.1, npoint=x.shape[1]))
    if defense == "srs":
        def srs(x):
            gen = torch.Generator(device=x.device).manual_seed(seed)
            return model_fn(srs_defense(x, gen, drop_num=min(srs_drop_num, x.shape[1] // 2)))
        return srs
    if defense == "dupnet":
        dup = DUPNet(npoint=npoint, up_ratio=4)
        if dup_variables is not None:
            dup.punet.load_state_dict(dup_variables, strict=True)
        else:
            dup.punet.reset_parameters(torch.Generator().manual_seed(seed))
        dup.eval()
        for p in dup.parameters():
            p.requires_grad_(False)

        def dupnet(x):
            if next(dup.parameters()).device != x.device:
                dup.to(x.device)
            return model_fn(dup(x))
        return dupnet
    raise ValueError(f"unknown defense {defense!r}")


def transfer_matrix(
    model_fns: Mapping[str, Callable],
    adv: torch.Tensor,
    target: torch.Tensor,
    targeted: bool = False,
) -> dict[str, float]:
    """``{name: transfer success rate}`` of ``adv`` against each panel
    member, one after another on ``adv``'s device; the host reads the
    results once, after every member ran."""
    oks = {}
    with torch.no_grad():
        for name, fn in model_fns.items():
            oks[name] = _success(fn(adv).argmax(dim=-1), target.to(adv.device), targeted)
    return {name: float(ok.double().mean()) for name, ok in oks.items()}


def shuffle_robustness(
    model_fn: Callable,
    adv: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator | None = None,
    num_trials: int = 1,
    targeted: bool = False,
) -> float:
    """The share of (trial, cloud) pairs whose attack survives a random
    shuffle of the points, each trial's permutation from ``generator``."""
    oks = [shuffle_check(model_fn, adv, target, generator, targeted) for _ in range(num_trials)]
    return float(torch.stack(oks).double().mean())
