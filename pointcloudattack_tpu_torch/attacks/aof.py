"""AOF / TAOF: an attack on the low-frequency part of the cloud.

Counterpart of ``pointcloudattack_tpu/attacks/aof.py`` (reference
attack/AOF/TAOF_attack.py, targeted, and Eval_AOF.py's untargeted loop):

  1. the lowest ``low_pass`` eigenvectors of the cloud's kNN-Gaussian
     Laplacian (``geometry/spectral.py::lowpass_basis``; by default once,
     from the clean cloud, for every round);
  2. per binary round, the cloud split into low- and high-frequency parts,
     and Adam (restarted each round) on the low-frequency part alone with
     the blended loss ``(1 - gamma) adv(model(lfc + hfc)) + gamma
     adv(model(lfc))``;
  3. after each step the recombined cloud clipped and projected onto the
     basis again, both parts refreshed.

The order of work is the JAX package's: a step's two forwards score the
current iterate before the step, and one more scoring follows each round's
last step.  Best tracking keeps the iterate that fools the model with the
smallest distance: L2 for TAOF, which also needs the low-frequency part
alone to miss the true label; L-infinity for AOF, whose low-frequency part
must fool the model too.  Failures take the last round's final iterate.

All state stays on the device as tensors updated with ``torch.where``; the
attack's iterations read nothing back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from pointcloudattack_tpu_torch.attacks.engine import adam_step
from pointcloudattack_tpu_torch.constraints.clip import clip_points_linf
from pointcloudattack_tpu_torch.geometry import spectral
from pointcloudattack_tpu_torch.losses.adv import adv_loss_fn
from pointcloudattack_tpu_torch.losses.distance import l2_dist


@dataclasses.dataclass(frozen=True)
class AOFConfig:
    """Reference defaults: TAOF_attack.py:59-67, Eval_AOF flags."""

    attack_lr: float = 1e-2
    binary_step: int = 2
    num_iter: int = 200
    gamma: float = 0.5  # blend between the full and the low-frequency loss
    low_pass: int = 100
    knn_k: int = 30
    budget: float = 0.18
    kappa: float = 30.0
    targeted: bool = False
    adv_func: str = "logits"  # "logits" | "cross_entropy"
    init_noise_scale: float = 1e-7
    # "auto" = the Chebyshev subspace solve where 5 * low_pass < N, a dense
    # eigh otherwise (geometry/spectral.py)
    spectral_method: str = "auto"
    # the basis once, from the clean cloud, for every round; False: once a
    # round from the noised cloud, as the reference does (the rounds differ
    # only by the 1e-7 start noise)
    reuse_basis: bool = True
    # the two forwards of a step as one [2B] call; valid only for a victim
    # whose rows do not depend on each other
    batched_forward: bool = False


def build_aof_attack(model_fn, cfg: AOFConfig):
    """``run(data, target, y_truth=None, generator=None, init_noise=None)
    -> (adv [B, N, 3], best_dist [B], success [B])``.

    ``target``: the attack's target (TAOF) or the true label (AOF).
    ``y_truth``: the true labels, which TAOF's success rule reads (the
    target when absent).  ``init_noise``: ``[binary_step, B, N, 3]`` unscaled
    start noise per round, drawn from ``generator`` when absent.  The basis
    comes through ``spectral.lowpass_basis`` (looked up on the module at
    each call), from its fixed start block."""
    adv_fn = adv_loss_fn(cfg.adv_func, cfg.targeted, cfg.kappa)

    def basis_of(pc):
        return spectral.lowpass_basis(pc, k=cfg.knn_k, m=cfg.low_pass, method=cfg.spectral_method)[1]

    def run(data, target, y_truth=None, generator=None, init_noise=None):
        b, n, _ = data.shape
        dev, dt = data.device, data.dtype
        ori = data.detach()
        target = target.to(dev)
        yt = target if y_truth is None else y_truth.to(dev)
        if init_noise is not None and tuple(init_noise.shape) != (cfg.binary_step, b, n, 3):
            raise ValueError(f"init_noise must be [{cfg.binary_step}, {b}, {n}, 3], got {tuple(init_noise.shape)}")

        def update_best(best, full_logits, lfc_logits, adv_eval):
            bestdist, bestattack, bestscore = best
            pred = full_logits.argmax(dim=-1)
            lfc_pred = lfc_logits.argmax(dim=-1)
            if cfg.targeted:
                succ = (pred == target) & (lfc_pred != yt)
                dist = l2_dist(adv_eval, ori)
            else:
                succ = (pred != target) & (lfc_pred != target)
                dist = (adv_eval - ori).abs().amax(dim=(1, 2))
            improved = succ & (dist < bestdist)
            return (torch.where(improved, dist, bestdist),
                    torch.where(improved[:, None, None], adv_eval, bestattack),
                    torch.where(improved, pred, bestscore))

        def logits_of(lfc, hfc):
            if cfg.batched_forward:
                return model_fn(torch.cat([lfc + hfc, lfc], dim=0)).split(b, dim=0)
            return model_fn(lfc + hfc), model_fn(lfc)

        shared = basis_of(ori) if cfg.reuse_basis else None
        best = (torch.full((b,), 1e10, dtype=torch.float32, device=dev), torch.zeros_like(ori),
                torch.full((b,), -1, dtype=torch.long, device=dev))
        last = ori
        for r in range(cfg.binary_step):
            if init_noise is not None:
                noise = init_noise[r].to(device=dev, dtype=dt)
            else:
                noise = torch.randn(ori.shape, generator=generator, device=dev, dtype=dt)
            adv = ori + noise * cfg.init_noise_scale
            basis = shared if shared is not None else basis_of(adv)
            lfc, hfc = spectral.lowpass_split(adv, basis)
            mu, nu = torch.zeros_like(lfc), torch.zeros_like(lfc)
            for it in range(cfg.num_iter):
                a = lfc.detach().requires_grad_(True)
                full_logits, lfc_logits = logits_of(a, hfc)
                loss = ((1.0 - cfg.gamma) * adv_fn(full_logits, target)
                        + cfg.gamma * adv_fn(lfc_logits, target)).sum()
                (grad,) = torch.autograd.grad(loss, a)
                with torch.no_grad():
                    # the step's forwards score the current iterate
                    best = update_best(best, full_logits, lfc_logits, lfc + hfc)
                    lfc, mu, nu = adam_step(lfc, grad, mu, nu, it + 1, cfg.attack_lr)
                    lfc, hfc = spectral.lowpass_split(clip_points_linf(lfc + hfc, ori, cfg.budget), basis)
            with torch.no_grad():
                # score the round's final iterate, which no step scored
                last = lfc + hfc
                best = update_best(best, model_fn(last), model_fn(lfc), last)

        bestdist, bestattack, bestscore = best
        with torch.no_grad():
            adv = torch.where((bestscore < 0)[:, None, None], last, bestattack)
            pred = model_fn(adv).argmax(dim=-1)
        success = pred == target if cfg.targeted else pred != target
        return adv, bestdist, success

    return run
