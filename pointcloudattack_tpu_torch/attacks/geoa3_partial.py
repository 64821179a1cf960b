"""GeoA3's partial-variable mode: the attack moves one kNN patch at a time.

Counterpart of ``pointcloudattack_tpu/attacks/geoa3_partial.py`` (the
reference's ``is_partial_var`` path).  At every ``it % refresh_iters == 0``
of a round a random seed point is drawn, and its ``knn_range`` nearest
points in the CLEAN cloud become the only points that move: the cloud so
far becomes the new base (``base + offset``), the offsets restart at
``1e-3 N(0, 1)`` on the patch and 0 elsewhere, and Adam restarts (its step
count too).  Each update is masked to the patch.  The curvature's neighbour
set, with ``curv_knn_refresh = R > 1``, is taken at every ``it % R == 0``
from ``base + offset * mask``, after the patch refresh.  With
``subsample_npoint`` the evaluation runs a second forward on a farthest-
point subsample of the pre-step cloud (from point 0).  The bisection reads
only the final iterate's success.

The JAX package draws round ``r``'s randomness from ``fold_in(key, r)``;
here they come from ``generator``, or are given: ``seed_idx [R, P, B]``
(each patch's seed point) and ``init_offsets [R, P, B, N, 3]`` (each
patch's start offsets, already scaled, before the mask), with ``P =
ceil(iter_max_steps / refresh_iters)`` patches a round.
"""

from __future__ import annotations

import dataclasses

import torch

from pointcloudattack_tpu_torch.attacks.engine import adam_step
from pointcloudattack_tpu_torch.attacks.geoa3 import (
    GeoA3Config,
    _bisect,
    _check_refresh,
    _clean_terms,
    _constraint_loss,
    _make_cls_fn,
)
from pointcloudattack_tpu_torch.losses.geometry import self_knn_idx
from pointcloudattack_tpu_torch.ops.fps import farthest_point_sample
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.knn import knn_points


@dataclasses.dataclass(frozen=True)
class GeoA3PartialConfig(GeoA3Config):
    knn_range: int = 16
    refresh_iters: int = 50
    subsample_npoint: int = 0  # 0: the evaluation sees the whole cloud


def patch_mask(ori: torch.Tensor, seed_idx: torch.Tensor, knn_range: int) -> torch.Tensor:
    """``[B, N, 1]``: 1 at the ``knn_range`` clean points nearest each
    cloud's seed point ``seed_idx [B]``, 0 elsewhere."""
    b, n, _ = ori.shape
    seed_xyz = index_points(ori, seed_idx.reshape(b, 1))  # [B, 1, 3]
    _, idx = knn_points(seed_xyz, ori, k=knn_range)
    mask = torch.zeros((b, n), dtype=ori.dtype, device=ori.device)
    return mask.scatter_(1, idx[:, 0].long(), 1.0)[..., None]


def build_geoa3_partial_attack(model_fn, cfg: GeoA3PartialConfig):
    """``run(data, target, generator=None, seed_idx=None, init_offsets=None)
    -> (best_attack [B, N, 3], best_loss [B], success [B])``."""
    _check_refresh(cfg)
    cache_knn = cfg.curv_loss_weight != 0 and cfg.curv_knn_refresh > 1
    cls_fn = _make_cls_fn(cfg)
    rounds, iters = cfg.binary_max_steps, cfg.iter_max_steps
    patches = -(-iters // cfg.refresh_iters)

    def succeeded(pred, target):
        return pred == target if cfg.targeted else pred != target

    def run(data: torch.Tensor, target: torch.Tensor, generator: torch.Generator | None = None,
            seed_idx: torch.Tensor | None = None, init_offsets: torch.Tensor | None = None):
        b, n, _ = data.shape
        dev, dt = data.device, data.dtype
        ori = data.detach()
        target = target.to(dev)
        for name, t, shape in (("seed_idx", seed_idx, (rounds, patches, b)),
                               ("init_offsets", init_offsets, (rounds, patches, b, n, 3))):
            if t is not None and tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
        normal_ori, k_ori = _clean_terms(ori, cfg)
        subsample = 0 < cfg.subsample_npoint < n
        full = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)  # noqa: E731
        lower, upper, const = full(0.0), full(1e10), full(cfg.initial_const)
        best_loss, best_attack = full(1e10), ori.clone()
        for r in range(rounds):
            base, offset = ori, torch.zeros_like(ori)
            mask = torch.zeros((b, n, 1), dtype=dt, device=dev)
            prev_cons = full(1e10)
            curv_idx = None
            for it in range(iters):
                if it % cfg.refresh_iters == 0:
                    p = it // cfg.refresh_iters
                    seed = (seed_idx[r, p].to(dev) if seed_idx is not None
                            else torch.randint(0, n, (b,), generator=generator, device=dev))
                    noise = (init_offsets[r, p].to(device=dev, dtype=dt) if init_offsets is not None
                             else torch.randn((b, n, 3), generator=generator, device=dev, dtype=dt) * 1e-3)
                    base = base + offset
                    mask = patch_mask(ori, seed, cfg.knn_range)
                    offset = noise * mask
                    mu, nu, start = torch.zeros_like(offset), torch.zeros_like(offset), it
                adv = base + offset * mask
                if cache_knn and it % cfg.curv_knn_refresh == 0:
                    curv_idx = self_knn_idx(adv, cfg.curv_loss_knn).contiguous()
                off = offset.detach().requires_grad_(True)
                a = base + off * mask
                logits = model_fn(a)
                cons = _constraint_loss(a, ori, normal_ori, k_ori, cfg, self_idx=curv_idx)
                (grad,) = torch.autograd.grad((cls_fn(logits, target) + const * cons).sum(), off)
                with torch.no_grad():
                    if subsample:
                        logits = model_fn(index_points(adv, farthest_point_sample(adv, cfg.subsample_npoint)))
                    succ = succeeded(logits.argmax(dim=-1), target)
                    improved = succ & (prev_cons < best_loss)
                    best_loss = torch.where(improved, prev_cons, best_loss)
                    best_attack = torch.where(improved[:, None, None], adv, best_attack)
                    offset, mu, nu = adam_step(offset, grad, mu, nu, it - start + 1, cfg.lr)
                    offset = offset * mask
                    prev_cons = cons.detach()
            with torch.no_grad():
                round_ok = succeeded(model_fn(base + offset * mask).argmax(dim=-1), target)
                lower, upper, const = _bisect(round_ok, lower, upper, const)
        with torch.no_grad():
            success = succeeded(model_fn(best_attack).argmax(dim=-1), target)
        return best_attack, best_loss, success

    return run
