"""GeoA3: the geometry-aware adversarial attack (TPAMI'20).

Counterpart of ``pointcloudattack_tpu/attacks/geoa3.py``: the variable is
an offset added to the clean cloud; each binary-search round starts it at
``1e-3 N(0, 1)`` and takes Adam steps on the classification loss plus the
round's constant times the geometric constraint (symmetric Chamfer +
0.1 Hausdorff + 1.0 curvature by default); the best result is tracked by
the constraint of the previous iteration, and the constant follows the
bisection of the reference.  The rounds and iterations are Python loops;
each iteration runs the model once, its logits serving both the loss and
the evaluation (under ``use_jitter`` the loss sees the jittered cloud and
the evaluation runs a second forward on the bare one).

``curv_knn_refresh = R > 1`` caches the curvature's neighbour set: it is
taken at every ``it % R == 0`` of a round from the pre-step, pre-jitter
cloud, and the curvature between refreshes runs on it
(``kappa_knn_mean_from_idx``).  That is the JAX package's period scan,
whose dead tail discards every update, and with R above the iteration count
the set is frozen for the whole round.  ``use_jitter`` adds tangent-plane
noise (``geometry/normals.py::estimate_perpendicular_jitter``) to the
loss's input, refreshed at every ``it % jitter_refresh_iters == 0``.
``unroll_rounds`` is an XLA compile setting with nothing to do here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pointcloudattack_tpu_torch.attacks.engine import adam_step
from pointcloudattack_tpu_torch.geometry.normals import estimate_normal, estimate_perpendicular_jitter
from pointcloudattack_tpu_torch.losses.adv import (
    cross_entropy_adv_loss,
    logits_adv_loss,
    untargeted_logits_adv_loss,
)
from pointcloudattack_tpu_torch.losses.distance import chamfer_hausdorff_nn
from pointcloudattack_tpu_torch.losses.geometry import curvature_loss, kappa_adv, kappa_ori, nn1_idx, self_knn_idx
from pointcloudattack_tpu_torch.ops.gather import index_points


@dataclasses.dataclass(frozen=True)
class GeoA3Config:
    lr: float = 0.01
    binary_max_steps: int = 10
    iter_max_steps: int = 500
    initial_const: float = 10.0
    cls_loss_type: str = "CE"  # "CE" | "Margin" | "None"
    confidence: float = 0.0
    dis_loss_type: str = "CD"  # "CD" | "L2" | "None"
    is_cd_single_side: bool = False
    dis_loss_weight: float = 1.0
    hd_loss_weight: float = 0.1
    curv_loss_weight: float = 1.0
    curv_loss_knn: int = 16
    targeted: bool = False
    normal_k: int = 3
    curv_knn_refresh: int = 1  # 1: the reference's per-iteration curvature kNN
    use_lr_scheduler: bool = False
    lr_gamma: float = 0.999
    use_jitter: bool = False
    jitter_k: int = 16
    jitter_sigma: float = 0.01
    jitter_clip: float = 0.05
    jitter_refresh_iters: int = 50
    use_offset_proj: bool = False
    cc_linf: float = 0.0


def _check_refresh(cfg) -> None:
    if cfg.curv_knn_refresh < 1:
        raise ValueError(f"curv_knn_refresh must be >= 1, got {cfg.curv_knn_refresh} "
                         "(1 = the reference's per-iteration recompute)")


def _constraint_loss(adv, ori, normal_ori, k_ori, cfg: GeoA3Config, self_idx=None) -> torch.Tensor:
    """``[B]`` weighted geometric constraint; Chamfer, Hausdorff and the
    nearest clean index all come from one two-direction distance call.
    ``self_idx`` supplies a cached neighbour set for the curvature."""
    total = torch.zeros(adv.shape[0], dtype=adv.dtype, device=adv.device)
    a2o, o2a, hd, nn_idx = chamfer_hausdorff_nn(adv, ori)
    if cfg.dis_loss_type == "CD":
        total = total + cfg.dis_loss_weight * (a2o if cfg.is_cd_single_side else a2o + o2a)
    elif cfg.dis_loss_type == "L2":
        total = total + cfg.dis_loss_weight * ((adv - ori) ** 2).sum(dim=(1, 2))
    if cfg.hd_loss_weight != 0:
        total = total + cfg.hd_loss_weight * hd
    if cfg.curv_loss_weight != 0:
        k_adv, _ = kappa_adv(adv, ori, normal_ori, cfg.curv_loss_knn, nn_idx=nn_idx, self_idx=self_idx)
        total = total + cfg.curv_loss_weight * curvature_loss(adv, ori, k_adv, k_ori, nn_idx=nn_idx)
    return total


def _make_cls_fn(cfg: GeoA3Config):
    """The classification term, ``(logits, target) -> [B]``."""
    if cfg.cls_loss_type == "Margin":
        if cfg.targeted:
            return lambda lg, t: logits_adv_loss(lg, t, cfg.confidence)
        return lambda lg, t: untargeted_logits_adv_loss(lg, t, cfg.confidence)
    if cfg.cls_loss_type == "CE":
        return cross_entropy_adv_loss if cfg.targeted else lambda lg, t: -cross_entropy_adv_loss(lg, t)
    return lambda lg, t: torch.zeros(lg.shape[0], dtype=lg.dtype, device=lg.device)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def _offset_proj(offset, ori, normal_ori):
    """The offsets projected on the normal of the nearest clean point; the
    reference's quirk kept: the nearest-point query runs on the offset
    vectors against the clean cloud."""
    normal = index_points(normal_ori, nn1_idx(offset, ori))
    unit = normal / (_norm3(normal) + 1e-6)
    return (offset * unit).sum(dim=-1, keepdim=True) * unit


def _lp_clip(offset, cc_linf: float):
    """Each point's offset capped at L2 length ``cc_linf``."""
    lengths = _norm3(offset)
    scaled = torch.where(lengths > 1e-6, offset / lengths * cc_linf, 0.0)
    return torch.where(lengths < cc_linf, offset, scaled)


def _lr(cfg: GeoA3Config, count: int) -> float:
    """The step size of the ``count``-th step (0-based) of a round, in
    float32 as optax's exponential decay computes it."""
    if not cfg.use_lr_scheduler:
        return cfg.lr
    return float(np.float32(cfg.lr) * np.power(np.float32(cfg.lr_gamma), np.float32(count)))


def _clean_terms(ori, cfg: GeoA3Config):
    """The clean cloud's normals and curvature (zeros without a curvature
    term)."""
    b, n, _ = ori.shape
    normal_ori = estimate_normal(ori, k=cfg.normal_k)
    with torch.no_grad():
        k_ori = (kappa_ori(ori, normal_ori, cfg.curv_loss_knn) if cfg.curv_loss_weight != 0
                 else torch.zeros((b, n), dtype=ori.dtype, device=ori.device))
    return normal_ori, k_ori


def _bisect(round_ok, lower, upper, const):
    """The reference's constant schedule: doubling until bounded, then
    bisection."""
    lower = torch.where(round_ok, torch.maximum(lower, const), lower)
    upper = torch.where(round_ok, upper, torch.minimum(upper, const))
    mid = (lower + upper) * 0.5
    return lower, upper, torch.where(upper < 1e9, mid, torch.where(round_ok, const * 2.0, const))


def build_geoa3_attack(model_fn, cfg: GeoA3Config):
    """``run(data, target, generator=None, init_offsets=None) ->
    (best_attack [B, N, 3], best_loss [B], success [B])``.  ``init_offsets
    [R, B, N, 3]`` holds each round's start offsets (already scaled); absent,
    they are drawn as ``1e-3 N(0, 1)`` from ``generator``, as the jitter's
    noise is."""
    _check_refresh(cfg)
    cache_knn = cfg.curv_loss_weight != 0 and cfg.curv_knn_refresh > 1
    cls_fn = _make_cls_fn(cfg)
    rounds, iters = cfg.binary_max_steps, cfg.iter_max_steps

    def succeeded(pred, target):
        return pred == target if cfg.targeted else pred != target

    def run(data: torch.Tensor, target: torch.Tensor, generator: torch.Generator | None = None,
            init_offsets: torch.Tensor | None = None):
        b, n, _ = data.shape
        dev, dt = data.device, data.dtype
        ori = data.detach()
        target = target.to(dev)
        if init_offsets is not None and tuple(init_offsets.shape) != (rounds, b, n, 3):
            raise ValueError(f"init_offsets must be [{rounds}, {b}, {n}, 3], got {tuple(init_offsets.shape)}")
        normal_ori, k_ori = _clean_terms(ori, cfg)
        full = lambda v, dtype=torch.float32: torch.full((b,), v, dtype=dtype, device=dev)  # noqa: E731
        lower, upper, const = full(0.0), full(1e10), full(cfg.initial_const)
        best_loss, best_attack = full(1e10), ori.clone()
        for r in range(rounds):
            if init_offsets is not None:
                offset = init_offsets[r].to(device=dev, dtype=dt)
            else:
                offset = torch.randn((b, n, 3), generator=generator, device=dev, dtype=dt) * 1e-3
            mu, nu = torch.zeros_like(offset), torch.zeros_like(offset)
            prev_constrain = full(1e10)
            iter_best_loss, iter_best_score = full(1e10), full(-1, torch.long)
            curv_idx, jitter = None, torch.zeros_like(ori)
            for it in range(iters):
                adv = ori + offset
                if cache_knn and it % cfg.curv_knn_refresh == 0:
                    curv_idx = self_knn_idx(adv, cfg.curv_loss_knn).contiguous()
                if cfg.use_jitter and it % cfg.jitter_refresh_iters == 0:
                    jitter = estimate_perpendicular_jitter(adv, cfg.jitter_k, generator, sigma=cfg.jitter_sigma,
                                                           clip=cfg.jitter_clip)
                off = offset.detach().requires_grad_(True)
                a = ori + off
                if cfg.use_jitter:
                    a = a + jitter
                logits = model_fn(a)
                cons = _constraint_loss(a, ori, normal_ori, k_ori, cfg, self_idx=curv_idx)
                (grad,) = torch.autograd.grad((cls_fn(logits, target) + const * cons).sum(), off)
                with torch.no_grad():
                    # evaluated with the previous iteration's constraint, on
                    # the pre-step cloud: the loss's own logits, or under
                    # jitter a second forward on the bare cloud
                    if cfg.use_jitter:
                        logits = model_fn(adv)
                    pred = logits.argmax(dim=-1)
                    succ = succeeded(pred, target)
                    improved = succ & (prev_constrain < best_loss)
                    best_loss = torch.where(improved, prev_constrain, best_loss)
                    best_attack = torch.where(improved[:, None, None], adv, best_attack)
                    # the round's score is recorded only on a per-round improvement
                    round_improved = succ & (prev_constrain < iter_best_loss)
                    iter_best_loss = torch.where(round_improved, prev_constrain, iter_best_loss)
                    iter_best_score = torch.where(round_improved, pred, iter_best_score)
                    offset, mu, nu = adam_step(offset, grad, mu, nu, it + 1, _lr(cfg, it))
                    if cfg.use_offset_proj:
                        offset = _offset_proj(offset, ori, normal_ori)
                    if cfg.cc_linf != 0:
                        offset = _lp_clip(offset, cfg.cc_linf)
                    prev_constrain = cons.detach()
            with torch.no_grad():
                # the final iterate's success drives the bisection
                round_ok = succeeded(model_fn(ori + offset).argmax(dim=-1), target) & (iter_best_score != -1)
                lower, upper, const = _bisect(round_ok, lower, upper, const)
        with torch.no_grad():
            success = succeeded(model_fn(best_attack).argmax(dim=-1), target)
        return best_attack, best_loss, success

    return run
