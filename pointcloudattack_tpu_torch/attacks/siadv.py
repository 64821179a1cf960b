"""SIadv: shape-invariant white- and black-box attacks (CVPR'22).

Counterpart of ``pointcloudattack_tpu/attacks/siadv.py`` (reference
attack/SIadv/SIadv_attack.py):

  * ``build_si_ifgm``: white-box iFGM in each point's tangent frame: the
    gradient with respect to the spin-axis coordinates, its normal (z)
    component zeroed, the step L2-normalised per cloud and scaled by
    sqrt(3 * 1024), then the per-point clip;
  * ``build_simba``: queries along a random order of the 3N coordinates;
  * ``build_simbapp``: SimBA++, the coordinate drawn from a categorical over
    the white-box |gradient|, the step with Gaussian noise;
  * ``build_si_query_attack``: queries point by point in descending order of
    tangent-plane sensitivity.

The query attacks share ``_query_loop``: per iteration the +step probe (one
forward), then the -step probe from where +step left the cloud (a second
forward), each accepted where it raises the cloud's best margin; a cloud
whose margin is >= 0 stops.  The loop runs on the device in chunks of
``QUERY_CHUNK`` iterations and reads the stop flag back once a chunk: an
iteration in which no cloud is active changes nothing, so the chunk that
runs past the last active cloud gives the outputs the JAX package's
``while_loop`` gives.

The random and hard choices are module-level functions, so that a test or
a card-against-CPU run can hand them over: the normals
(``estimate_normal``), SimBA's order (``simba_order``), SimBA++'s draws
(``simbapp_draws``) and SI-query's ranking (``rank_order``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pointcloudattack_tpu_torch.constraints.clip import clip_points_linf
from pointcloudattack_tpu_torch.geometry.normals import estimate_normal
from pointcloudattack_tpu_torch.geometry.tangent import from_tangent_frame, to_tangent_frame

# query-loop iterations between two reads of the stop flag
QUERY_CHUNK = 16


@dataclasses.dataclass(frozen=True)
class SIAdvConfig:
    """Reference CLI defaults (attack/SIadv/Eval_SIadv.py flags)."""

    eps: float = 0.16
    step_size: float = 0.07
    max_steps: int = 50  # iFGM iterations
    normal_k: int = 20
    # re-estimate the normals every this many iFGM steps (1: every step,
    # the reference's semantics)
    normal_refresh: int = 1
    max_queries: int = 3 * 1024  # SimBA and SimBA++: one pass over the 3N coordinates at most
    noise_std: float = 0.1  # SimBA++ step noise
    top5_attack: bool = False  # success only once the target leaves the top 5


class QueryResult(NamedTuple):
    """A query attack's outcome (tensors on the attack's device)."""

    adv: torch.Tensor  # [B, N, 3]
    pred: torch.Tensor  # [B] the target model's prediction on adv
    success: torch.Tensor  # [B] bool
    queries: torch.Tensor  # [B] int32, the initial classification included
    iterations: int  # loop iterations run (a chunk's multiple, or the cap)


def _sort_desc(x: torch.Tensor) -> torch.Tensor:
    """Values and indices of ``x`` over its last axis, descending, ties to
    the lower index (``lax.top_k``'s order; ``torch.topk`` names none)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _split_target(logits: torch.Tensor, target: torch.Tensor):
    one_hot = F.one_hot(target.long(), logits.shape[-1]).to(logits.dtype)
    return (one_hot * logits).sum(dim=-1), logits - one_hot * 10000.0


def cw_margin_loss(logits: torch.Tensor, target: torch.Tensor, kappa: float = 0.0, tar: bool = True) -> torch.Tensor:
    """SIadv's C&W margin: ``max(other - real, kappa)`` for ``tar`` (positive
    once the prediction left ``target``; the query attacks raise it with
    kappa -999), ``max(real - other, kappa)`` otherwise (the iFGM lowers
    it)."""
    real, masked = _split_target(logits, target)
    other = masked.amax(dim=-1)
    return torch.clamp_min(other - real if tar else real - other, kappa)


def cw_margin_loss_top5(logits: torch.Tensor, target: torch.Tensor, kappa: float = 0.0) -> torch.Tensor:
    """The top-5 variant: ``other`` is the 5th-largest non-target logit."""
    real, masked = _split_target(logits, target)
    return torch.clamp_min(_sort_desc(masked).values[..., 4] - real, kappa)


def success_rule(logits: torch.Tensor, target: torch.Tensor, top5: bool) -> torch.Tensor:
    """``[B]`` bool: the prediction left ``target`` (top-1), or ``target``
    left the top 5."""
    if not top5:
        return logits.argmax(dim=-1) != target
    idx = _sort_desc(logits).indices[..., :5]
    return ~(idx == target[:, None]).any(dim=-1)


def _ifgm_scale(step_size: float) -> float:
    """``step_size * sqrt(3 * 1024)`` rounded to f32 as the JAX package
    forms it.  The reference takes sqrt(3 * 1024) whatever N is."""
    return float(np.float32(step_size) * np.sqrt(np.float32(3.0 * 1024.0)))


def build_si_ifgm(wb_model_fn: Callable, target_model_fn: Callable, cfg: SIAdvConfig):
    """White-box shape-invariant iFGM: ``run(points [B, N, 3], target [B])
    -> (adv [B, N, 3], pred [B], success [B])``, the gradients from
    ``wb_model_fn``, the result scored by ``target_model_fn``."""
    if cfg.normal_refresh < 1:
        raise ValueError(f"normal_refresh must be >= 1, got {cfg.normal_refresh} "
                         "(use max_steps to never refresh within a run)")
    coef = _ifgm_scale(cfg.step_size)

    def run(points, target):
        ori = points.detach()
        target = target.to(ori.device)
        pts, normal = ori, None
        for i in range(cfg.max_steps):
            if i % cfg.normal_refresh == 0:
                normal = estimate_normal(pts, k=cfg.normal_k)
            new_pts, u, tr = to_tangent_frame(pts, normal)
            a = new_pts.detach().requires_grad_(True)
            loss = cw_margin_loss(wb_model_fn(from_tangent_frame(a, u, tr)), target, tar=False).sum()
            (grad,) = torch.autograd.grad(loss, a)
            with torch.no_grad():
                grad[..., 2] = 0.0  # the normal component
                norm = torch.sqrt((grad**2).sum(dim=(1, 2), keepdim=True))
                new_pts = new_pts - coef * grad / (norm + 1e-9)
                pts = clip_points_linf(from_tangent_frame(new_pts, u, tr), ori, cfg.eps)
        with torch.no_grad():
            logits = target_model_fn(pts)
        return pts, logits.argmax(dim=-1), success_rule(logits, target, cfg.top5_attack)

    return run


def _query_loop(margin_fn, probe_fn, points0, max_iters: int, early_exit: bool = True):
    """The shared accept/reject loop: ``(pts, best, queries, iterations)``.

    ``probe_fn(i, pts)`` gives iteration ``i``'s ``(pert_plus, pert_minus)``,
    each broadcastable to ``[B, N, 3]``.  As the reference: +step first, and
    -step only where +step was rejected; ``best`` starts at -999, so an
    active cloud's first probe is always taken; with ``early_exit`` (SimBA,
    SimBA++) a cloud the victim already misclassifies never enters the loop,
    without it (SI-query) every cloud does.  A cloud stays active while its
    best margin is below 0."""
    m0 = margin_fn(points0)
    best = torch.where(m0 >= 0.0, m0, -999.0) if early_exit else torch.full_like(m0, -999.0)
    pts = points0
    queries = torch.ones(m0.shape, dtype=torch.int32, device=m0.device)  # the initial classification
    i = 0
    while i < max_iters and bool((best < 0.0).any()):  # the one read back, once a chunk
        for _ in range(min(QUERY_CHUNK, max_iters - i)):
            active = best < 0.0
            p_plus, p_minus = probe_fn(i, pts)
            cand = pts + p_plus
            m_plus = margin_fn(cand)
            take_plus = active & (m_plus > best)
            best = torch.where(take_plus, m_plus, best)
            pts = torch.where(take_plus[:, None, None], cand, pts)
            cand = pts + p_minus
            m_minus = margin_fn(cand)
            take_minus = active & ~take_plus & (m_minus > best)
            best = torch.where(take_minus, m_minus, best)
            pts = torch.where(take_minus[:, None, None], cand, pts)
            queries = queries + active.int() * 2 - take_plus.int()
            i += 1
    return pts, best, queries, i


def _margin(model_fn, target, top5):
    def margin(pts):
        logits = model_fn(pts)
        if top5:
            return cw_margin_loss_top5(logits, target, kappa=-999.0)
        return cw_margin_loss(logits, target, kappa=-999.0)
    return margin


def simba_order(points: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """SimBA's probe order: a random permutation of the ``3N`` coordinates of
    ``points [B, N, 3]`` (flat index ``point * 3 + coordinate``), shared by
    the batch, on their device."""
    return torch.randperm(3 * points.shape[1], generator=generator, device=points.device)


def simbapp_draws(logits_cat: torch.Tensor, iters: int, generator: torch.Generator | None):
    """SimBA++'s draws for ``iters`` iterations: ``(choice [iters, B]``, a
    flat coordinate per cloud drawn from the categorical of ``logits_cat
    [B, 3N]``, ``noise [iters, B])`` standard normals of the step."""
    probs = torch.softmax(logits_cat, dim=-1)
    choice = torch.multinomial(probs, iters, replacement=True, generator=generator).T
    noise = torch.randn((iters, logits_cat.shape[0]), generator=generator, device=logits_cat.device,
                        dtype=logits_cat.dtype)
    return choice, noise


def rank_order(rankings: torch.Tensor) -> torch.Tensor:
    """SI-query's probe order: points by descending sensitivity, ties to the
    lower index (``jnp.argsort(-rankings)``, a stable sort)."""
    return torch.sort(-rankings, dim=-1, stable=True).indices


def _one_hot_coord(flat: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``[..., N, 3]`` one-hot of the flat coordinate index ``flat [...]``."""
    cols = torch.arange(3 * n, device=flat.device)
    return (cols == flat[..., None]).to(dtype).reshape(*flat.shape, n, 3)


def _finish(model_fn, adv, target, top5, queries, iterations) -> QueryResult:
    with torch.no_grad():
        logits = model_fn(adv)
    return QueryResult(adv, logits.argmax(dim=-1), success_rule(logits, target, top5), queries, iterations)


def build_simba(model_fn, cfg: SIAdvConfig):
    """Black-box SimBA: ``run(points, target, generator=None) ->
    QueryResult``."""

    def run(points, target, generator=None):
        b, n, _ = points.shape
        target = target.to(points.device)
        order = simba_order(points, generator)

        def probe(i, pts):
            pert = cfg.step_size * _one_hot_coord(order[min(i, 3 * n - 1)], n, pts.dtype)[None]
            return pert, -pert

        with torch.no_grad():
            adv, _, queries, iters = _query_loop(_margin(model_fn, target, cfg.top5_attack), probe,
                                                 points.detach(), min(cfg.max_queries, 3 * n))
        return _finish(model_fn, adv, target, cfg.top5_attack, queries, iters)

    return run


def build_simbapp(wb_model_fn, model_fn, cfg: SIAdvConfig):
    """SimBA++: ``run(points, target, generator=None) -> QueryResult``.  The
    coordinate comes from a categorical over ``wb_model_fn``'s |gradient|,
    the flat index ``point * 3 + coordinate`` decoded the same way (the JAX
    package's documented fix of the reference's layout mismatch); the -step
    probe is the +step probe negated."""

    def run(points, target, generator=None):
        b, n, _ = points.shape
        ori = points.detach()
        target = target.to(ori.device)
        a = ori.clone().requires_grad_(True)
        loss = cw_margin_loss(wb_model_fn(a), target, kappa=-999.0).sum()
        (grad,) = torch.autograd.grad(loss, a)
        max_iters = min(cfg.max_queries, 3 * n)
        choice, noise = simbapp_draws(torch.log(grad.abs().reshape(b, -1) + 1e-20), max_iters, generator)

        def probe(i, pts):
            step = cfg.step_size + cfg.noise_std * noise[i]
            pert = _one_hot_coord(choice[i], n, pts.dtype) * step[:, None, None]
            return pert, -pert

        with torch.no_grad():
            adv, _, queries, iters = _query_loop(_margin(model_fn, target, cfg.top5_attack), probe, ori, max_iters)
        return _finish(model_fn, adv, target, cfg.top5_attack, queries, iters)

    return run


def build_si_query_attack(wb_model_fn, model_fn, cfg: SIAdvConfig):
    """Shape-invariant query attack: ``run(points, target) ->
    QueryResult``.  Points are probed in descending order of their
    tangent-plane gradient's length (``wb_model_fn``'s, through a clip to
    ``eps``), each along its own tangent direction; the loop runs up to N
    iterations in the tangent frame, with no clip, as the JAX package's."""

    def run(points, target):
        b, n, _ = points.shape
        ori = points.detach()
        target = target.to(ori.device)
        normal = estimate_normal(ori, k=cfg.normal_k)
        new_pts0, u, tr = to_tangent_frame(ori, normal)
        a = new_pts0.detach().requires_grad_(True)
        back = torch.clamp(from_tangent_frame(a, u, tr), ori - cfg.eps, ori + cfg.eps)
        loss = cw_margin_loss(wb_model_fn(back), target, kappa=-999.0).sum()
        (grad,) = torch.autograd.grad(loss, a)
        with torch.no_grad():
            grad[..., 2] = 0.0
            rankings = torch.sqrt(grad[..., 0] ** 2 + grad[..., 1] ** 2)  # [B, N]
            directions = grad / (rankings[..., None] + 1e-16)
            order = rank_order(rankings)
            margin = _margin(lambda p: model_fn(from_tangent_frame(p, u, tr)), target, cfg.top5_attack)

            def probe(i, pts):
                idx = order[:, min(i, n - 1)]  # [B]
                dir_i = directions.gather(1, idx[:, None, None].expand(b, 1, 3))
                pert = (torch.arange(n, device=idx.device) == idx[:, None]).to(pts.dtype)[..., None] * dir_i
                pert = pert * cfg.step_size
                return pert, -pert

            adv_frame, _, queries, iters = _query_loop(margin, probe, new_pts0, n, early_exit=False)
            adv = from_tangent_frame(adv_frame, u, tr)
        return _finish(model_fn, adv, target, cfg.top5_attack, queries, iters)

    return run
