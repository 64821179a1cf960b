"""GeoA3's curvature proxy: a self-kNN and the mean projection of the unit
neighbour offsets on the point's normal.

Counterpart of ``pointcloudattack_tpu/ops/pallas/kappa_kernel.py::
kappa_knn_mean`` and its TPU kernels ``_kappa_fwd`` / ``_kappa_bwd``: for
``adv [B, N, 3]`` and ``normal [B, N, 3]``,

    kappa_i = mean_t |n_i . a_j - n_i . a_i| / (sqrt(d_ij) + 1e-12)

over the ``k`` picks ``j`` that follow the first of the ``k + 1`` smallest
(exact distance, index) pairs of row ``i`` (the first is the point itself,
or an exact copy of it at a lower index), with 0 where ``d_ij == 0``.  The
gradient reaches both ``adv`` and ``normal``; the backward reads the ``k``
picks the forward kept.

``kappa_knn_mean_from_idx`` is the counterpart of ``kappa_knn_mean_from_idx``
in the same JAX file (its TPU kernels ``_kappa_idx_fwd`` / ``_kappa_idx_bwd``):
the same mean over a GIVEN neighbour set ``idx [B, N, k]`` (GeoA3's cached
set at ``curv_knn_refresh > 1``, and its partial mode), summed in slot
order, so an index repeated in a row adds once per slot, as the JAX
package's gather route does.  The indices are the caller's precondition:
in ``[0, N)`` (the plain version raises on others; the kernel reads
nothing outside the cloud and adds 0 for them).  Gradients reach ``adv``
and ``normal``, none ``idx``; the backward is ``kappa_knn_mean``'s, on
``idx`` in place of the picks.

Numerics: the exact per-coordinate distance, a stable sort (the picks of
the TPU kernel and of the CUDA kernel's lexicographic selection, ties and
duplicates included), the numerator as ``n.a_j - n.a_i`` and every sum in a
fixed order, each operation rounded on its own.  The CUDA kernels
(``csrc/kappa.cu``) compute the same bits as the plain versions below on
the CPU, the backward's scatter in the order of ``index_add_`` there.

On a CUDA tensor both functions launch the kernels; on a CPU tensor they
run the plain versions.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops.chamfer import exact_sqdist
from pointcloudattack_tpu_torch.ops.gather import index_points, scatter_rows
from pointcloudattack_tpu_torch.ops.pairwise import dot_last, sum_neighbours

# Kernel launches since the last reset.  Bumped only where a kernel is
# launched, never by the plain versions.
LAUNCHES = {"kappa_fwd": 0, "kappa_bwd": 0, "kappa_idx_fwd": 0, "kappa_idx_bwd": 0}

EPS = 1e-12
MAX_POINTS = 4096  # the forward keeps the cloud and a row of N distances a warp in shared memory
MAX_K = 64


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _sqrt(d: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (the kernel's
    ``__fsqrt_rn``): PyTorch's vectorised float32 ``sqrt`` on the CPU may
    miss it by an ulp, the float64 one rounded back to float32 does not."""
    return torch.sqrt(d.double()).float()


def _edge_mean(adv, normal, aj, d, k: int) -> torch.Tensor:
    """``(1/k) sum_t |n_i . a_j - n_i . a_i| / (sqrt(d) + 1e-12)`` over the
    ``k`` neighbours ``aj [B, N, k, 3]`` at squared distances ``d [B, N,
    k]``, an edge at ``d == 0`` adding 0, summed in slot order."""
    num = dot_last(normal[:, :, None, :], aj) - dot_last(normal, adv)[..., None]
    c = torch.where(d > 0, num.abs() / (_sqrt(d) + EPS), 0.0)
    return sum_neighbours(c) / k


def kappa_plain(adv: torch.Tensor, normal: torch.Tensor, k: int):
    """Plain forward: ``(kappa [B, N], picks [B, N, k] int32)``."""
    adv, normal = adv.float(), normal.float()
    d, order = torch.sort(exact_sqdist(adv, adv), dim=-1, stable=True)
    d, picks = d[..., 1 : k + 1], order[..., 1 : k + 1]
    return _edge_mean(adv, normal, index_points(adv, picks), d, k), picks.to(torch.int32)


def kappa_idx_plain(adv: torch.Tensor, normal: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Plain forward on the given neighbours ``idx [B, N, k]``: ``kappa
    [B, N]``, each edge's distance in ``exact_sqdist``'s form."""
    adv, normal = adv.float(), normal.float()
    aj = index_points(adv, idx)  # [B, N, k, 3]
    diff = adv[:, :, None, :] - aj
    d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    return _edge_mean(adv, normal, aj, d, k)


def _edge_grads(ai, ni, aj, w):
    """``(e, alpha (a_j - a_i))``, each ``[..., 3]``, of the edges ``i -> j``
    at ``ai, ni, aj [..., 3]`` and ``w = dkappa_i / k [...]``:
    ``kappa_bwd_plain``'s operations in its order."""
    diff = ai - aj
    d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    num = dot_last(ni, aj) - dot_last(ni, ai)
    rn = _sqrt(d)
    rr = rn + EPS
    ws = w * torch.sign(num)
    guard = d > 0
    alpha = torch.where(guard, ws / rr, 0.0)
    beta = torch.where(guard, -(ws * num) / ((rr * rr) * rn), 0.0)
    v = aj - ai
    return alpha[..., None] * ni + beta[..., None] * v, alpha[..., None] * v


def kappa_bwd_plain(adv, normal, picks, dkap, k: int):
    """Plain backward: ``(dadv [B, N, 3], dnormal [B, N, 3])`` (the JAX
    ``_bwd_scatter_core``'s formula, summed per edge)."""
    adv, normal, dkap = adv.float(), normal.float(), dkap.float()
    b, n = adv.shape[:2]
    aj = index_points(adv, picks)  # [B, N, k, 3]
    e, nq = _edge_grads(adv[:, :, None, :].expand_as(aj), normal[:, :, None, :].expand_as(aj), aj,
                        (dkap / k)[..., None].expand(b, n, k))
    nbr = scatter_rows(torch.zeros_like(adv), picks.reshape(b, n * k), e.reshape(b, n * k, 3))
    return nbr - sum_neighbours(e), sum_neighbours(nq)


def kappa_lists_plain(picks: torch.Tensor, n: int):
    """The backward's reverse lists: ``(start [B, n + 1], list [B, n*k])``
    int32, point ``j``'s incoming edges at ``list[b, start[b, j] :
    start[b, j + 1]]``, each as its number ``i * k + t`` where ``picks[b,
    i, t] = j``, in ascending ``(i, t)`` (a stable sort); an index outside
    ``[0, n)`` names no point and is not listed (the tail of ``list`` past
    ``start[b, n]`` holds them and means nothing)."""
    b = picks.shape[0]
    flat = picks.reshape(b, -1).long()
    ok = (flat >= 0) & (flat < n)
    order = torch.argsort(torch.where(ok, flat, n), dim=1, stable=True)
    counts = torch.zeros((b, n + 1), dtype=torch.int64, device=picks.device).scatter_add_(
        1, torch.where(ok, flat, n), torch.ones_like(flat))[:, :n]
    start = torch.cat([counts.new_zeros((b, 1)), counts.cumsum(1)], 1)
    return start.to(torch.int32), order.to(torch.int32)


def kappa_bwd_lists_plain(adv, normal, picks, dkap, k: int, start, lst):
    """The backward as the kernel orders it, on the lists of
    ``kappa_lists_plain``: ``(dadv, dnormal)`` with each row's own edges
    summed in pick order and each point's incoming edges, recomputed from
    ``(i, t)``, summed from 0 in list order; an index outside ``[0, N)``
    adds nothing on either end.  The same bits as ``kappa_bwd_plain`` where
    that one runs (every index in range)."""
    adv, normal, dkap = adv.float(), normal.float(), dkap.float()
    b, n, _ = adv.shape
    ok = (picks >= 0) & (picks < n)
    w = (dkap / k)[..., None].expand(b, n, k)
    e, nq = _edge_grads(adv[:, :, None, :].expand(b, n, k, 3), normal[:, :, None, :].expand(b, n, k, 3),
                        index_points(adv, torch.where(ok, picks, 0)), w)
    ctr, dn = torch.zeros_like(adv), torch.zeros_like(adv)
    for t in range(k):
        ctr = torch.where(ok[:, :, t, None], e[:, :, t] if t == 0 else ctr + e[:, :, t], ctr)
        dn = torch.where(ok[:, :, t, None], nq[:, :, t] if t == 0 else dn + nq[:, :, t], dn)
    first, counts = start[:, :-1].long(), (start[:, 1:] - start[:, :-1]).long()
    last = max(lst.shape[1] - 1, 0)
    s = torch.zeros_like(adv)
    for p in range(int(counts.max()) if counts.numel() else 0):
        ent = lst.gather(1, (first + p).clamp(max=last)).long()  # [B, N]
        i = (ent // k).clamp(0, n - 1)  # past a list's end: masked below
        ei, _ = _edge_grads(index_points(adv, i), index_points(normal, i), adv, dkap.gather(1, i) / k)
        s = torch.where((p < counts)[..., None], s + ei, s)
    return s - ctr, dn


def _check(adv: torch.Tensor, normal: torch.Tensor, k: int) -> None:
    for name, t in (("adv", adv), ("normal", normal)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[2] != 3 or not t.is_contiguous():
            raise ValueError(f"kappa kernel takes a contiguous float32 [B, N, 3] {name}, got {t.dtype} "
                             f"{tuple(t.shape)} contiguous={t.is_contiguous()}")
    if normal.shape != adv.shape or normal.device != adv.device:
        raise ValueError(f"kappa kernel: adv {tuple(adv.shape)} on {adv.device} and normal "
                         f"{tuple(normal.shape)} on {normal.device} disagree")
    b, n, _ = adv.shape
    if not (1 <= b <= 65535 and 1 <= k <= MAX_K and k + 1 <= n <= MAX_POINTS):
        raise ValueError(f"kappa kernel takes 1 <= B <= 65535, 1 <= k <= {MAX_K} and k + 1 <= N <= {MAX_POINTS}; "
                         f"got B={b}, N={n}, k={k}")


def _kappa_fwd_kernel(adv: torch.Tensor, normal: torch.Tensor, k: int):
    _check(adv, normal, k)
    b, n, _ = adv.shape
    lib = _build.load_library()
    kap = torch.empty((b, n), dtype=torch.float32, device=adv.device)
    picks = torch.empty((b, n, k), dtype=torch.int32, device=adv.device)
    with torch.cuda.device(adv.device):
        stream = torch.cuda.current_stream(adv.device).cuda_stream
        rc = lib.pca_kappa_fwd(adv.device.index, adv.data_ptr(), normal.data_ptr(), b, n, k, kap.data_ptr(),
                               picks.data_ptr(), stream)
    _build.check(lib, rc, "kappa forward launch")
    LAUNCHES["kappa_fwd"] += 1
    return kap, picks


def _check_side(adv, what, tensors) -> None:
    """Each ``(name, t, shape, dtype)`` a contiguous ``dtype`` tensor of
    ``shape`` on ``adv``'s device."""
    for name, t, shape, dt in tensors:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() or t.device != adv.device:
            raise ValueError(f"{what} takes a contiguous {dt} {list(shape)} {name} on {adv.device}, "
                             f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()} on {t.device}")


def _kappa_idx_fwd_kernel(adv: torch.Tensor, normal: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    _check(adv, normal, k)
    b, n, _ = adv.shape
    _check_side(adv, "kappa_knn_mean_from_idx kernel", (("idx", idx, (b, n, k), torch.int32),))
    lib = _build.load_library()
    kap = torch.empty((b, n), dtype=torch.float32, device=adv.device)
    with torch.cuda.device(adv.device):
        stream = torch.cuda.current_stream(adv.device).cuda_stream
        rc = lib.pca_kappa_idx_fwd(adv.device.index, adv.data_ptr(), normal.data_ptr(), idx.data_ptr(), b, n, k,
                                   kap.data_ptr(), stream)
    _build.check(lib, rc, "kappa_knn_mean_from_idx forward launch")
    LAUNCHES["kappa_idx_fwd"] += 1
    return kap


def _kappa_bwd_kernel(adv, normal, picks, dkap, k: int, counter: str):
    _check(adv, normal, k)
    b, n, _ = adv.shape
    _check_side(adv, "kappa backward kernel", (("picks", picks, (b, n, k), torch.int32),
                                               ("dkappa", dkap, (b, n), torch.float32)))
    lib = _build.load_library()
    lists = torch.empty(b * (n + 1) + b * n * k, dtype=torch.int32, device=adv.device)  # start, then list
    dadv, dnrm = torch.empty((2, *adv.shape), dtype=torch.float32, device=adv.device)
    with torch.cuda.device(adv.device):
        stream = torch.cuda.current_stream(adv.device).cuda_stream
        rc = lib.pca_kappa_bwd(adv.device.index, adv.data_ptr(), normal.data_ptr(), picks.data_ptr(),
                               dkap.data_ptr(), b, n, k, lists.data_ptr(), lists.data_ptr() + 4 * b * (n + 1),
                               dnrm.data_ptr(), dadv.data_ptr(), stream)
    _build.check(lib, rc, "kappa backward launch")
    LAUNCHES[counter] += 1
    return dadv, dnrm


def kappa_fwd(adv: torch.Tensor, normal: torch.Tensor, k: int):
    """``(kappa, picks)``: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if adv.is_cuda:
        return _kappa_fwd_kernel(adv.contiguous(), normal.contiguous(), k)
    if adv.device.type == "cpu":
        return kappa_plain(adv, normal, k)
    raise ValueError(f"kappa_knn_mean: no implementation for device {adv.device}")


def kappa_idx_fwd(adv: torch.Tensor, normal: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """``kappa`` on the given neighbours: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if adv.is_cuda:
        return _kappa_idx_fwd_kernel(adv.contiguous(), normal.contiguous(), idx, k)
    if adv.device.type == "cpu":
        return kappa_idx_plain(adv, normal, idx, k)
    raise ValueError(f"kappa_knn_mean_from_idx: no implementation for device {adv.device}")


def kappa_bwd(adv, normal, picks, dkap, k: int, counter: str = "kappa_bwd"):
    """``(dadv, dnormal)``: the kernel for CUDA tensors (its launch counted
    under ``counter``: ``kappa_idx_bwd`` on a given set), the plain version
    for CPU tensors."""
    if adv.is_cuda:
        return _kappa_bwd_kernel(adv.contiguous(), normal.contiguous(), picks, dkap.float().contiguous(), k, counter)
    if adv.device.type == "cpu":
        return kappa_bwd_plain(adv, normal, picks, dkap, k)
    raise ValueError(f"kappa_knn_mean: no implementation for device {adv.device}")


class KappaKnnMean(torch.autograd.Function):
    """``kappa [B, N]``; the backward reads the forward's picks."""

    @staticmethod
    def forward(ctx, adv, normal, k):
        kap, picks = kappa_fwd(adv.detach(), normal.detach(), k)
        ctx.save_for_backward(adv, normal, picks)
        ctx.k = k
        return kap

    @staticmethod
    def backward(ctx, dkap):
        adv, normal, picks = ctx.saved_tensors
        dadv, dnrm = kappa_bwd(adv.detach(), normal.detach(), picks, dkap, ctx.k)
        return (dadv if ctx.needs_input_grad[0] else None), (dnrm if ctx.needs_input_grad[1] else None), None


def kappa_knn_mean(adv: torch.Tensor, normal: torch.Tensor, k: int) -> torch.Tensor:
    """``adv [B, N, 3]``, ``normal [B, N, 3]`` -> ``kappa [B, N]``,
    differentiable in both."""
    return KappaKnnMean.apply(adv, normal, k)


class KappaKnnMeanFromIdx(torch.autograd.Function):
    """``kappa [B, N]`` on the given neighbours; ``idx`` takes no gradient."""

    @staticmethod
    def forward(ctx, adv, normal, idx, k):
        kap = kappa_idx_fwd(adv.detach(), normal.detach(), idx, k)
        ctx.save_for_backward(adv, normal, idx)
        ctx.k = k
        return kap

    @staticmethod
    def backward(ctx, dkap):
        adv, normal, idx = ctx.saved_tensors
        dadv, dnrm = kappa_bwd(adv.detach(), normal.detach(), idx, dkap, ctx.k, counter="kappa_idx_bwd")
        return (dadv if ctx.needs_input_grad[0] else None), (dnrm if ctx.needs_input_grad[1] else None), None, None


def kappa_knn_mean_from_idx(adv: torch.Tensor, normal: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """``adv [B, N, 3]``, ``normal [B, N, 3]``, ``idx [B, N, k]`` (each
    row's neighbours, in ``[0, N)``) -> ``kappa [B, N]``, differentiable in
    ``adv`` and ``normal``.  Raises ``ValueError`` unless ``idx`` has
    exactly ``k`` columns, as the JAX function does."""
    if idx.shape[-1] != k:
        raise ValueError(f"idx has {idx.shape[-1]} neighbour columns but k={k}; "
                         "kappa_knn_mean_from_idx uses exactly k columns")
    return KappaKnnMeanFromIdx.apply(adv, normal, idx.detach().to(torch.int32).contiguous(), k)
