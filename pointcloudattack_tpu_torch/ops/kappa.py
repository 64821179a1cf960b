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

Numerics: the exact per-coordinate distance, a stable sort (the picks of
the TPU kernel and of the CUDA kernel's lexicographic selection, ties and
duplicates included), the numerator as ``n.a_j - n.a_i`` and every sum in a
fixed order, each operation rounded on its own.  The CUDA kernel
(``csrc/kappa.cu``) computes the same bits as the plain version below on
the CPU, the backward's scatter in the order of ``index_add_`` there.

On a CUDA tensor ``kappa_knn_mean`` launches the kernels; on a CPU tensor
it runs the plain versions.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops import _build
from pointcloudattack_tpu_torch.ops.chamfer import exact_sqdist
from pointcloudattack_tpu_torch.ops.gather import index_points, scatter_rows
from pointcloudattack_tpu_torch.ops.pairwise import dot_last, sum_neighbours

# Kernel launches since the last reset.  Bumped only where a kernel is
# launched, never by the plain versions.
LAUNCHES = {"kappa_fwd": 0, "kappa_bwd": 0}

EPS = 1e-12
MAX_POINTS = 4096  # the forward keeps 8 rows of N distances in shared memory
MAX_K = 64


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _sqrt(d: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (the kernel's
    ``__fsqrt_rn``): PyTorch's vectorised float32 ``sqrt`` on the CPU may
    miss it by an ulp, the float64 one rounded back to float32 does not."""
    return torch.sqrt(d.double()).float()


def kappa_plain(adv: torch.Tensor, normal: torch.Tensor, k: int):
    """Plain forward: ``(kappa [B, N], picks [B, N, k] int32)``."""
    adv, normal = adv.float(), normal.float()
    d, order = torch.sort(exact_sqdist(adv, adv), dim=-1, stable=True)
    d, picks = d[..., 1 : k + 1], order[..., 1 : k + 1]
    num = dot_last(normal[:, :, None, :], index_points(adv, picks)) - dot_last(normal, adv)[..., None]
    c = torch.where(d > 0, num.abs() / (_sqrt(d) + EPS), 0.0)
    return sum_neighbours(c) / k, picks.to(torch.int32)


def kappa_bwd_plain(adv, normal, picks, dkap, k: int):
    """Plain backward: ``(dadv [B, N, 3], dnormal [B, N, 3])`` (the JAX
    ``_bwd_scatter_core``'s formula, summed per edge)."""
    adv, normal, dkap = adv.float(), normal.float(), dkap.float()
    ai = adv[:, :, None, :]
    aj = index_points(adv, picks)  # [B, N, k, 3]
    diff = ai - aj
    d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    num = dot_last(normal[:, :, None, :], aj) - dot_last(normal, adv)[..., None]
    rn = _sqrt(d)
    rr = rn + EPS
    ws = (dkap / k)[..., None] * torch.sign(num)
    guard = d > 0
    alpha = torch.where(guard, ws / rr, 0.0)
    beta = torch.where(guard, -(ws * num) / ((rr * rr) * rn), 0.0)
    v = aj - ai
    e = alpha[..., None] * normal[:, :, None, :] + beta[..., None] * v  # [B, N, k, 3]
    b, n = adv.shape[:2]
    nbr = scatter_rows(torch.zeros_like(adv), picks.reshape(b, n * k), e.reshape(b, n * k, 3))
    return nbr - sum_neighbours(e), sum_neighbours(alpha[..., None] * v)


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


def _kappa_bwd_kernel(adv, normal, picks, dkap, k: int):
    _check(adv, normal, k)
    b, n, _ = adv.shape
    for name, t, shape, dt in (("picks", picks, (b, n, k), torch.int32), ("dkappa", dkap, (b, n), torch.float32)):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() or t.device != adv.device:
            raise ValueError(f"kappa backward kernel takes a contiguous {dt} {list(shape)} {name} on {adv.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    lib = _build.load_library()
    e = torch.empty((b, n, k, 3), dtype=torch.float32, device=adv.device)
    ctr, dnrm, dadv = (torch.empty_like(adv) for _ in range(3))
    with torch.cuda.device(adv.device):
        stream = torch.cuda.current_stream(adv.device).cuda_stream
        rc = lib.pca_kappa_bwd(adv.device.index, adv.data_ptr(), normal.data_ptr(), picks.data_ptr(),
                               dkap.data_ptr(), b, n, k, e.data_ptr(), ctr.data_ptr(), dnrm.data_ptr(),
                               dadv.data_ptr(), stream)
    _build.check(lib, rc, "kappa backward launch")
    LAUNCHES["kappa_bwd"] += 1
    return dadv, dnrm


def kappa_fwd(adv: torch.Tensor, normal: torch.Tensor, k: int):
    """``(kappa, picks)``: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if adv.is_cuda:
        return _kappa_fwd_kernel(adv.contiguous(), normal.contiguous(), k)
    if adv.device.type == "cpu":
        return kappa_plain(adv, normal, k)
    raise ValueError(f"kappa_knn_mean: no implementation for device {adv.device}")


def kappa_bwd(adv, normal, picks, dkap, k: int):
    """``(dadv, dnormal)``: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if adv.is_cuda:
        return _kappa_bwd_kernel(adv.contiguous(), normal.contiguous(), picks, dkap.float().contiguous(), k)
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
