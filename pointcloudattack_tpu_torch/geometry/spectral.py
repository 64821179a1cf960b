"""Graph-spectral decomposition of point clouds (the AOF attack).

Counterpart of ``pointcloudattack_tpu/geometry/spectral.py``: a 30-NN
Gaussian-affinity adjacency, the kNN mask made symmetric, the unnormalised
Laplacian ``L = D - A``, and its lowest ``m`` eigenvectors, the only part of
the spectrum the attack uses: the low-frequency part of a cloud is
``lfc = V V^T pc`` and the high-frequency part ``pc - lfc``.

The kNN mask comes from ``ops/knn.py::knn`` (the kNN kernel on a CUDA
tensor), the affinity from ``ops/pairwise.py::pairwise_sqdist``.  The
subspace solve is plain PyTorch, as the JAX package computes it outside any
Pallas kernel: ``"chebyshev"`` (the default where ``5m < N``) is a filtered
subspace iteration of batched FP32 products and two ``s x s`` ``eigh`` a
round, run for all clouds at once; ``"dense"`` is a full ``eigh``.  TF32 is
off (the package's ``__init__``), so the products stay FP32 on the card.
"""

from __future__ import annotations

import torch

from pointcloudattack_tpu_torch.ops.knn import knn
from pointcloudattack_tpu_torch.ops.pairwise import pairwise_sqdist

# Chebyshev-filtered subspace iteration: oversampling beyond m and the
# per-round polynomial degrees, the JAX package's schedule.  The cutoff
# eigenvalues cluster (lam_m ~ lam_m+1), so convergence needs both the
# oversampled block and several adaptive-cutoff rounds; past degree 6 the
# block's numerical rank collapses below m in f32 between Rayleigh-Ritz
# steps.
_CHEB_OVERSAMPLE = 56
_CHEB_DEGREES = (6,) * 8


def laplacian_matrix(pc: torch.Tensor, k: int = 30):
    """kNN-masked Gaussian-affinity Laplacian: ``(L [B, N, N], degree
    [B, N])``.  The kNN includes the point itself, as the reference's
    does; the mask holds only 0 and 1."""
    pc = pc.detach()
    d = pairwise_sqdist(pc, pc)
    idx = knn(pc, k).long()
    mask = torch.zeros_like(d).scatter_(2, idx, 1.0)
    mask = torch.clamp_max(mask + mask.transpose(1, 2), 1.0)
    a = torch.exp(-d) * mask
    deg = a.sum(dim=2)
    return torch.diag_embed(deg) - a, deg


def graph_laplacian(pc: torch.Tensor, k: int = 30):
    """Full eigendecomposition of the graph Laplacian: ``(eigenvalues
    [B, N] ascending, eigenvectors [B, N, N])``, without gradient."""
    lap, _ = laplacian_matrix(pc, k)
    return torch.linalg.eigh(lap)


def lowpass_basis(
    pc: torch.Tensor,
    k: int = 30,
    m: int = 100,
    method: str = "auto",
    start: torch.Tensor | None = None,
):
    """Lowest-``m`` eigenpairs of the graph Laplacian of ``pc [B, N, 3]``:
    ``(eigenvalues [B, m] ascending, eigenvectors [B, N, m])``, without
    gradient.

    ``method``: ``"chebyshev"``, ``"dense"`` or ``"auto"`` (Chebyshev where
    ``5m < N``, dense otherwise).  The iterative solver starts from
    ``start [B, N, min(N, m + 56)]`` when given (a test hands the JAX
    package's block over), else from standard normals of a generator seeded
    0 on the cloud's device: a fixed start, as the JAX package's default
    key gives.  ``"lobpcg"`` is not ported.
    """
    pc = pc.detach()
    b, n, _ = pc.shape
    if method == "lobpcg":
        raise ValueError('lowpass_basis: method "lobpcg" is not ported; use "chebyshev", "dense" or "auto"')
    if method not in ("auto", "chebyshev", "dense"):
        raise ValueError(f"lowpass_basis: unknown method {method!r}")
    lap, deg = laplacian_matrix(pc, k)
    if method == "auto":
        method = "chebyshev" if 5 * m < n else "dense"
    if method == "dense":
        evals, evecs = torch.linalg.eigh(lap)
        return evals[:, :m], evecs[:, :, :m]
    s = min(n, m + _CHEB_OVERSAMPLE)
    if start is None:
        gen = torch.Generator(device=pc.device).manual_seed(0)
        start = torch.randn((b, n, s), generator=gen, device=pc.device, dtype=pc.dtype)
    elif tuple(start.shape) != (b, n, s):
        raise ValueError(f"lowpass_basis: start must be [{b}, {n}, {s}], got {tuple(start.shape)}")
    return _chebyshev_lowpass(lap, deg, m, start.to(device=pc.device, dtype=pc.dtype))


def _col_normalize(x: torch.Tensor) -> torch.Tensor:
    """Each column of ``x [B, N, s]`` over its L2 norm (+1e-30)."""
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-30)


def _chebyshev_lowpass(lap: torch.Tensor, deg: torch.Tensor, m: int, x: torch.Tensor):
    """Lowest-``m`` eigenpairs of each ``[N, N]`` Laplacian of ``lap`` by
    Chebyshev-filtered subspace iteration from the block ``x [B, N, s]``.

    Each round applies a degree-d Chebyshev polynomial that grows on
    ``[0, a)`` and stays bounded on ``[a, lam_max]`` (a three-term
    recurrence with a per-column rescale), then a Rayleigh-Ritz step
    whitened through the overlap's own ``eigh``: directions whose overlap
    eigenvalue falls below 1e-5 of the largest are zeroed and their Ritz
    diagonal pushed to 10 lam_max, past the spectrum.  The cutoff ``a`` (a
    ``[B]`` tensor: no value is read back) starts at the Gershgorin-scaled
    guess and becomes 1.05 x the m-th Ritz value each round, clipped to
    ``[1e-6, 0.9 lam_max]``."""
    n = lap.shape[-1]
    lam_max = 2.0 * deg.amax(dim=-1) + 1e-3  # [B], Gershgorin
    top = lam_max * 0.9

    def clip(v):
        return torch.minimum(torch.clamp_min(v, 1e-6), top)

    def cheb_filter(t, a, d):
        e = ((lam_max - a) / 2.0)[:, None, None]
        c = ((lam_max + a) / 2.0)[:, None, None]

        def mul(y):
            return (torch.bmm(lap, y) - c * y) / e

        tm1, t = t, mul(t)
        for _ in range(d - 1):
            tn = 2.0 * mul(t) - tm1
            # the same factor on both terms keeps the recurrence valid
            sc = 1.0 / (torch.linalg.vector_norm(tn, dim=1, keepdim=True) + 1e-30)
            tm1, t = t * sc, tn * sc
        return t

    def rayleigh_ritz(xb):
        xb = _col_normalize(xb)
        xtx = torch.bmm(xb.transpose(1, 2), xb)
        wm, um = torch.linalg.eigh(0.5 * (xtx + xtx.transpose(1, 2)))  # ascending
        keep = wm > 1e-5 * wm[:, -1:]
        winv = torch.where(keep, 1.0 / torch.sqrt(wm.abs() + 1e-30), 0.0)
        y = torch.bmm(xb, um * winv[:, None, :])  # whitened block, dropped columns ~ 0
        a_ = torch.bmm(y.transpose(1, 2), torch.bmm(lap, y))
        a_ = 0.5 * (a_ + a_.transpose(1, 2))
        big = (10.0 * lam_max)[:, None]
        a_ = a_ + torch.diag_embed(torch.where(keep, 0.0, big))
        w, u = torch.linalg.eigh(a_)  # ascending; dropped directions at the tail
        return w, _col_normalize(torch.bmm(y, u))

    a = clip(lam_max * (2.0 * m / n))
    w = None
    for d in _CHEB_DEGREES:
        x = cheb_filter(x, a, d)
        w, x = rayleigh_ritz(x)
        a = clip(w[:, m - 1] * 1.05)
    return w[:, :m], x[:, :, :m]


def lowpass_split(pc: torch.Tensor, basis: torch.Tensor):
    """``(lfc, hfc)`` of ``pc [B, N, 3]`` on a ``[B, N, m]`` low-frequency
    basis: ``lfc = V (V^T pc)``, ``hfc = pc - lfc``."""
    projs = torch.bmm(basis.transpose(1, 2), pc)  # [B, m, 3]
    lfc = torch.bmm(basis, projs)
    return lfc, pc - lfc


def spectral_split(pc: torch.Tensor, evecs: torch.Tensor, low_pass: int):
    """``(lfc, hfc)`` of ``pc [B, N, 3]`` on the full eigenbasis ``evecs
    [B, N, N]`` (ascending frequency): the first ``low_pass`` modes and the
    rest."""
    projs = torch.bmm(evecs.transpose(1, 2), pc)  # [B, N, 3]
    lfc = torch.bmm(evecs[:, :, :low_pass], projs[:, :low_pass])
    hfc = torch.bmm(evecs[:, :, low_pass:], projs[:, low_pass:])
    return lfc, hfc


def spectral_project(pc: torch.Tensor, evecs: torch.Tensor, low_pass: int):
    """Re-project a (clipped) cloud onto the low/high frequency basis."""
    return spectral_split(pc, evecs, low_pass)
