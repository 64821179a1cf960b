"""Closed-form eigendecomposition of batched symmetric 3x3 matrices.

Counterpart of ``pointcloudattack_tpu/geometry/eig3.py``: ascending
eigenvalues by Smith's trigonometric solution (one ``acos``), and each
eigenvector as the largest cross product of two rows of ``A - lambda I``.
Elementwise tensor math over the batch, the same ``_EPS`` and the same
handling of repeated and isotropic spectra.  Eigenvectors are the columns
of the returned matrix, as ``torch.linalg.eigh`` returns them.
"""

from __future__ import annotations

import torch

_EPS = 1e-20
_TWO_PI_3 = 2.0943951023931953


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
    ], dim=-1)


def _basis(i: int, a: torch.Tensor) -> torch.Tensor:
    """The unit vector along axis ``i``, one per matrix of ``a``."""
    e = torch.zeros(a.shape[:-2] + (3,), dtype=a.dtype, device=a.device)
    e[..., i] = 1.0
    return e


def _eigenvalues(a: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric ``[..., 3, 3]`` (Smith's method)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2, _EPS) / 6.0)
    # det((A - qI) / p) / 2 by cofactor expansion
    b00, b11, b22 = d0 / p, d1 / p, d2 / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    r = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    ) / 2.0
    phi = torch.acos(torch.clamp(r, -1.0, 1.0)) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    e_mid = 3.0 * q - e_hi - e_lo
    # p2 ~ 0: a (near-)isotropic matrix, every eigenvalue is q
    iso = p2 <= _EPS
    return torch.stack([torch.where(iso, q, e) for e in (e_lo, e_mid, e_hi)], dim=-1)


def _eigenvector(a: torch.Tensor, lam: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Unit null vector of ``A - lam I``: the largest cross product of two
    of its rows, or ``fallback`` where all three vanish (a repeated
    eigenvalue, whose null space is at least 2-D)."""
    m = a - lam[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01, n02, n12 = ((c * c).sum(-1) for c in (c01, c02, c12))
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None], c01, torch.where((n02 >= n12)[..., None], c02, c12)
    )
    nbest = torch.maximum(n01, torch.maximum(n02, n12))
    return torch.where(
        (nbest > _EPS)[..., None], best / torch.sqrt(torch.clamp_min(nbest, _EPS))[..., None], fallback
    )


def sym_eigh_3x3(a: torch.Tensor):
    """``(eigenvalues [..., 3] ascending, eigenvectors [..., 3, 3])`` of a
    symmetric ``[..., 3, 3]`` stack, eigenvector ``i`` in column ``i``.
    The input is scaled by its largest entry first, so the conditioning in
    float32 does not depend on its magnitude."""
    scale = torch.clamp_min(a.abs().amax(dim=(-2, -1), keepdim=True), _EPS)
    an = a / scale
    evals = _eigenvalues(an)
    ex = _basis(0, a)
    v_lo = _eigenvector(an, evals[..., 0], ex)
    v_hi = _eigenvector(an, evals[..., 2], ex)
    # the middle vector completes the basis: exact for distinct spectra and a
    # valid eigenvector in every degenerate case
    v_mid = _cross(v_hi, v_lo)
    nm = torch.sqrt(torch.clamp_min((v_mid * v_mid).sum(-1, keepdim=True), _EPS))
    # fully isotropic: v_lo == v_hi and the cross vanished -> the identity basis
    v_mid = torch.where(nm > 1e-6, v_mid / nm, _basis(1, a))
    # v_hi again, orthogonal to the reliable lo / mid pair
    v_hi = _cross(v_lo, v_mid)
    return evals * scale[..., 0], torch.stack([v_lo, v_mid, v_hi], dim=-1)
