"""The port's closed-form 3x3 eigensolver and normal estimation
(pointcloudattack_tpu_torch/geometry/eig3.py and normals.py) against the
JAX package, on the CPU.

Eigenvalues and eigenvectors atol 1e-5 on well-separated spectra, and the
JAX package's exact choices on isotropic, planar and rank-1 matrices.

Normals.  A point's normal is the smallest eigenvector of the covariance of
its 3 nearest neighbours, whose rank is at most 2: its two smallest
eigenvalues are 0 and a value that nearly vanishes where the neighbours are
nearly collinear.  The trigonometric solution loses precision there (``acos``
near +-1), so the eigenvector differs between two float32 implementations
by about ``EIG_ERR / gap`` (``gap``: the two smallest eigenvalues' distance
over the largest; measured at most 1.5e-5 / gap over three seeds): each
normal is held within ``max(1e-5, 2 * EIG_ERR / gap)``, and the count of
points that needed more than 1e-5 is asserted small.  The orientation comes
from a centered neighbour sum that is 0 up to rounding, so the port sums it
in the JAX package's order: every sign must agree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.geometry.eig3 import sym_eigh_3x3 as j_eigh
from pointcloudattack_tpu.geometry.normals import _local_cov as j_local_cov
from pointcloudattack_tpu.geometry.normals import estimate_normal as j_estimate_normal
from pointcloudattack_tpu_torch.geometry import normals
from pointcloudattack_tpu_torch.geometry.eig3 import sym_eigh_3x3
from pointcloudattack_tpu_torch.ops import knn as knn_mod

EIG_ERR = 1.5e-5


def spd(seed, shape, spread=1.0):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(*shape, 3, 3))
    lam = np.sort(rng.rand(*shape, 3) * spread + np.array([0.0, 1.0, 2.0]), axis=-1)
    return np.einsum("...ij,...j,...kj->...ik", q, lam, q).astype(np.float32)


def test_eigh_matches_jax_and_numpy_on_separated_spectra():
    a = spd(0, (4, 50))
    vals, vecs = sym_eigh_3x3(torch.from_numpy(a))
    jvals, jvecs = j_eigh(jnp.asarray(a))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0, atol=1e-5)
    np.testing.assert_allclose(vecs.numpy(), np.asarray(jvecs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(vals.numpy(), np.linalg.eigvalsh(a.astype(np.float64)), rtol=0, atol=1e-5)
    # A v = lambda v, and the columns are orthonormal
    av = np.einsum("...ij,...jk->...ik", a, vecs.numpy())
    np.testing.assert_allclose(av, vecs.numpy() * vals.numpy()[..., None, :], rtol=0, atol=2e-5)
    eye = np.einsum("...ji,...jk->...ik", vecs.numpy(), vecs.numpy())
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), rtol=0, atol=2e-6)


@pytest.mark.parametrize("name,a,lowest", [
    ("isotropic", np.eye(3) * 2.0, (1.0, 0.0, 0.0)),  # every eigenvalue 2: the identity basis
    ("planar", np.diag([1.0, 1.0, 0.0]), (0.0, 0.0, 1.0)),  # the flat direction is the normal
    ("rank 1", np.outer([1.0, 2.0, 2.0], [1.0, 2.0, 2.0]) / 9.0, None),
    ("zero", np.zeros((3, 3)), (1.0, 0.0, 0.0)),
])
def test_eigh_degenerate_spectra_match_jax(name, a, lowest):
    a = a.astype(np.float32)[None]
    vals, vecs = sym_eigh_3x3(torch.from_numpy(a))
    jvals, jvecs = j_eigh(jnp.asarray(a))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vecs.numpy(), np.asarray(jvecs), rtol=0, atol=1e-6)
    assert np.isfinite(vecs.numpy()).all()
    if lowest is not None:
        np.testing.assert_allclose(np.abs(vecs.numpy()[0, :, 0]), lowest, rtol=0, atol=1e-6)


def test_eigh_is_scale_invariant():
    a = spd(1, (20,))
    _, v1 = sym_eigh_3x3(torch.from_numpy(a))
    _, v2 = sym_eigh_3x3(torch.from_numpy(a * 1e-6))
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed,n", [(0, 256), (1, 256), (2, 200)])
def test_estimate_normal_matches_jax(seed, n):
    x = (np.random.RandomState(seed).randn(2, n, 3) * 0.5).astype(np.float32)
    knn_mod.reset_launches()
    got = normals.estimate_normal(torch.from_numpy(x).requires_grad_(True))
    assert knn_mod.LAUNCHES["knn"] == 0 and not got.requires_grad  # plain kNN on the CPU, detached
    got = got.numpy()
    want = np.asarray(j_estimate_normal(jnp.asarray(x)))
    cov, nbr_sum = normals._local_cov(torch.from_numpy(x), 3)
    jcov, jsum = j_local_cov(jnp.asarray(x), 3)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(nbr_sum.numpy(), np.asarray(jsum))  # the orientation's source, bit for bit
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=0, atol=1e-6)
    assert ((got * want).sum(-1) > 0.99).all()  # no flipped normal
    ev = np.asarray(j_eigh(jcov)[0])
    gap = (ev[..., 1] - ev[..., 0]) / np.abs(ev).max(-1)
    err = np.abs(got - want).max(-1)
    assert (err <= np.maximum(1e-5, 2 * EIG_ERR / gap)).all(), float((err * gap).max())
    assert (err > 1e-5).mean() < 0.05  # the ill-conditioned neighbourhoods are few
