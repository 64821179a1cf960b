"""The port's graph-spectral module (pointcloudattack_tpu_torch/geometry/
spectral.py) against the JAX package's, on the CPU.

Tolerances:
- ``laplacian_matrix``: the kNN mask (the Laplacian's nonzero pattern)
  exact; L atol 1e-6 off the diagonal; the diagonal, the degrees, rtol 1e-6:
  a degree sums a row's affinities (up to 18 on these clouds, where one
  ulp is 1.9e-6) in another order than the JAX package, and parts from it
  by one ulp; ``graph_laplacian``'s eigenvalues (up to 19) atol 1e-5 and
  rtol 2e-6, two f32 eigensolvers apart.
- ``lowpass_basis``, Chebyshev, from the JAX package's start block at N=128,
  m=16, k=10: the low-frequency part ``lfc`` within 1e-4 of the JAX
  package's, and the port's projector error against a float64 dense
  ``eigh`` (``||P - P_dense||_F / sqrt(2m)``) at most 2x the JAX package's;
  the dense method's ``lfc`` atol 1e-5.  At the bench shape (one cloud,
  N=1024, m=100, k=30), where the 100th and 101st eigenvalues nearly
  coincide and f32 cannot fix the 100th vector, bases are not compared:
  the port's ``lfc`` error against the float64 dense one at most 2x the
  JAX package's.
- ``lowpass_split``, ``spectral_split`` and ``spectral_project`` atol 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.data.synthetic import make_synthetic_clouds
from pointcloudattack_tpu.geometry import spectral as jspectral
from pointcloudattack_tpu_torch.geometry import spectral
from pointcloudattack_tpu_torch.ops import knn as knn_mod

from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why


_j_basis = jax.jit(jspectral.lowpass_basis, static_argnames=("k", "m", "method"))


def clouds(b, n, seed=1):
    return make_synthetic_clouds(8, 1, n, seed=seed)[0][:b]


def jax_start(b, n, m):
    """The JAX package's Chebyshev start block (spectral.py: PRNGKey(0)
    split over the batch, a normal [N, m + 56] block each)."""
    s = min(n, m + spectral._CHEB_OVERSAMPLE)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    return np.stack([np.asarray(jax.random.normal(k, (n, s), jnp.float32)) for k in keys])


def lfc_of(pc, basis):
    return np.einsum("bnm,bkm,bkc->bnc", basis, basis, pc)


def dense64(lap, m):
    """The lowest-m eigenvectors of each Laplacian in float64."""
    return np.linalg.eigh(lap.astype(np.float64))[1][..., :m]


def projector_error(v, ref):
    """``||V V^T - R R^T||_F / sqrt(2m)`` per cloud."""
    p = np.einsum("bnm,bkm->bnk", v.astype(np.float64), v.astype(np.float64))
    r = np.einsum("bnm,bkm->bnk", ref, ref)
    return np.sqrt(((p - r) ** 2).sum(axis=(1, 2)) / (2 * v.shape[-1]))


def test_laplacian_matches_jax():
    pc = clouds(3, 64)
    knn_mod.reset_launches()
    lap, deg = spectral.laplacian_matrix(torch.from_numpy(pc), k=10)
    assert knn_mod.LAUNCHES["knn"] == 0
    jlap, jdeg = (np.asarray(t) for t in jspectral.laplacian_matrix(jnp.asarray(pc), k=10))
    np.testing.assert_array_equal(lap.numpy() != 0, jlap != 0)  # the mask
    assert 10 * 64 <= (jlap != 0).sum(axis=(1, 2)).min() < 64 * 64  # a kNN graph, symmetric
    off = ~np.eye(64, dtype=bool)
    np.testing.assert_allclose(lap.numpy()[:, off], jlap[:, off], rtol=0, atol=1e-6)
    np.testing.assert_allclose(deg.numpy(), jdeg, rtol=1e-6, atol=0)
    diag = lambda m: np.diagonal(m, axis1=1, axis2=2)  # noqa: E731
    np.testing.assert_allclose(diag(lap.numpy()), diag(jlap), rtol=1e-6, atol=0)
    evals, _ = spectral.graph_laplacian(torch.from_numpy(pc), k=10)
    np.testing.assert_allclose(evals.numpy(), np.asarray(jspectral.graph_laplacian(jnp.asarray(pc), k=10)[0]),
                               rtol=2e-6, atol=1e-5)


def test_chebyshev_basis_matches_jax_on_its_start_block():
    b, n, m, k = 2, 128, 16, 10
    pc = clouds(b, n)
    start = jax_start(b, n, m)
    w, v = spectral.lowpass_basis(torch.from_numpy(pc), k=k, m=m, method="chebyshev",
                                  start=torch.from_numpy(start))
    jw, jv = (np.asarray(t) for t in _j_basis(jnp.asarray(pc), k=k, m=m, method="chebyshev"))
    assert tuple(v.shape) == (b, n, m) and tuple(w.shape) == (b, m)
    np.testing.assert_allclose(lfc_of(pc, v.numpy()), lfc_of(pc, jv), rtol=0, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-4)
    ref = dense64(np.asarray(jspectral.laplacian_matrix(jnp.asarray(pc), k=k)[0]), m)
    err, jerr = projector_error(v.numpy(), ref), projector_error(jv, ref)
    assert (err <= 2 * jerr).all(), (err, jerr)
    # "auto" takes Chebyshev here (5m < N), from the fixed default start
    _, v_auto = spectral.lowpass_basis(torch.from_numpy(pc), k=k, m=m)
    _, v_again = spectral.lowpass_basis(torch.from_numpy(pc), k=k, m=m, method="chebyshev")
    assert torch.equal(v_auto, v_again)
    assert (projector_error(v_auto.numpy(), ref) <= 2 * jerr.max()).all()


def test_dense_basis_matches_jax():
    pc = clouds(2, 64)
    _, v = spectral.lowpass_basis(torch.from_numpy(pc), k=10, m=16)  # "auto": 5m >= N, dense
    jv = np.asarray(jspectral.lowpass_basis(jnp.asarray(pc), k=10, m=16, method="dense")[1])
    np.testing.assert_allclose(lfc_of(pc, v.numpy()), lfc_of(pc, jv), rtol=0, atol=1e-5)


def test_chebyshev_at_the_bench_shape_is_as_close_to_dense_as_jax():
    n, m, k = 1024, 100, 30
    pc = clouds(1, n)
    _, v = spectral.lowpass_basis(torch.from_numpy(pc), k=k, m=m, start=torch.from_numpy(jax_start(1, n, m)))
    jv = np.asarray(_j_basis(jnp.asarray(pc), k=k, m=m)[1])
    ref = dense64(np.asarray(jspectral.laplacian_matrix(jnp.asarray(pc), k=k)[0]), m)
    want = lfc_of(pc.astype(np.float64), ref)
    err, jerr = np.abs(lfc_of(pc, v.numpy()) - want).max(), np.abs(lfc_of(pc, jv) - want).max()
    assert err <= 2 * jerr, (err, jerr)


def test_lobpcg_and_bad_start_raise():
    pc = torch.from_numpy(clouds(1, 128))
    with pytest.raises(ValueError, match="lobpcg"):
        spectral.lowpass_basis(pc, k=10, m=16, method="lobpcg")
    with pytest.raises(ValueError, match="start"):
        spectral.lowpass_basis(pc, k=10, m=16, method="chebyshev", start=torch.zeros(1, 128, 16))


def test_splits_match_jax():
    rng = np.random.RandomState(4)
    b, n, m = 2, 64, 12
    pc = rng.randn(b, n, 3).astype(np.float32)
    q = np.stack([np.linalg.qr(rng.randn(n, n))[0] for _ in range(b)]).astype(np.float32)
    got = spectral.lowpass_split(torch.from_numpy(pc), torch.from_numpy(q[..., :m].copy()))
    want = jspectral.lowpass_split(jnp.asarray(pc), jnp.asarray(q[..., :m]))
    for fn, jfn, args in ((spectral.spectral_split, jspectral.spectral_split, (m,)),
                          (spectral.spectral_project, jspectral.spectral_project, (m,))):
        got += fn(torch.from_numpy(pc), torch.from_numpy(q), *args)
        want += jfn(jnp.asarray(pc), jnp.asarray(q), *args)
    assert len(got) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    lfc, hfc = got[2:4]
    np.testing.assert_allclose((lfc + hfc).numpy(), pc, rtol=0, atol=1e-5)
