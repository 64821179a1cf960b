"""The rest of GeoA3's geometry (pointcloudattack_tpu_torch/ops/knn.py::
knn_points, losses/geometry.py::displacement_loss and knn_smoothing_loss,
geometry/normals.py::estimate_perpendicular_jitter) against the JAX
package, on the CPU.

``knn_points``: the distances within 1e-6 (both ``xx - 2xy + yy``, the
JAX package's ``xy`` an einsum that may sum in another order) and the
indices equal, exact duplicates included (ties go to the lower index on
both sides).  The two losses and their gradients atol 1e-6.

The jitter, on the same noise: each point's two largest local-covariance
eigenvectors scaled by it and clipped.  Where the two largest eigenvalues
lie well apart, and the smallest two too (gaps above ``SEPARATED`` of the
largest), the eigenvectors are well defined and the jitter agrees within
1e-6.  Elsewhere they may turn within their plane, so there the jitter is
held to what is defined: it lies in the tangent plane, within 1e-5 of
orthogonal to the normal (the smallest eigenvector), and within the clip.
On this test's cloud 500 of the 512 points are well separated, 12 not.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.geometry import normals as jnormals
from pointcloudattack_tpu.losses import geometry as jgeo
from pointcloudattack_tpu.ops.knn import knn_points as j_knn_points
from pointcloudattack_tpu_torch.geometry import normals
from pointcloudattack_tpu_torch.geometry.eig3 import sym_eigh_3x3
from pointcloudattack_tpu_torch.losses import geometry
from pointcloudattack_tpu_torch.ops.knn import knn_points
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

SEPARATED = 0.05


def tied_cloud(seed, b, n):
    """Points of which every fourth is an exact copy of the one before."""
    x = (np.random.RandomState(seed).randn(b, n, 3) * 0.5).astype(np.float32)
    x[:, 3::4] = x[:, 2::4]
    return x


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_points_matches_jax_ties_included(exclude_self):
    x, y = tied_cloud(0, 2, 96), tied_cloud(1, 2, 128)
    for a, b_ in ((x, y), (x, x)):
        d, idx = knn_points(torch.from_numpy(a), torch.from_numpy(b_), 8, exclude_self=exclude_self)
        jd, jidx = j_knn_points(jnp.asarray(a), jnp.asarray(b_), 8, exclude_self=exclude_self)
        assert idx.dtype == torch.int32 and tuple(idx.shape) == (2, 96, 8)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    # a copy and its original tie: the lower index comes first
    d, idx = knn_points(torch.from_numpy(y), torch.from_numpy(y), 2)
    np.testing.assert_array_equal(idx[:, 3::4, 0].numpy(), np.broadcast_to(np.arange(2, 128, 4), (2, 32)))


def loss_and_grad(fn, x):
    t = torch.from_numpy(x).requires_grad_(True)
    out = fn(t)
    (out * torch.linspace(0.5, 1.5, out.numel()).reshape(out.shape)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def jax_loss_and_grad(fn, x, shape, jit=True):
    w = jnp.linspace(0.5, 1.5, int(np.prod(shape))).reshape(shape)
    both = lambda a: (fn(a), jax.grad(lambda b: jnp.sum(fn(b) * w))(a))  # noqa: E731
    out, g = (jax.jit(both) if jit else both)(jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def test_displacement_loss_matches_jax():
    ori = tied_cloud(2, 2, 128)
    adv = ori + (np.random.RandomState(3).randn(*ori.shape) * 1e-2).astype(np.float32)
    got, g = loss_and_grad(lambda a: geometry.displacement_loss(a, torch.from_numpy(ori), 16), adv)
    # eager: XLA takes longer to compile this one than to run it op by op
    want, jg = jax_loss_and_grad(lambda a: jgeo.displacement_loss(a, jnp.asarray(ori), 16), adv, got.shape, jit=False)
    assert got.shape == (2, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)


def test_knn_smoothing_loss_matches_jax():
    adv = tied_cloud(4, 2, 128)
    adv[:, :6] *= 3.0  # a few outliers above the threshold
    got, g = loss_and_grad(lambda a: geometry.knn_smoothing_loss(a, 5, 1.05), adv)
    want, jg = jax_loss_and_grad(lambda a: jgeo.knn_smoothing_loss(a, 5, 1.05), adv, got.shape)
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)
    # the mask takes no gradient: only the points above it move
    moved = np.abs(g).sum(-1) > 0
    assert 0 < moved.sum() < moved.size


@pytest.mark.parametrize("sigma,clip", [(0.01, 0.05), (0.05, 0.02)], ids=["reference", "clipping"])
def test_perpendicular_jitter_matches_jax_on_the_same_noise(sigma, clip):
    pc = (np.random.RandomState(5).randn(2, 256, 3) * 0.5).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(lambda p, k: jnormals.estimate_perpendicular_jitter(p, 16, k, sigma=sigma, clip=clip))(
        jnp.asarray(pc), key))
    k1, k2 = jax.random.split(key)
    a1, a2 = (np.asarray(sigma * jax.random.normal(kk, (2, 256, 1), jnp.float32)) for kk in (k1, k2))
    got = normals.jitter_from_noise(torch.from_numpy(pc), 16, torch.from_numpy(a1), torch.from_numpy(a2),
                                    clip).numpy()
    cov, _ = normals._local_cov(torch.from_numpy(pc), 16)
    vals, vecs = (t.numpy() for t in sym_eigh_3x3(cov))
    top = vals[..., 2:3]
    sep = (((vals[..., 2] - vals[..., 1]) > SEPARATED * vals[..., 2])
           & ((vals[..., 1] - vals[..., 0]) > SEPARATED * vals[..., 2]))
    assert 0.5 < sep.mean() < 1.0, f"{int(sep.sum())} of {sep.size} points well separated"
    np.testing.assert_allclose(got[sep], want[sep], rtol=0, atol=1e-6)
    # everywhere: in the tangent plane where nothing was clipped, and within the clip
    clipped = (np.abs(vecs[..., :, 2] * a1) >= clip) | (np.abs(vecs[..., :, 1] * a2) >= clip)
    free = ~clipped.any(-1)
    normal_part = np.abs((got * vecs[..., :, 0]).sum(-1))
    assert normal_part[free].max() <= 1e-5 and (np.abs(got) <= 2 * clip).all() and (top > 0).all()
    if clip < 0.05:
        assert clipped.any(-1).mean() > 0.1  # the clip binds here
    # the generator's draws: the same jitter from the same seed, none from another
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    j1, j2, j3 = (normals.estimate_perpendicular_jitter(torch.from_numpy(pc), 16, gen(s), sigma=sigma, clip=clip)
                  for s in (0, 0, 1))
    assert torch.equal(j1, j2) and not torch.equal(j1, j3)
