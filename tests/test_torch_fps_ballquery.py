"""The port's sampling and grouping ops (pointcloudattack_tpu_torch/ops/
{pairwise,gather,fps,ball_query,grouping}.py) against the JAX package's, on
the CPU.

Tolerances:
  * FPS indices are equal exactly: the plain version rounds each product
    and sum on its own, in the JAX order, and ties go to the lowest index.
  * ``pairwise_sqdist`` atol 1e-5: the JAX side sums ``x . y`` in its
    matmul's order (XLA on the CPU may fuse a multiply-add), the port in a
    fixed order of separate operations.
  * Ball-query indices are equal, except in a group holding a point whose
    squared distance lies within 4 ulp of r^2 (the JAX package documents
    that such a point may flip between programs, gather_chain_kernel.py:
    127-133); the tests count such groups and print the count.
  * ``index_points`` and the grouped tensors are exact gathers; values are
    compared at atol 1e-6 where they depend on ``pairwise_sqdist``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.ball_query import query_ball_point as j_query_ball_point
from pointcloudattack_tpu.ops.fps import farthest_point_sample as j_fps
from pointcloudattack_tpu.ops.gather import index_points as j_index_points
from pointcloudattack_tpu.ops.grouping import (
    sample_and_group as j_sample_and_group,
    sample_and_group_all as j_sample_and_group_all,
)
from pointcloudattack_tpu.ops.pairwise import pairwise_sqdist as j_pairwise_sqdist
from pointcloudattack_tpu_torch.ops import fps as fps_mod
from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
from pointcloudattack_tpu_torch.ops.fps import farthest_point_sample, fps_plain
from pointcloudattack_tpu_torch.ops.gather import index_points
from pointcloudattack_tpu_torch.ops.grouping import sample_and_group, sample_and_group_all
from pointcloudattack_tpu_torch.ops.pairwise import pairwise_sqdist
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

NEAR_ULP = 4


def cloud(seed, b, n, scale=0.5):
    return (np.random.RandomState(seed).randn(b, n, 3) * scale).astype(np.float32)


def j_fps_start(xyz, npoint, start):
    """The JAX FPS scan from given start indices (its body at
    ops/fps.py:53-66; the public function takes its start from a key)."""

    def step(carry, _):
        dist, far = carry
        centroid = jnp.take_along_axis(xyz, far[:, None, None], axis=1)
        d = jnp.sum((xyz - centroid) ** 2, axis=-1)
        dist = jnp.minimum(dist, d)
        return (dist, jnp.argmax(dist, axis=-1).astype(jnp.int32)), far

    init = jnp.full(xyz.shape[:2], jnp.inf, dtype=jnp.float32)
    _, idx = jax.lax.scan(step, (init, start), None, length=npoint)
    return jnp.swapaxes(idx, 0, 1)


@pytest.mark.parametrize("n,npoint,seed", [(256, 128, 0), (1024, 512, 1), (1024, 128, 2)])
def test_fps_matches_jax_exactly(n, npoint, seed):
    x = cloud(seed, 2, n)
    want = np.asarray(j_fps(jnp.asarray(x), npoint))
    fps_mod.reset_launches()
    got = farthest_point_sample(torch.from_numpy(x), npoint)
    assert got.dtype == torch.int32 and fps_mod.LAUNCHES["fps"] == 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [256, 1024])
def test_fps_from_a_given_start_matches_jax(n):
    x = cloud(3, 2, n)
    start = np.array([5, n - 1], dtype=np.int32)
    want = np.asarray(jax.jit(j_fps_start, static_argnums=1)(jnp.asarray(x), 64, jnp.asarray(start)))
    got = farthest_point_sample(torch.from_numpy(x), 64, torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 0].tolist() == start.tolist()


def test_fps_ties_take_the_lowest_index():
    """Each point appears four times: every pick ties with its copies, and
    the JAX scan and the port both take the first."""
    base = cloud(4, 2, 64)
    x = np.concatenate([base] * 4, axis=1)  # [2, 256, 3]
    want = np.asarray(j_fps(jnp.asarray(x), 96))
    got = fps_plain(torch.from_numpy(x), 96, torch.zeros(2, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[:, :64].max()) < 64  # all 64 distinct points before any copy


def test_pairwise_sqdist_matches_jax():
    x, y = cloud(5, 2, 37), cloud(6, 2, 53)
    want = np.asarray(j_pairwise_sqdist(jnp.asarray(x), jnp.asarray(y)))
    got = pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_index_points_forward_and_gradient():
    x = cloud(7, 2, 20)
    idx = np.random.RandomState(8).randint(0, 20, size=(2, 6, 5)).astype(np.int32)
    ct = np.random.RandomState(9).randn(2, 6, 5, 3).astype(np.float32)
    want = np.asarray(j_index_points(jnp.asarray(x), jnp.asarray(idx)))
    want_grad = np.asarray(jax.grad(lambda a: jnp.sum(j_index_points(a, jnp.asarray(idx)) * ct))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = index_points(xt, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * torch.from_numpy(ct)).sum().backward()
    # duplicate indices sum their cotangents
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(index_points(xt, torch.from_numpy(idx[:, :, 0])).detach().numpy(),
                                  np.asarray(j_index_points(jnp.asarray(x), jnp.asarray(idx[:, :, 0]))))


def near_radius_groups(x, centers, radius):
    """[B, S] bool: groups with a point whose squared distance (in float64)
    lies within NEAR_ULP ulp of radius^2."""
    d = ((centers[:, :, None, :].astype(np.float64) - x[:, None, :, :]) ** 2).sum(-1)
    r2 = np.float32(radius * radius)
    return (np.abs(d - r2) <= NEAR_ULP * np.spacing(r2)).any(-1)


@pytest.mark.parametrize(
    "n,s,radius,nsample",
    [(256, 64, 0.2, 16),   # most balls short of nsample: padded with their first index
     (256, 32, 0.8, 32),   # most balls full
     (256, 16, 1e-4, 8),   # centers off the cloud: empty balls, filled with index 0
     (12, 8, 0.9, 16)],    # N < nsample
)
def test_query_ball_point_matches_jax(n, s, radius, nsample, capsys):
    x = cloud(10, 2, n)
    centers = x[:, :s] + np.float32(0.05) if radius < 1e-3 else x[:, :s]
    want = np.asarray(j_query_ball_point(radius, nsample, jnp.asarray(x), jnp.asarray(centers)))
    got = query_ball_point(radius, nsample, torch.from_numpy(x), torch.from_numpy(centers))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, s, nsample)
    near = near_radius_groups(x, centers, radius)
    differ = (got.numpy() != want).any(-1)
    with capsys.disabled():
        print(f"\n[ball query n={n} r={radius}] {int(near.sum())} of {near.size} groups hold a point "
              f"within {NEAR_ULP} ulp of r^2; {int(differ.sum())} groups differ")
    assert not (differ & ~near).any()
    if radius < 1e-3:
        assert (got.numpy() == 0).all()


def test_msg_shares_one_distance_matrix():
    x = cloud(11, 2, 128)
    c = x[:, :32]
    sqr = pairwise_sqdist(torch.from_numpy(c), torch.from_numpy(x))
    for radius, k in ((0.1, 16), (0.4, 64)):
        a = query_ball_point(radius, k, torch.from_numpy(x), torch.from_numpy(c), sqr=sqr)
        b = query_ball_point(radius, k, torch.from_numpy(x), torch.from_numpy(c))
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_points", [False, True])
def test_sample_and_group_matches_jax(with_points):
    x = cloud(12, 2, 256)
    pts = np.random.RandomState(13).randn(2, 256, 5).astype(np.float32) if with_points else None
    jp = jnp.asarray(pts) if with_points else None
    want_xyz, want_pts, want_gxyz, want_fps = j_sample_and_group(
        64, 0.3, 16, jnp.asarray(x), jp, return_fps=True)
    got_xyz, got_pts, got_gxyz, got_fps = sample_and_group(
        64, 0.3, 16, torch.from_numpy(x), torch.from_numpy(pts) if with_points else None, return_fps=True)
    np.testing.assert_array_equal(got_fps.numpy(), np.asarray(want_fps))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got_gxyz.numpy(), np.asarray(want_gxyz), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), rtol=0, atol=1e-6)
    assert got_pts.shape == (2, 64, 16, 3 + (5 if with_points else 0))

    want_xyz, want_all = j_sample_and_group_all(jnp.asarray(x), jp)
    got_xyz, got_all = sample_and_group_all(torch.from_numpy(x), torch.from_numpy(pts) if with_points else None)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(got_all.numpy(), np.asarray(want_all))


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no implementation"):
        farthest_point_sample(torch.zeros(1, 8, 3, device="meta"), 4)
