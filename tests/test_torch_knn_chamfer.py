"""The port's self-kNN and Chamfer row min (pointcloudattack_tpu_torch/ops/
knn.py and ops/chamfer.py, plain versions) against the JAX package, on the
CPU.

kNN: the port and the JAX package compute the same formula, xx - 2xy + yy,
but JAX sums xy in an XLA dot whose order is not the port's, so two
neighbours whose distances lie within rounding may swap.  The index sets
must be equal, and the order equal at every position whose distance is
more than ``KNN_TOL`` from its neighbours'; the inputs are seeded so that
every row's k-th and (k+1)-th distances lie more than ``KNN_TOL`` apart
(asserted), so the sets are not left to chance.

Row min: the port follows the TPU kernel's per-coordinate formula, so its
mins match ``_min_rows_pallas_2d(interpret=True)`` within 1 ulp (XLA may
contract a multiply-add on the CPU) and the JAX CPU path (``xx - 2xy +
yy``) within 1e-5; the argmins are equal, on inputs whose two best
distances per row lie more than ``ROW_TOL`` apart (asserted).  The
gradient is the JAX custom VJP's formula: atol 1e-6.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.knn import knn as j_knn
from pointcloudattack_tpu.ops.pallas import chamfer_kernel as CK
from pointcloudattack_tpu.ops.pallas.knn_kernel import knn_pallas
from pointcloudattack_tpu_torch.ops import chamfer
from pointcloudattack_tpu_torch.ops import knn as knn_mod
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

KNN_TOL = 1e-4  # f32 rounding of xx - 2xy + yy at C <= 64 and unit-scale inputs
ROW_TOL = 1e-5


def exact_sqdist(x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    return ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)


def check_knn(got, want, x, k):
    """Index sets equal; order equal away from near ties."""
    d = exact_sqdist(x, x)
    srt = np.sort(d, axis=-1)
    assert (srt[..., k] - srt[..., k - 1]).min() > KNN_TOL, "seed gives a near tie at the k-th neighbour"
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    dk = np.take_along_axis(d, want.astype(np.int64), -1)  # [B, N, k] ascending
    gap = np.diff(dk, axis=-1)
    clear = np.ones_like(dk, dtype=bool)
    clear[..., 1:] &= gap > KNN_TOL
    clear[..., :-1] &= gap > KNN_TOL
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.mean() > 0.9


@pytest.mark.parametrize("b,n,c,k,seed", [(2, 96, 3, 20, 0), (2, 64, 64, 16, 1), (1, 100, 64, 5, 2)])
def test_knn_matches_jax(b, n, c, k, seed):
    x = np.random.RandomState(seed).randn(b, n, c).astype(np.float32)
    knn_mod.reset_launches()
    got = knn_mod.knn(torch.from_numpy(x), k).numpy()
    assert got.dtype == np.int32 and got.shape == (b, n, k)
    assert knn_mod.LAUNCHES["knn"] == 0  # the CPU runs the plain version
    check_knn(got, np.asarray(j_knn(jnp.asarray(x), k)), x, k)
    check_knn(got, np.asarray(knn_pallas(jnp.asarray(x), k, interpret=True)), x, k)
    # self is neighbour 0 where no other point is as close
    assert (got[..., 0] == np.arange(n)).mean() > 0.99


def test_knn_ties_go_to_the_lower_index():
    rng = np.random.RandomState(3)
    x = np.tile(rng.randn(1, 16, 3).astype(np.float32), (1, 4, 1))  # each point 4 times, at i, i+16, ...
    got = knn_mod.knn_plain(torch.from_numpy(x), 6).numpy()[0]
    for i in range(64):
        copies = sorted(j for j in range(64) if j % 16 == i % 16)
        assert got[i, :4].tolist() == copies
    np.testing.assert_array_equal(got, np.asarray(knn_pallas(jnp.asarray(x), 6, interpret=True))[0])


def test_knn_detaches_and_takes_a_gradient_input():
    x = torch.randn(1, 32, 8, requires_grad=True)
    idx = knn_mod.knn(x, 4)
    assert not idx.requires_grad and idx.dtype == torch.int32


def row_inputs(seed, b, n, m):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, 3).astype(np.float32)
    y = rng.randn(b, m, 3).astype(np.float32)
    srt = np.sort(exact_sqdist(x, y), axis=-1)
    assert (srt[..., 1] - srt[..., 0]).min() > ROW_TOL, "seed gives a near tie"
    return x, y


@pytest.mark.parametrize("b,n,m,seed", [(2, 70, 150, 4), (1, 300, 200, 5)])
def test_min_rows_matches_jax(b, n, m, seed):
    x, y = row_inputs(seed, b, n, m)
    chamfer.reset_launches()
    mins, arg = chamfer.min_sqdist_rows(torch.from_numpy(x), torch.from_numpy(y))
    assert chamfer.LAUNCHES["min_rows"] == 0 and arg.dtype == torch.int32
    for i in range(b):
        km, ka = CK._min_rows_pallas_2d(jnp.asarray(x[i]), jnp.asarray(y[i]), interpret=True)
        np.testing.assert_allclose(mins[i].numpy(), np.asarray(km), rtol=2e-7, atol=0)
        np.testing.assert_array_equal(arg[i].numpy(), np.asarray(ka))
    jm, ja = CK.min_sqdist_rows(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(mins.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(ja))


def test_min_rows_ties_and_ragged_rows():
    rng = np.random.RandomState(6)
    y = np.tile(rng.randn(2, 25, 3).astype(np.float32), (1, 4, 1))  # every y point 4 times
    x = np.concatenate([y[:, :30], rng.randn(2, 7, 3).astype(np.float32)], axis=1)
    mins, arg = chamfer.min_rows_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert (mins[:, :30] == 0).all()
    np.testing.assert_array_equal(arg[:, :30].numpy(), np.tile(np.arange(30) % 25, (2, 1)))
    d = exact_sqdist(x, y).astype(np.float32)
    np.testing.assert_array_equal(arg.numpy(), d.argmin(-1))  # numpy's argmin: the first index too


def test_min_rows_gradient_matches_jax_vjp():
    x, y = row_inputs(7, 2, 40, 60)
    w = np.random.RandomState(8).rand(2, 40).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(CK.min_sqdist_rows(a, b)[0] * w)

    jdx, jdy = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    (chamfer.min_sqdist_rows(tx, ty)[0] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jdy), rtol=0, atol=1e-6)
    # y takes no gradient when it needs none
    tx.grad = None
    chamfer.min_sqdist_rows(tx, torch.from_numpy(y))[0].sum().backward()
    assert tx.grad is not None
