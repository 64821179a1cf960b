"""GeoA3's two kernels' plain versions (pointcloudattack_tpu_torch/ops/
kappa.py and ops/chamfer.py::min_sqdist_both) against the JAX package, on
the CPU.

Both follow the TPU kernels' exact per-coordinate distance, so they are held
to the JAX package's forms of it: the curvature to ``reference_kappa_xla``
(the kernel's XLA twin) and to ``kappa_knn_mean(..., interpret=True)`` at
rtol 1e-5 (XLA on the CPU may contract a multiply-add that the port rounds
on its own), its gradients to the interpret-mode kernel's within 1e-6 of
their largest entry (the sums run in another order); the two-direction
bundle to ``min_sqdist_both`` in interpret mode (``_BOTH_INTERPRET``):
mins within 1 ulp, argmins equal, gradients atol 1e-6.  At a ragged N the
interpret-mode kernels do not run (the TPU's row blocks), so the JAX
package's CPU paths hold the port there: the curvature oracle, and the
dense ``xx - 2xy + yy`` bundle, whose distances differ from the exact ones
by rounding (atol 1e-5).

The curvature on a given neighbour set (``kappa_knn_mean_from_idx``) is
held to the interpret-mode TPU kernel (f32-exact here: its body is
elementwise) and to the JAX package's CPU gather route (``_neighbour_offsets``
and ``_masked_unit_projection`` on the same indices, which normalises each
offset before projecting): kappa atol 1e-6, both gradients atol 1e-5, on a
stale set (taken on the cloud, the cloud then moved by about 1e-2), with a
cached neighbour moved onto its centre (it adds 0, its gradient finite),
and at a ragged N=1000 against the gather route alone, whose gradients
there lie within 1e-5 of their largest entry (``hold_gather_route``).
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.losses import geometry as jgeo
from pointcloudattack_tpu.losses.distance import chamfer_hausdorff_nn as j_bundle
from pointcloudattack_tpu.ops.pallas import chamfer_kernel as CK
from pointcloudattack_tpu.ops.pallas import kappa_kernel as KK
from pointcloudattack_tpu_torch.losses.distance import chamfer_hausdorff_nn
from pointcloudattack_tpu_torch.ops import chamfer, kappa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its stale neighbour sets)
from torch_threads import threads  # noqa: E402

torch_threads = threads(1)  # tests/torch_threads.py says why

K = 16


def unit_normals(rng, b, n):
    nr = rng.randn(b, n, 3).astype(np.float32)
    return nr / np.linalg.norm(nr, axis=-1, keepdims=True)


def cloud(seed, b, n, dup=False):
    rng = np.random.RandomState(seed)
    a = (rng.randn(b, n // 2 if dup else n, 3) * 0.5).astype(np.float32)
    if dup:  # every point twice: point i at i and i + n/2
        a = np.concatenate([a, a], axis=1)
    return a, unit_normals(rng, b, n), rng.randn(b, n).astype(np.float32)


def exact_sqdist(x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    return ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)


def port_kappa(a, nr, w):
    """kappa, its picks, and the gradients of sum(kappa * w)."""
    ta = torch.from_numpy(a).requires_grad_(True)
    tn = torch.from_numpy(nr).requires_grad_(True)
    kappa.reset_launches()
    kap = kappa.kappa_knn_mean(ta, tn, K)
    (kap * torch.from_numpy(w)).sum().backward()
    assert kappa.LAUNCHES == {"kappa_fwd": 0, "kappa_bwd": 0, "kappa_idx_fwd": 0,
                              "kappa_idx_bwd": 0}  # the plain versions on the CPU
    return kap.detach().numpy(), kappa.kappa_plain(torch.from_numpy(a), torch.from_numpy(nr), K)[1].numpy(), \
        ta.grad.numpy(), tn.grad.numpy()


def jax_grads(fn, a, nr, w):
    return [np.asarray(g) for g in jax.jit(jax.grad(lambda x, n: jnp.sum(fn(x, n) * w), argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(nr))]


def hold_grads(got, want):
    for g, j in zip(got, want):
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-6 * np.abs(j).max())


@pytest.mark.parametrize("seed,dup", [(0, False), (1, False), (2, True)])
def test_kappa_matches_the_jax_oracle_and_interpret_kernel(seed, dup):
    a, nr, w = cloud(seed, 2, 256, dup)
    kap, picks, da, dn = port_kappa(a, nr, w)
    np.testing.assert_allclose(kap, np.asarray(KK.reference_kappa_xla(jnp.asarray(a), jnp.asarray(nr), K)),
                               rtol=1e-5, atol=0 if not dup else 1e-7)
    itp = lambda x, n: KK.kappa_knn_mean(x, n, K, True)  # noqa: E731
    np.testing.assert_allclose(kap, np.asarray(itp(jnp.asarray(a), jnp.asarray(nr))), rtol=1e-5, atol=1e-7)
    hold_grads((da, dn), jax_grads(itp, a, nr, w))
    # the picks: the (k + 1) lexicographically smallest (distance, index) pairs, the first dropped
    d = exact_sqdist(a, a).astype(np.float32)
    order = np.argsort(d, axis=-1, kind="stable")[..., 1 : K + 1]
    np.testing.assert_array_equal(picks, order)


def test_kappa_exact_duplicates_add_zero():
    """Each point has a copy at distance 0: the copy is one of its picks
    (the lower index of the two comes first and is dropped), it adds 0, and
    every gradient stays finite."""
    a, nr, w = cloud(3, 1, 64, dup=True)
    kap, picks, da, dn = port_kappa(a, nr, w)
    i = np.arange(64)
    copy = (i + 32) % 64
    assert (picks[0] == np.maximum(i, copy)[:, None]).any(-1)[copy > i].all()  # the later copy stays a pick
    assert (picks[0, :, 0] == i)[i >= 32].all()  # a later copy keeps itself: the earlier one was dropped
    assert np.isfinite(kap).all() and np.isfinite(da).all() and np.isfinite(dn).all()
    # the zero-distance pick adds 0: kappa is the sum over the other picks, over k
    d = exact_sqdist(a, a)[0]
    aj = a[0][picks[0]]
    num = np.abs(((aj - a[0][:, None]) * nr[0][:, None]).sum(-1))
    dk = np.take_along_axis(d, picks[0].astype(np.int64), -1)
    assert ((dk > 0).sum(-1) == K - 1).all()
    want = np.where(dk > 0, num / (np.sqrt(dk) + kappa.EPS), 0.0).sum(-1) / K
    np.testing.assert_allclose(kap[0], want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [200, 100])
def test_kappa_ragged_n_matches_the_jax_oracle(n):
    a, nr, w = cloud(4 + n, 2, n)
    kap, _, da, dn = port_kappa(a, nr, w)
    oracle = lambda x, nn: KK.reference_kappa_xla(x, nn, K)  # noqa: E731
    np.testing.assert_allclose(kap, np.asarray(oracle(jnp.asarray(a), jnp.asarray(nr))), rtol=1e-5, atol=0)
    # the oracle normalises each offset before projecting (another formula): 1e-5 of the largest entry
    for g, j in zip((da, dn), jax_grads(oracle, a, nr, w)):
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-5 * np.abs(j).max())


def test_kappa_plain_backward_matches_autograd_through_the_plain_forward():
    """The explicit backward is the derivative of the plain forward."""
    a, nr, w = cloud(5, 2, 128)
    _, picks, da, dn = port_kappa(a, nr, w)
    ta = torch.from_numpy(a).double().requires_grad_(True)
    tn = torch.from_numpy(nr).double().requires_grad_(True)
    aj = ta[torch.arange(2)[:, None, None], torch.from_numpy(picks).long()]
    v = aj - ta[:, :, None, :]
    proj = ((v * tn[:, :, None, :]).sum(-1)).abs() / (v.norm(dim=-1) + kappa.EPS)
    (proj.mean(-1) * torch.from_numpy(w).double()).sum().backward()
    np.testing.assert_allclose(da, ta.grad.numpy(), rtol=0, atol=1e-5 * np.abs(da).max())
    np.testing.assert_allclose(dn, tn.grad.numpy(), rtol=0, atol=1e-5 * np.abs(dn).max())


def stale_set(seed, n, collide=False):
    """A cloud moved by about 1e-2 after its neighbour sets were taken, the
    sets, and with ``collide`` the 8 rows whose fifth cached neighbour was
    then moved exactly onto its centre (``chip_smoke.stale_idx``)."""
    a, nr, w = cloud(seed, 2, n)
    moved = a + (np.random.RandomState(seed + 50).randn(*a.shape) * 1e-2).astype(np.float32)
    idx, hit, rows = chip_smoke.stale_idx(torch.from_numpy(moved), torch.from_numpy(a))
    return (hit.numpy(), nr, w, idx, rows) if collide else (moved, nr, w, idx, [])


def port_kappa_idx(a, nr, idx, w):
    ta = torch.from_numpy(a).requires_grad_(True)
    tn = torch.from_numpy(nr).requires_grad_(True)
    kappa.reset_launches()
    kap = kappa.kappa_knn_mean_from_idx(ta, tn, idx, K)
    (kap * torch.from_numpy(w)).sum().backward()
    assert kappa.LAUNCHES == {"kappa_fwd": 0, "kappa_bwd": 0, "kappa_idx_fwd": 0,
                              "kappa_idx_bwd": 0}  # the plain versions on the CPU
    return kap.detach().numpy(), ta.grad.numpy(), tn.grad.numpy()


def jax_gather_route(a, nr, idx):
    """The JAX package's CPU route for a given set: the offsets gathered,
    each normalised, projected and masked at exact collisions."""
    return jgeo._masked_unit_projection(jgeo._neighbour_offsets(a, a, idx), nr)


def hold_gather_route(kap, grads, a, nr, w, idx, relative=False):
    """kappa atol 1e-6, the gradients atol 1e-5 or, with ``relative``, 1e-5
    of their largest entry (the route differentiates ``unit(v) . n``,
    another formula, which at a cloud's closest pairs rounds some 30 ulp
    apart: 1.5e-5 at the ragged cloud's largest gradient, 10.7)."""
    fn = lambda x, n: jax_gather_route(x, n, jnp.asarray(idx.numpy()))  # noqa: E731
    np.testing.assert_allclose(kap, np.asarray(fn(jnp.asarray(a), jnp.asarray(nr))), rtol=0, atol=1e-6)
    for g, j in zip(grads, jax_grads(fn, a, nr, w)):
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-5 * (np.abs(j).max() if relative else 1.0))


@pytest.mark.parametrize("collide", [False, True], ids=["stale", "collision"])
def test_kappa_from_idx_matches_the_interpret_kernel_and_the_gather_route(collide):
    a, nr, w, idx, rows = stale_set(8, 256, collide)
    kap, da, dn = port_kappa_idx(a, nr, idx, w)
    itp = lambda x, n: KK.kappa_knn_mean_from_idx(x, n, jnp.asarray(idx.numpy()), K, True)  # noqa: E731
    np.testing.assert_allclose(kap, np.asarray(itp(jnp.asarray(a), jnp.asarray(nr))), rtol=0, atol=1e-6)
    for g, j in zip((da, dn), jax_grads(itp, a, nr, w)):
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-5)
    hold_gather_route(kap, (da, dn), a, nr, w, idx)
    d = exact_sqdist(a, a)[np.arange(2)[:, None, None], np.arange(256)[None, :, None], idx.numpy()]
    assert len(rows) == (8 if collide else 0) and (d[0, rows, 4] == 0).all()
    assert (d == 0).sum() >= 8 if collide else (d > 0).all()
    assert np.isfinite(da).all() and np.isfinite(dn).all()
    if collide:  # the collided edge adds 0: kappa is the other edges' sum over k
        v = a[0][idx[0, rows].numpy()] - a[0, rows][:, None]
        num = np.abs((v * nr[0, rows][:, None]).sum(-1))
        dd = d[0, rows]
        want = np.where(dd > 0, num / (np.sqrt(np.where(dd > 0, dd, 1.0)) + kappa.EPS), 0.0).sum(-1) / K
        np.testing.assert_allclose(kap[0, rows], want, rtol=1e-5, atol=0)
    # on its own selection's picks it is the selecting curvature, bit for bit
    picks = kappa.kappa_plain(torch.from_numpy(a), torch.from_numpy(nr), K)[1]
    np.testing.assert_array_equal(kappa.kappa_idx_plain(torch.from_numpy(a), torch.from_numpy(nr), picks, K).numpy(),
                                  kappa.kappa_plain(torch.from_numpy(a), torch.from_numpy(nr), K)[0].numpy())


def test_kappa_from_idx_ragged_n_matches_the_gather_route():
    a, nr, w, idx, _ = stale_set(9, 1000)
    kap, da, dn = port_kappa_idx(a, nr, idx, w)
    hold_gather_route(kap, (da, dn), a, nr, w, idx, relative=True)


def test_kappa_from_idx_takes_exactly_k_columns():
    a = torch.zeros(1, 32, 3)
    with pytest.raises(ValueError, match="exactly k columns"):
        kappa.kappa_knn_mean_from_idx(a, a, torch.zeros(1, 32, K - 1, dtype=torch.int32), K)


def bundle_inputs(seed, b, n, m):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, n, 3) * 0.5).astype(np.float32)
    y = (rng.randn(b, m, 3) * 0.5).astype(np.float32)
    d = exact_sqdist(x, y)
    for ax in (-1, -2):
        srt = np.sort(d, axis=ax)
        gap = np.take(srt, 1, axis=ax) - np.take(srt, 0, axis=ax)
        assert gap.min() > 1e-6, "seed gives a near tie"
    return x, y, rng.randn(b, n).astype(np.float32), rng.randn(b, m).astype(np.float32)


def jax_both_grads(x, y, wr, wc):
    """The JAX package's gradients of sum(row_min * wr) + sum(col_min * wc)."""
    def loss(a, b):
        rmin, cmin, _ = CK.min_sqdist_both(a, b)
        return jnp.sum(rmin * wr) + jnp.sum(cmin * wc)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))


def port_both(x, y, wr, wc):
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    chamfer.reset_launches()
    rmin, cmin, rarg = chamfer.min_sqdist_both(tx, ty)
    ((rmin * torch.from_numpy(wr)).sum() + (cmin * torch.from_numpy(wc)).sum()).backward()
    assert chamfer.LAUNCHES == {"min_rows": 0, "both_fwd": 0, "both_bwd": 0}
    assert rarg.dtype == torch.int32 and not rarg.requires_grad
    return rmin.detach().numpy(), cmin.detach().numpy(), rarg.numpy(), tx.grad.numpy(), ty.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_both_matches_the_interpret_kernel(seed, monkeypatch):
    monkeypatch.setattr(CK, "_BOTH_INTERPRET", True)
    x, y, wr, wc = bundle_inputs(seed, 2, 256, 128)
    rmin, cmin, rarg, dx, dy = port_both(x, y, wr, wc)
    jr, jc, ja = CK.min_sqdist_both(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(rmin, np.asarray(jr), rtol=2e-7, atol=0)
    np.testing.assert_allclose(cmin, np.asarray(jc), rtol=2e-7, atol=0)
    np.testing.assert_array_equal(rarg, np.asarray(ja))
    _, _, _, carg = CK._both_fwd(jnp.asarray(x), jnp.asarray(y), interpret=True)
    np.testing.assert_array_equal(chamfer.both_plain(torch.from_numpy(x), torch.from_numpy(y))[3].numpy(),
                                  np.asarray(carg))
    jdx, jdy = jax_both_grads(x, y, wr, wc)
    np.testing.assert_allclose(dx, np.asarray(jdx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dy, np.asarray(jdy), rtol=0, atol=1e-6)


def test_both_ragged_matches_the_jax_cpu_path():
    x, y, wr, wc = bundle_inputs(2, 2, 1000, 1000)
    rmin, cmin, rarg, dx, dy = port_both(x, y, wr, wc)
    d = exact_sqdist(x, y)
    np.testing.assert_array_equal(rarg, d.argmin(-1))
    np.testing.assert_array_equal(chamfer.both_plain(torch.from_numpy(x), torch.from_numpy(y))[3].numpy(),
                                  d.argmin(-2))
    jr, jc, ja = CK.min_sqdist_both(jnp.asarray(x), jnp.asarray(y))  # the dense xx - 2xy + yy path
    np.testing.assert_allclose(rmin, np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(cmin, np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(rarg, np.asarray(ja))
    jdx, jdy = jax_both_grads(x, y, wr, wc)
    np.testing.assert_allclose(dx, np.asarray(jdx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dy, np.asarray(jdy), rtol=0, atol=1e-5)


def test_both_ties_go_to_the_first_index_and_the_scatter_sums_in_order():
    rng = np.random.RandomState(6)
    y = np.tile(rng.randn(1, 20, 3).astype(np.float32), (1, 3, 1))  # every y point 3 times
    x = np.concatenate([y[:, :25], rng.randn(1, 9, 3).astype(np.float32)], axis=1)
    rmin, rarg, cmin, carg = (t.numpy() for t in chamfer.both_plain(torch.from_numpy(x), torch.from_numpy(y)))
    assert (rmin[:, :25] == 0).all()
    np.testing.assert_array_equal(rarg[0, :25], np.arange(25) % 20)  # a copy's first occurrence
    np.testing.assert_array_equal(carg, exact_sqdist(x, y).astype(np.float32).argmin(-2))
    gr, gc = rng.randn(1, 34).astype(np.float32), rng.randn(1, 60).astype(np.float32)
    dx, dy = chamfer.both_bwd_plain(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(rarg),
                                    torch.from_numpy(carg), torch.from_numpy(gr), torch.from_numpy(gc))
    # the same sums written out, each point's matches added in ascending index
    want_dx = 2 * gr[0, :, None] * (x[0] - y[0, rarg[0]])
    want_dy = 2 * gc[0, :, None] * (y[0] - x[0, carg[0]])
    for j in range(60):
        want_dx[carg[0, j]] = want_dx[carg[0, j]] - 2 * gc[0, j] * (y[0, j] - x[0, carg[0, j]])
    for i in range(34):
        want_dy[rarg[0, i]] = want_dy[rarg[0, i]] - 2 * gr[0, i] * (x[0, i] - y[0, rarg[0, i]])
    np.testing.assert_array_equal(dx.numpy()[0], want_dx)
    np.testing.assert_array_equal(dy.numpy()[0], want_dy)


@pytest.mark.parametrize("case", ["hub", "N=1"])
def test_both_plain_matches_jax_at_the_kernels_edges(case, monkeypatch):
    """The plain bundle, which the kernels are held to bit for bit, against
    the JAX package where the kernels' keys and lists matter: a hub (every y
    point's nearest is x's point 0, whose backward sums all M terms; against
    the interpret-mode kernel, its gradients within 1e-6 of their largest
    entry: the hub's sum of 256 terms runs in another order) and one x point
    (against the dense CPU path, mins atol 1e-5)."""
    if case == "hub":
        monkeypatch.setattr(CK, "_BOTH_INTERPRET", True)
        x, y = (t.numpy() for t in chip_smoke.both_case(30, 2, 128, 256, "hub", device="cpu"))
    else:
        x, y = (t.numpy() for t in chip_smoke.both_case(31, 2, 1, 300, "random", device="cpu"))
    d = exact_sqdist(x, y)
    for ax in (-1, -2):
        srt = np.sort(d, axis=ax)
        if srt.shape[ax] > 1:
            assert (np.take(srt, 1, axis=ax) - np.take(srt, 0, axis=ax)).min() > 1e-6, "seed gives a near tie"
    rng = np.random.RandomState(32)
    wr, wc = rng.randn(*x.shape[:2]).astype(np.float32), rng.randn(*y.shape[:2]).astype(np.float32)
    rmin, cmin, rarg, dx, dy = port_both(x, y, wr, wc)
    carg = chamfer.both_plain(torch.from_numpy(x), torch.from_numpy(y))[3].numpy()
    np.testing.assert_array_equal(rarg, d.argmin(-1))
    np.testing.assert_array_equal(carg, d.argmin(-2))
    if case == "hub":
        assert (carg == 0).all()
    jr, jc, ja = CK.min_sqdist_both(jnp.asarray(x), jnp.asarray(y))
    tol = dict(rtol=2e-7, atol=0) if case == "hub" else dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(rmin, np.asarray(jr), **tol)
    np.testing.assert_allclose(cmin, np.asarray(jc), **tol)
    np.testing.assert_array_equal(rarg, np.asarray(ja))
    jdx, jdy = (np.asarray(g) for g in jax_both_grads(x, y, wr, wc))
    np.testing.assert_allclose(dx, jdx, rtol=0, atol=1e-6 * np.abs(jdx).max())
    np.testing.assert_allclose(dy, jdy, rtol=0, atol=1e-6 * np.abs(jdy).max())


def test_chamfer_hausdorff_nn_matches_jax():
    x, y, _, _ = bundle_inputs(7, 2, 300, 300)
    ta = torch.from_numpy(x).requires_grad_(True)
    got = chamfer_hausdorff_nn(ta, torch.from_numpy(y))
    want = j_bundle(jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    (got[0] + got[1] + 0.1 * got[2]).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(sum(w * t for w, t in zip((1.0, 1.0, 0.1), j_bundle(a, jnp.asarray(y))[:3]))))(
        jnp.asarray(x))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
