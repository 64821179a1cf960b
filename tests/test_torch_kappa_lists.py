"""The curvature backward in the order the CUDA kernel sums it, on the CPU.

``csrc/kappa.cu``'s backward first sorts each cloud's picks (or given
indices) into every point's incoming edges, a stable counting sort
(``ops/kappa.py::kappa_lists_plain`` is its plain version), then sums each
point's own edges in pick order and its incoming edges, recomputed from
``(i, t)``, in list order (``kappa_bwd_lists_plain``).  Here both are held:
the lists to a stable argsort, out-of-range indices unlisted; the backward
to ``kappa_bwd_plain`` bit for bit, and to the JAX package within the
tolerances of ``tests/test_torch_geoa3_kernels.py``: on the selecting
curvature, ``reference_kappa_xla`` through ``jax.vjp``, or with exact
duplicates, where the oracle's gradient at a zero offset is NaN, the
interpret-mode TPU kernel ``kappa_knn_mean``, both within 1e-5 of the
largest gradient (the oracle normalises each offset before projecting, the
kernel sums in another order); on a given set, the interpret-mode TPU kernel
``kappa_knn_mean_from_idx`` (atol 1e-5), or where that kernel does not take
the set, the JAX package's CPU gather route (1e-5 of the largest gradient).
The cases: exact duplicates (every point twice), a ragged N, a hub point
that every row picks, 8 exact collisions, and indices outside the cloud,
which add nothing on either end: the bits of a pick of the row itself, an
edge at distance 0.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudattack_tpu.losses import geometry as jgeo
from pointcloudattack_tpu.ops.pallas import kappa_kernel as KK
from pointcloudattack_tpu_torch.ops import kappa

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its stale neighbour sets)
from torch_threads import threads  # noqa: E402

torch_threads = threads(1)  # tests/torch_threads.py says why

K = 16


def cloud(seed, b, n, dup=False):
    rng = np.random.RandomState(seed)
    a = (rng.randn(b, n // 2 if dup else n, 3) * 0.5).astype(np.float32)
    if dup:  # every point twice: point i at i and i + n/2
        a = np.concatenate([a, a], axis=1)
    nr = rng.randn(b, n, 3).astype(np.float32)
    return a, nr / np.linalg.norm(nr, axis=-1, keepdims=True), rng.randn(b, n).astype(np.float32)


def jax_vjp(fn, a, nr, w):
    """The gradients of ``sum(fn(a, nr) * w)`` in ``a`` and ``nr``, by
    ``jax.vjp``."""
    _, pull = jax.vjp(fn, jnp.asarray(a), jnp.asarray(nr))
    return [np.asarray(g) for g in pull(jnp.asarray(w))]


def list_order(a, nr, idx, w):
    """The lists and the list-ordered backward of ``sum(kappa * w)`` on the
    neighbours ``idx``."""
    ta, tn, tw = torch.from_numpy(a), torch.from_numpy(nr), torch.from_numpy(w)
    start, lst = kappa.kappa_lists_plain(idx, a.shape[1])
    return (start, lst), kappa.kappa_bwd_lists_plain(ta, tn, idx, tw, K, start, lst)


def bit_equal(got, want):
    for g, p in zip(got, want):
        assert torch.equal(g, p), float((g - p).abs().max())


@pytest.mark.parametrize("n,case", [(256, "distinct"), (256, "duplicates"), (100, "ragged"),
                                    (64, "outside"), (64, "hub")])
def test_kappa_lists_are_a_stable_sort_of_the_picks(n, case):
    rng = np.random.RandomState(n)
    idx = torch.from_numpy(rng.randint(0, n, size=(2, n, K)).astype(np.int32))
    if case == "duplicates":
        idx[:, :, 1] = idx[:, :, 0]
    elif case == "outside":
        idx[0, ::3, 2], idx[1, ::5, 7] = -1, n
    elif case == "hub":
        idx[:, :, 4] = 5
    start, lst = kappa.kappa_lists_plain(idx, n)
    flat = idx.reshape(2, -1).numpy()
    for b in range(2):
        inside = np.flatnonzero((flat[b] >= 0) & (flat[b] < n))
        want = inside[np.argsort(flat[b][inside], kind="stable")]  # ascending (i, t) within each point
        assert int(start[b, -1]) == len(inside)
        np.testing.assert_array_equal(lst[b, : len(inside)].numpy(), want)
        counts = np.bincount(flat[b][inside], minlength=n)
        np.testing.assert_array_equal(np.diff(start[b].numpy()), counts)
    if case == "hub":
        assert int((start[:, 6] - start[:, 5]).min()) >= n


@pytest.mark.parametrize("seed,n,dup", [(0, 256, False), (1, 256, True), (2, 200, False), (3, 100, False)],
                         ids=["distinct", "duplicates", "ragged-200", "ragged-100"])
def test_kappa_bwd_in_list_order_matches_plain_and_the_jax_oracle(seed, n, dup):
    a, nr, w = cloud(seed, 2, n, dup)
    ta, tn, tw = torch.from_numpy(a), torch.from_numpy(nr), torch.from_numpy(w)
    _, picks = kappa.kappa_plain(ta, tn, K)
    _, got = list_order(a, nr, picks, w)
    bit_equal(got, kappa.kappa_bwd_plain(ta, tn, picks, tw, K))
    if dup:  # the oracle's gradient is NaN at a zero offset: the interpret-mode kernel
        ref = lambda x, nn: KK.kappa_knn_mean(x, nn, K, True)  # noqa: E731
    else:
        ref = lambda x, nn: KK.reference_kappa_xla(x, nn, K)  # noqa: E731
    for g, j in zip(got, jax_vjp(ref, a, nr, w)):
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("case", ["stale", "collide", "hub", "outside", "ragged"])
def test_kappa_idx_bwd_in_list_order_matches_plain_and_the_interpret_kernel(case):
    """A given set: the cloud's own sets, stale on an iterate 1e-2 away;
    with 8 of them moved exactly onto their centre; with every row's fifth
    neighbour one hub point; with indices outside the cloud beside the
    collisions (held against the set with those indices replaced by the row
    itself); at a ragged N = 300."""
    n = 300 if case == "ragged" else 256
    a, nr, w = cloud(8, 2, n)
    moved = a + (np.random.RandomState(58).randn(*a.shape) * 1e-2).astype(np.float32)
    idx, hit, rows = chip_smoke.stale_idx(torch.from_numpy(moved), torch.from_numpy(a))
    x = hit.numpy() if case in ("collide", "outside") else moved
    if case == "hub":
        idx[:, :, 4] = 11
    plain_idx = idx.clone()
    if case == "outside":
        idx[0, ::5, 2], idx[1, ::7, 9] = -1, n + 5
        plain_idx = torch.where((idx < 0) | (idx >= n), torch.arange(n, dtype=idx.dtype)[None, :, None], idx)
    (start, _), got = list_order(x, nr, idx, w)
    tx, tn, tw = torch.from_numpy(x), torch.from_numpy(nr), torch.from_numpy(w)
    bit_equal(got, kappa.kappa_bwd_plain(tx, tn, plain_idx, tw, K))
    assert int(start[:, -1].sum()) == int(((idx >= 0) & (idx < n)).sum())
    if case == "hub":
        assert int((start[:, 12] - start[:, 11]).min()) >= n
    jidx = jnp.asarray(plain_idx.numpy())
    # the TPU kernel's row blocks do not take N = 300, and its column mask adds a repeated index once (the
    # hub repeats one in some rows): there the gather route, which adds it once per slot as the port does
    route = case in ("ragged", "hub")
    if route:
        ref = lambda p, q: jgeo._masked_unit_projection(jgeo._neighbour_offsets(p, p, jidx), q)  # noqa: E731
    else:
        ref = lambda p, q: KK.kappa_knn_mean_from_idx(p, q, jidx, K, True)  # noqa: E731
    for g, j in zip(got, jax_vjp(ref, x, nr, w)):
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-5 * (np.abs(j).max() if route else 1.0))
    assert all(bool(torch.isfinite(g).all()) for g in got)
