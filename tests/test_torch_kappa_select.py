"""A CPU model of the selection that the curvature forward runs on the card
(``csrc/select_common.cuh`` as ``csrc/kappa.cu::kappa_fwd_kernel`` calls it
for the k + 1 smallest (distance, index) pairs of each row), held to the
stable sort of ``ops/kappa.py::kappa_plain``.

The model follows the kernel step by step: the 64 share minima of a row
(entry j in share j % 64, as the warp's lanes keep them while writing the
distances), the bound (the (k+1)-th smallest of the minima), the gather of
every entry at or below it into a buffer of 128 pairs, and the order of the
gathered pairs by (distance, index); past k + 1 = 64, or where more than
128 entries lie under the bound, the k + 1 passes, each taking the
smallest pair after the last one, which is the stable order itself.  The
tests show on GeoA3's synthetic clouds, at a ragged N, with every point 4
times and with a hub of 300 copies of one point, at k = 1, 16, 63 and 64,
that the bound always admits the k + 1 smallest pairs, that the gather
holds a few more than k + 1 of them at k = 16, that an overfull gather (a
hub's rows; every row at k = 63) or k + 1 = 65 takes the passes, and that
the model's picks are the plain version's.
"""

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds
from pointcloudattack_tpu_torch.ops import kappa
from pointcloudattack_tpu_torch.ops.chamfer import exact_sqdist
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

SHARES, CAP = 64, 128  # select_common.cuh's kShares and kCap


def select_model(d: np.ndarray, k: int):
    """The kernel's selection of the k smallest pairs of each row of ``d
    [R, N]``: ``(picks [R, k], sorted [R] bool, gathered [R], tau [R])``, a
    row ``sorted`` where the bound and the gather served it (else the
    passes did), ``gathered`` its pairs at or below the bound ``tau``."""
    r, n = d.shape
    padded = np.full((r, -(-n // SHARES) * SHARES), np.inf, np.float32)
    padded[:, :n] = d
    mins = padded.reshape(r, -1, SHARES).min(axis=1)  # share s holds the entries j % 64 == s
    tau = np.sort(mins, axis=1)[:, k - 1] if k <= SHARES else np.full(r, np.inf, np.float32)
    under = d <= tau[:, None]
    gathered = under.sum(axis=1)
    served = (gathered <= CAP) & (k <= SHARES)
    # the gathered pairs in (distance, index) order: a stable sort with the others pushed past them
    by_sort = np.argsort(np.where(under, d, np.inf), axis=1, kind="stable")[:, :k]
    by_passes = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.where(served[:, None], by_sort, by_passes), served, gathered, tau


def cloud(case):
    rng = np.random.RandomState(5)
    if case == "geoa3":
        return make_synthetic_clouds(8, 1, 1024, seed=5)[0]
    if case == "ragged":
        return make_synthetic_clouds(4, 1, 1000, seed=5)[0]
    if case == "copies":  # every point 4 times
        return np.concatenate([rng.randn(2, 256, 3).astype(np.float32) * 0.5] * 4, axis=1)
    a = rng.randn(2, 1024, 3).astype(np.float32) * 0.5  # a hub: 300 copies of point 0
    a[:, :300] = a[:, :1]
    return a


@pytest.mark.parametrize("case,k,passes", [
    ("geoa3", 16, "none"), ("geoa3", 1, "none"), ("ragged", 16, "none"), ("geoa3", 63, "all"),
    ("geoa3", 64, "all"), ("copies", 16, "none"), ("hub", 16, "hub rows"), ("hub", 1, "hub rows"),
])
def test_selection_model_gives_the_plain_picks(case, k, passes):
    """k neighbours take the k + 1 smallest pairs: the bound admits them
    wherever it serves, the picks are kappa_plain's, and the passes run
    exactly where they must.  At k = 63 the bound is the largest of the 64
    minima, so loose that every row of GeoA3's clouds gathers more than 128
    pairs (262 at the median) and takes the passes; at k = 64 the bound
    does not serve."""
    a = torch.from_numpy(cloud(case))
    d = exact_sqdist(a, a).numpy()  # [B, N, N]
    b, n, _ = d.shape
    rows = d.reshape(b * n, n)
    picks, served, gathered, tau = select_model(rows, k + 1)
    kth = np.sort(rows, axis=1)[:, k]  # the (k+1)-th smallest distance of each row
    assert bool((kth[served] <= tau[served]).all())  # the bound admits the k + 1 smallest pairs
    assert bool((gathered[served] >= k + 1).all())
    _, want = kappa.kappa_plain(a, torch.zeros_like(a), k)
    assert np.array_equal(picks[:, 1:].reshape(b, n, k), want.numpy())
    if passes == "none":
        assert bool(served.all())
    elif passes == "all":
        assert not bool(served.any())
    else:  # the hub's rows hold 300 pairs at distance 0, more than the buffer's 128, and so do rows
        # whose bound reaches the hub's 300 copies
        hub = np.zeros((b, n), bool)
        hub[:, :300] = True
        assert bool((~served)[hub.reshape(-1)].all())
        assert bool((gathered[~served] > CAP).all())


def test_bound_gathers_a_few_more_than_k_on_geoa3_clouds():
    """At k = 16 on GeoA3's clouds the gather keeps a few more pairs than
    the 17 it needs (19 at the median, 30 at most): a warp's 32, so one
    bitonic sort of 32 orders them."""
    a = torch.from_numpy(cloud("geoa3"))
    d = exact_sqdist(a, a).numpy()
    _, served, gathered, _ = select_model(d.reshape(-1, d.shape[-1]), 17)
    assert bool(served.all())
    assert gathered.min() >= 17 and gathered.max() <= 32
