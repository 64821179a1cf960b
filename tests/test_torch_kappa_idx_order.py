"""A CPU model of the curvature forward on a given neighbour set as it runs
on the card (``csrc/kappa.cu::kappa_idx_fwd_kernel``), held to the plain
version ``ops/kappa.py::kappa_idx_plain`` bit for bit.

The model follows the kernel: W lanes a row (16 at k <= 16, 32 past it),
lane t forming the edge term of slot t0 + t in float32, each operation
rounded on its own in the plain version's order, an index outside the cloud
adding 0; the row's terms summed in slot order W at a time, as the lanes'
shuffled sum does, the first term starting the sum; kappa the sum over k.
The tests run it at k = 1, 16, 33 and 64 on GeoA3's synthetic clouds with
repeated slots, a row's own index (distance 0) and indices outside the
cloud, against the plain version given the row's own index in place of
each index outside the cloud (both add 0 there).
"""

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds
from pointcloudattack_tpu_torch.ops import kappa
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

EPS = np.float32(1e-12)


def dot3(n, p):
    return (n[..., 0] * p[..., 0] + n[..., 1] * p[..., 1]) + n[..., 2] * p[..., 2]


def kappa_idx_model(a: np.ndarray, nrm: np.ndarray, idx: np.ndarray, k: int) -> np.ndarray:
    """kappa [B, N] in the kernel's order, float32 throughout."""
    b, n, _ = a.shape
    w = 16 if k <= 16 else 32
    inside = (idx >= 0) & (idx < n)
    aj = a[np.arange(b)[:, None, None], np.where(inside, idx, 0)]  # [B, N, k, 3]: a lane's gather
    diff = a[:, :, None, :] - aj
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    num = dot3(nrm[:, :, None, :], aj) - dot3(nrm, a)[..., None]
    with np.errstate(divide="ignore", invalid="ignore"):
        term = np.abs(num) / (np.sqrt(d) + EPS)
    term = np.where(inside & (d > 0), term, np.float32(0.0)).astype(np.float32)
    acc = None
    for t0 in range(0, k, w):  # a pass of the group's lanes
        for lane in range(min(w, k - t0)):  # the shuffled terms in lane order
            acc = term[..., t0 + lane] if acc is None else (acc + term[..., t0 + lane]).astype(np.float32)
    return (acc / np.float32(k)).astype(np.float32)


def given_set(k, b=2, n=1000, seed=3):
    """GeoA3's synthetic clouds (cut to ``n`` points), unit normals and a
    given set: random indices, slot 1 repeating slot 0, every 11th row's
    slot 0 the row itself, every 5th row's last slot -1 and every 7th row's
    middle slot n + 3."""
    rng = np.random.RandomState(seed + k)
    a = make_synthetic_clouds(b, 1, 1024, seed=5)[0][:, :n].astype(np.float32)
    nv = rng.randn(b, n, 3)
    nrm = (nv / np.linalg.norm(nv, axis=-1, keepdims=True)).astype(np.float32)
    idx = rng.randint(0, n, size=(b, n, k))
    if k > 1:
        idx[:, :, 1] = idx[:, :, 0]
    idx[:, ::11, 0] = np.arange(0, n, 11)
    idx[:, ::5, k - 1] = -1
    idx[:, ::7, k // 2] = n + 3
    return a, nrm, idx.astype(np.int32)


@pytest.mark.parametrize("k", [1, 16, 33, 64])
def test_slot_order_warp_sum_gives_the_plain_bits(k):
    a, nrm, idx = given_set(k)
    n = a.shape[1]
    got = kappa_idx_model(a, nrm, idx, k)
    own = np.broadcast_to(np.arange(n)[None, :, None], idx.shape)
    inside = (idx >= 0) & (idx < n)
    assert (~inside).any() and (idx[:, :, 0] == np.arange(n)).any()
    want = kappa.kappa_idx_plain(torch.from_numpy(a), torch.from_numpy(nrm),
                                 torch.from_numpy(np.where(inside, idx, own).astype(np.int32)), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and (got > 0).any()
