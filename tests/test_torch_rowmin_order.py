"""A CPU model of the order in which the Chamfer row min runs on the card
(``csrc/min_sqdist.cu::min_rows_kernel``), held to the plain version
``ops/chamfer.py::min_rows_plain`` bit for bit in mins and argmin.

The model follows the kernel step by step: y staged in tiles of 1024
points; in each tile the S splits of a row take the chunks of 8 points
s, s + S, ...; a split folds each chunk into its running minimum (a
minimum returns one of its inputs) and keeps the start of the tile's last
chunk that lowered it, under a strict '<'; a tile that another follows
resolves that chunk to its first j whose distance equals the minimum,
while the last tile's chunk start stands in for the index (0 until a chunk
lowers +inf); the splits merge in (distance, index) order, and only the
winner's chunk, if it is open, is rescanned.  The tests run
it at 1, 2, 4 and 8 splits (the launch takes 4 or 8) on the KNN
attack's and GeoA3's synthetic clouds, with every y point 4 times, with all
points equal, at a ragged N = M = 1000 (no multiple of S x 8), on rows whose
distances overflow to +inf, at B = 1, and with y in three tiles.
"""

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds
from pointcloudattack_tpu_torch.ops import chamfer
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

TILE, CHUNK = 1024, 8  # min_sqdist.cu's kTile and kChunk
SPLITS = (1, 2, 4, 8)  # min_sqdist.cu's kPlans take 4 and 8; the order holds at any count


def first_equal(rows, start, nj, j0, best):
    """The first index of each row's chunk [start, start + 8) of the tile at
    ``j0`` (``nj`` points) whose distance is ``best``; ``start`` -1 where
    the tile lowered nothing."""
    cols = start[:, None] + np.arange(CHUNK)
    valid = (start[:, None] >= 0) & (cols < nj)
    vals = np.take_along_axis(rows, j0 + np.where(valid, cols, 0), axis=1)
    hit = valid & (vals == best[:, None])
    assert bool((hit.any(axis=1) == (start >= 0)).all())  # the winning chunk holds the minimum
    return j0 + start + hit.argmax(axis=1)


def split_scan(rows: np.ndarray, s: int, splits: int):
    """Split ``s`` of ``splits`` over ``rows [R, M]`` as a lane of the
    kernel scans it: (its minimum, its first index or, where open, the start
    of the last tile's chunk that holds it, open)."""
    r, m = rows.shape
    best = np.full(r, np.inf, np.float32)
    arg = np.zeros(r, np.int64)
    for j0 in range(0, m, TILE):
        nj = min(TILE, m - j0)
        first = np.full(r, -1)
        for c0 in range(s * CHUNK, nj, splits * CHUNK):
            low = np.minimum(best, rows[:, j0 + c0 : j0 + min(c0 + CHUNK, nj)].min(axis=1))
            first = np.where(low < best, c0, first)
            best = low
        if j0 + TILE >= m:  # the last tile: the chunk's start, rescanned after the merge
            return best, np.where(first >= 0, j0 + first, arg), first >= 0
        arg = np.where(first >= 0, first_equal(rows, first, nj, j0, best), arg)


def rowmin_model(x: torch.Tensor, y: torch.Tensor, splits: int):
    """(mins [B, N], argmin [B, N]) in the kernel's order."""
    d = chamfer.exact_sqdist(x, y).numpy()
    b, n, m = d.shape
    rows = d.reshape(b * n, m)
    best, arg, opened = split_scan(rows, 0, splits)
    for s in range(1, splits):
        dv, jv, ov = split_scan(rows, s, splits)
        take = (dv < best) | ((dv == best) & (jv < arg))
        best, arg, opened = np.where(take, dv, best), np.where(take, jv, arg), np.where(take, ov, opened)
    j0 = (m - 1) // TILE * TILE
    arg = np.where(opened, first_equal(rows, np.where(opened, arg - j0, -1), m - j0, j0, best), arg)
    return best.reshape(b, n), arg.reshape(b, n).astype(np.int32)


def case(name):
    rng = np.random.RandomState(7)
    if name in ("knn", "geoa3"):
        clouds, _ = make_synthetic_clouds(2, 1, 1024, seed=4 if name == "knn" else 5)
        y = clouds
        x = (clouds + rng.randn(*clouds.shape) * 0.01).astype(np.float32)  # an iterate a few steps in
    elif name == "copies":  # every y point 4 times
        y = np.concatenate([rng.randn(2, 256, 3)] * 4, axis=1)
        x = y + rng.randn(2, 1024, 3) * 0.01
    elif name == "equal":
        x, y = np.full((2, 1024, 3), 0.25), np.full((2, 1024, 3), 0.25)
    elif name == "ragged":
        x, y = rng.randn(3, 1000, 3) * 0.5, rng.randn(3, 1000, 3) * 0.5
    elif name == "overflow":  # odd rows' distances all +inf; y's first quarter +inf from every row
        x, y = rng.randn(2, 1024, 3) * 0.5, rng.randn(2, 1024, 3) * 0.5
        x[:, 1::2] = 1e20
        y[:, :256] = -1e20
    elif name == "B=1":
        x, y = rng.randn(1, 1024, 3) * 0.5, rng.randn(1, 1024, 3) * 0.5
    else:  # "three tiles": M = 2500
        x, y = rng.randn(2, 64, 3) * 0.5, rng.randn(2, 2500, 3) * 0.5
    return torch.from_numpy(np.asarray(x, np.float32)), torch.from_numpy(np.asarray(y, np.float32))


@pytest.mark.parametrize("name", ["knn", "geoa3", "copies", "equal", "ragged", "overflow", "B=1", "three tiles"])
def test_row_min_model_gives_the_plain_bits(name):
    """At each split count the model's mins and argmin are the plain
    version's, bit for bit: the first index on ties, index 0 on rows whose
    distances are all +inf."""
    x, y = case(name)
    want_d, want_j = chamfer.min_rows_plain(x, y)
    for splits in SPLITS:
        got_d, got_j = rowmin_model(x, y, splits)
        np.testing.assert_array_equal(got_d, want_d.numpy(), err_msg=f"mins, S={splits}")
        np.testing.assert_array_equal(got_j, want_j.numpy(), err_msg=f"argmin, S={splits}")
    if name == "equal":
        assert not want_j.any()
    if name == "overflow":
        assert bool(torch.isinf(want_d[:, 1::2]).all()) and not want_j[:, 1::2].any()
        assert bool(torch.isfinite(want_d[:, ::2]).all()) and bool((want_j[:, ::2] >= 256).all())
    if name == "copies":
        assert bool((want_j < 256).all())  # the first of the 4 copies


def test_a_chunk_that_only_ties_does_not_move_the_argmin():
    """The minimum first reached in an early chunk and tied in later ones,
    of the same split and of others: the argmin stays at the first."""
    y = np.random.RandomState(2).randn(1, 1024, 3).astype(np.float32)
    y[0, [37, 300, 301, 1023]] = y[0, 5]
    x = y[:, [5]] + np.float32(0.0)
    for splits in SPLITS:
        d, j = rowmin_model(torch.from_numpy(x), torch.from_numpy(y), splits)
        assert d[0, 0] == 0.0 and j[0, 0] == 5
