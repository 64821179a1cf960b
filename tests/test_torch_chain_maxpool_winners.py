"""The chain + max-pool backward's two stages (pointcloudattack_tpu_torch/ops/chain_maxpool.py),
and the forward's 3xTF32 product, on the CPU.

``winner_lists_plain`` (per cloud, the rows that win a column and the
columns each one won) is held to a stable ``argsort`` of ``idx``;
``winners_bwd_plain`` (the gradient of the listed rows, 0 elsewhere) to
``chain_maxpool_bwd_plain`` bit for bit and to ``jax.vjp`` of the JAX
package's ``reference_mlp_chain_maxpool`` at atol 1e-5.  The product
stage's arithmetic, a 3xTF32 split whose two parts each keep the top 10
mantissa bits (a mask, as the kernel forms them), is emulated in numpy and
held within chip_smoke.py's ``Y_TOL`` of the f32 chain.  The CUDA kernels of the stages are held to these plain
versions on the card by tests/test_torch_chain_maxpool_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.pallas.dense_max_kernel import reference_mlp_chain_maxpool
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from test_torch_chain_maxpool_cuda import NARROW, PATH, inputs, make_layers, to_torch
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

SA3 = (259, 256, 512, 1024)  # PointNet++ SSG's last set abstraction
Y_TOL = dict(rtol=1e-5, atol=1e-4)  # chip_smoke.py's, for the card's forward


def stable_lists(idx: np.ndarray, n: int):
    """The lists from numpy's stable argsort, cloud by cloud."""
    b, cl = idx.shape
    cols = np.argsort(idx, axis=1, kind="stable")
    wcap = min(n, cl)
    off, wrow, cstart = [0], np.full((b, wcap), -1), np.full((b, wcap), -1)
    for i in range(b):
        rows = idx[i, cols[i]]
        first = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
        wrow[i, : len(first)] = rows[first]
        cstart[i, : len(first)] = i * cl + first
        off.append(off[-1] + len(first))
    return np.array(off), wrow, cstart, cols


def hub_idx(b, cl):
    """Every column of cloud 0 won by row 3; cloud 1 ties over a few rows."""
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 4, size=(b, cl))
    idx[0] = 3
    return idx


@pytest.mark.parametrize(
    "make,n",
    [
        (lambda: np.random.RandomState(0).randint(0, 100, size=(3, 64)), 100),
        (lambda: np.random.RandomState(1).randint(0, 5, size=(2, 300)), 5),  # many ties a row
        (lambda: hub_idx(2, 256), 50),
        (lambda: np.tile(np.arange(1024) % 128, (2, 1)), 128),  # every row wins
        (lambda: np.random.RandomState(2).randint(0, 1000, size=(2, 1)), 1000),  # one column
    ],
    ids=["random", "ties", "hub", "every-row-wins", "one-column"],
)
def test_winner_lists_plain_is_a_stable_sort(make, n):
    idx = make().astype(np.int32)
    got = cm.winner_lists_plain(torch.from_numpy(idx), n)
    want = stable_lists(idx, n)
    for name, g, w in zip(cm.Winners._fields, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the CPU entry point is the plain version
    for g, w in zip(cm.winner_lists(torch.from_numpy(idx), n), got):
        assert torch.equal(g, w)


def winner_case(name):
    """(x, layers, dy, idx or None): idx None takes the forward's argmax."""
    if name == "spine":
        x, layers, dy = inputs(20, 2, 200, PATH)
        return x, layers, dy, None
    if name == "sa3, every row wins":
        x, layers, dy = inputs(21, 2, 128, SA3)
        idx = np.tile(np.arange(SA3[-1]) % 128, (2, 1))
        return x, layers, dy, idx
    if name == "ragged":
        x, layers, dy = inputs(22, 3, 77, NARROW)
        return x, layers, dy, None
    if name == "hub":  # nonnegative weights: the one large row wins every column
        rng = np.random.RandomState(23)
        x = (rng.randn(2, 64, 3) * 0.3).astype(np.float32)
        x[:, 9] = 2.0
        layers = [(np.abs(w) * 0.25, b, m, mu, be) for w, b, m, mu, be in make_layers(rng, PATH)]
        dy = rng.randn(2, PATH[-1]).astype(np.float32)
        return x, layers, dy, None
    raise KeyError(name)


CASES = ["spine", "sa3, every row wins", "ragged", "hub"]


@pytest.mark.parametrize("name", CASES)
def test_winners_bwd_plain_equals_the_dense_backward(name):
    x, layers, dy, idx = winner_case(name)
    xt, lt = torch.from_numpy(x), to_torch(layers)
    if idx is None:
        idx = cm.chain_maxpool_plain(xt, lt)[1].numpy()
    idx_t = torch.from_numpy(idx.astype(np.int32))
    g = (torch.from_numpy(dy) * lt[-1][3]).contiguous()
    lists = cm.winner_lists_plain(idx_t, x.shape[1])
    dx = cm.winners_bwd_plain(xt, lt, lists, g)
    assert torch.equal(dx, cm.chain_maxpool_bwd_plain(xt, lt, idx_t, g))
    assert torch.equal(dx, cm.winners_bwd(xt, lt, lists, g))  # the CPU entry point
    losers = ~cm.chain_maxpool_plain(xt, lt)[1].new_zeros(x.shape[:2], dtype=torch.bool).scatter_(
        1, idx_t.long(), True)
    assert not bool(dx[losers].any())
    if name == "hub":
        assert bool((idx == 9).all())


@pytest.mark.parametrize("name", ["spine", "ragged", "hub"])
def test_winners_bwd_plain_matches_jax_vjp(name):
    """Against jax.vjp of the f32 oracle (its max splits a tie's gradient,
    so only cases whose argmax is unique)."""
    x, layers, dy, _ = winner_case(name)
    xt, lt = torch.from_numpy(x), to_torch(layers)
    idx = cm.chain_maxpool_plain(xt, lt)[1]
    g = (torch.from_numpy(dy) * lt[-1][3]).contiguous()
    dx = cm.winners_bwd_plain(xt, lt, cm.winner_lists_plain(idx, x.shape[1]), g)
    jl = tuple(tuple(jnp.asarray(a) for a in layer) for layer in layers)
    _, vjp = jax.vjp(lambda a: reference_mlp_chain_maxpool(a, jl), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_winners_bwd_plain_matches_jax_vjp_every_row_wins():
    """N=128 < C_L=1024 at SA3's widths, idx from the forward: every row
    that wins is listed, and the rest get 0."""
    x, layers, dy = inputs(24, 2, 128, SA3)
    xt, lt = torch.from_numpy(x), to_torch(layers)
    idx = cm.chain_maxpool_plain(xt, lt)[1]
    lists = cm.winner_lists_plain(idx, 128)
    assert int(lists.off[-1]) > 128  # most rows of both clouds win
    g = (torch.from_numpy(dy) * lt[-1][3]).contiguous()
    dx = cm.winners_bwd_plain(xt, lt, lists, g)
    jl = tuple(tuple(jnp.asarray(a) for a in layer) for layer in layers)
    _, vjp = jax.vjp(lambda a: reference_mlp_chain_maxpool(a, jl), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def tf32(a: np.ndarray) -> np.ndarray:
    """f32 cut to TF32 as the kernel's split does: the 13 low mantissa bits
    dropped (a mask, toward zero)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split3_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the product stage forms it: a_lo*b_hi + a_hi*b_lo +
    a_hi*b_hi, hi = tf32(x) and lo = tf32(x - hi), the products exact (f64
    here)."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    f = np.float64
    return (a_lo.astype(f) @ b_hi.astype(f) + a_hi.astype(f) @ b_lo.astype(f)
            + a_hi.astype(f) @ b_hi.astype(f)).astype(np.float32)


def test_tf32_split_keeps_twenty_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    vals = np.array([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + 3 * ulp / 2), 3.0], dtype=np.float32)
    np.testing.assert_array_equal(tf32(vals), [one, one + ulp, -(one + ulp), 3.0])
    x = np.random.RandomState(27).randn(10000).astype(np.float32)
    hi = tf32(x)
    lo = tf32(x - hi)
    err = np.abs(x.astype(np.float64) - hi - lo) / np.abs(x)
    assert err.max() < 2.0 ** -20


@pytest.mark.parametrize("dims,n", [(PATH, 256), (SA3, 128), ((643, 256, 512, 1024), 128)],
                         ids=["spine", "ssg-sa3", "msg-sa3"])
def test_split3_product_within_y_tol(dims, n):
    """The chain with its last layer through the 3xTF32 split stays within
    Y_TOL of the f32 chain, and its argmax agrees wherever the top two lie
    further apart than the tolerance."""
    x, layers, _ = inputs(25, 2, n, dims)
    h = x
    for w, b, mean, mul, beta in layers[:-1]:
        h = np.maximum((h @ w + b - mean) * mul + beta, 0).astype(np.float32)
    w, b, mean, mul, beta = layers[-1]
    z = (split3_matmul(h.reshape(-1, h.shape[-1]), w).reshape(2, n, -1) + b - mean) * mul + beta
    y_ref, idx_ref = cm.chain_maxpool_plain(torch.from_numpy(x), to_torch(layers))
    torch.testing.assert_close(torch.from_numpy(z.max(axis=1)), y_ref, **Y_TOL)
    top = np.sort(z, axis=1)
    clear = torch.from_numpy(top[:, -1] - top[:, -2] > Y_TOL["atol"])
    assert torch.equal(torch.from_numpy(z.argmax(axis=1).astype(np.int32))[clear], idx_ref[clear])


@pytest.mark.parametrize("dims,n", [(PATH, 300), (SA3, 128)])
def test_plain_path_takes_module_weight_views_bit_for_bit(dims, n):
    """ChainMaxPool hands the weights over as the module's transposed views:
    on the CPU the plain forward and backward give the bits they give on
    contiguous copies."""
    x, layers, dy = inputs(26, 2, n, dims)
    xt, lt = torch.from_numpy(x), to_torch(layers)
    views = [(w.t().contiguous().t(), *rest) for w, *rest in lt]
    assert not views[0][0].is_contiguous()
    y, idx = cm.chain_maxpool_plain(xt, lt)
    yv, idxv = cm.chain_maxpool_plain(xt, views)
    assert torch.equal(y, yv) and torch.equal(idx, idxv)
    g = (torch.from_numpy(dy) * lt[-1][3]).contiguous()
    assert torch.equal(cm.chain_maxpool_bwd_plain(xt, lt, idx, g), cm.chain_maxpool_bwd_plain(xt, views, idx, g))
    grads = []
    for ls in (lt, views):
        xr = xt.clone().requires_grad_(True)
        (cm.mlp_chain_maxpool(xr, ls) * torch.from_numpy(dy)).sum().backward()
        grads.append(xr.grad)
    assert torch.equal(grads[0], grads[1])
