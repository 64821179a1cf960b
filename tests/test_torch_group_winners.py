"""The multi-layer group max backward's two stages
(pointcloudattack_tpu_torch/ops/group_chain.py), and the 3xTF32 products
of its kernels, on the CPU.

``group_winner_lists_plain`` (per group, the rows that win a column,
ascending) is held to a stable numpy ``argsort`` of ``am``;
``group_winners_bwd_plain`` (the gradient of the listed rows, 0 elsewhere)
to ``chain_groupmax_bwd_plain`` bit for bit and to ``jax.vjp`` of the JAX
package's ``reference_mlp_chain_groupmax`` at atol 1e-5.  The kernels'
products, a 3xTF32 split whose two parts each keep the top 10 mantissa
bits (a mask, as the kernels form them), are emulated in numpy on a
259-wide chain (PU-Net's last set abstraction) and held within
chip_smoke.py's ``Y_TOL`` (forward) and ``DX_TOL`` (backward) of the f32
chain.  The CUDA kernels of the stages are held to these plain versions on
the card by tests/test_torch_group_chain_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.pallas.dense_max_kernel import reference_mlp_chain_groupmax
from pointcloudattack_tpu_torch.ops import group_chain as gch
from test_torch_chain_maxpool_winners import split3_matmul, tf32
from test_torch_group_chain import case, jax_layers, torch_layers
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

Y_TOL = dict(rtol=1e-5, atol=1e-4)  # chip_smoke.py's, for the card's forward
DX_TOL = dict(rtol=1e-4, atol=1e-4)  # chip_smoke.py's, for the card's backward
SA3 = (259, 256, 256, 512)  # PU-Net's last set abstraction


def stable_lists(am: np.ndarray, k: int):
    """The lists from numpy's stable argsort, group by group."""
    b, ng, cl = am.shape
    flat = am.reshape(b * ng, cl)
    cols = np.argsort(flat, axis=1, kind="stable")
    wcap = min(k, cl)
    off, wrow = [0], np.full((b * ng, wcap), -1)
    for i in range(b * ng):
        rows = flat[i, cols[i]]
        first = rows[np.r_[True, rows[1:] != rows[:-1]]]
        wrow[i, : len(first)] = first
        off.append(off[-1] + len(first))
    return np.array(off), wrow.reshape(b, ng, wcap)


@pytest.mark.parametrize(
    "make,k",
    [
        (lambda: np.random.RandomState(0).randint(0, 32, size=(2, 5, 64)), 32),
        (lambda: np.zeros((2, 3, 40), dtype=np.int64), 32),  # all rows equal: every tie goes to k = 0
        (lambda: np.full((1, 4, 16), 5), 8),  # one row wins every column
        (lambda: np.tile(np.arange(128) % 64, (2, 3, 1)), 64),  # every row wins, K = 64
        (lambda: np.zeros((1, 6, 12), dtype=np.int64), 1),  # K = 1
        (lambda: np.random.RandomState(1).randint(0, 20, size=(1, 7, 9)), 20),  # C_L < K
    ],
    ids=["random", "all-equal", "hub", "every-row-wins", "k1", "few-columns"],
)
def test_group_winner_lists_plain_is_a_stable_sort(make, k):
    am = make().astype(np.int32)
    got = gch.group_winner_lists_plain(torch.from_numpy(am), k)
    want = stable_lists(am, k)
    for name, g, w in zip(gch.GroupWinners._fields, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def winners_case(name):
    """(x, layers, dy, slope) of a multi-layer group max."""
    if name == "k8-relu":
        return (*case(40, 2, 6, 8, (12, 24, 16, 40)), 0.0)
    if name == "k32-leaky":
        return (*case(41, 2, 3, 32, (9, 32, 24, 48)), 0.2)
    if name == "k32-relu-narrow-first":
        return (*case(42, 1, 4, 32, (3, 16, 16, 32)), 0.0)
    if name == "k64-two-layers":
        return (*case(43, 1, 2, 64, (20, 16, 72)), 0.2)
    if name == "hub":  # W's first row positive and one row's first channel large: it wins every column
        x, layers, dy = case(44, 2, 3, 16, (6, 16, 24))
        x[:, :, :, 0] = -100.0
        x[:, :, 5, 0] = 100.0
        w = layers[0][0]
        w[0] = np.abs(w[0]) + 0.1
        layers[1] = (np.abs(layers[1][0]),) + layers[1][1:]
        layers[0] = (w,) + layers[0][1:]
        return x, layers, dy, 0.0
    raise KeyError(name)


CASES = ["k8-relu", "k32-leaky", "k32-relu-narrow-first", "k64-two-layers", "hub"]


@pytest.mark.parametrize("name", CASES)
def test_group_winners_bwd_plain_equals_the_dense_backward(name):
    x, layers, dy, slope = winners_case(name)
    xt, lt = torch.from_numpy(x), torch_layers(layers)
    _, am = gch.chain_groupmax_plain(xt, lt, slope)
    g = (torch.from_numpy(dy) * lt[-1][3]).contiguous()
    lists = gch.group_winner_lists_plain(am, x.shape[2])
    dx = gch.group_winners_bwd_plain(xt, lt, am, lists, g, slope)
    assert torch.equal(dx, gch.chain_groupmax_bwd_plain(xt, lt, am, g, slope))
    won = torch.zeros(x.shape[:3], dtype=torch.bool).scatter_(2, am.long(), True)
    assert not bool(dx[~won].any())
    if name == "hub":
        assert bool((am == 5).all()) and int(lists.off[-1]) == x.shape[0] * x.shape[1]


@pytest.mark.parametrize("name", ["k8-relu", "k32-leaky", "k32-relu-narrow-first", "k64-two-layers"])
def test_group_winners_bwd_plain_matches_jax_vjp(name):
    """Against jax.vjp of the f32 oracle (its max splits a tie's gradient,
    so only cases whose argmax is unique)."""
    x, layers, dy, slope = winners_case(name)
    xt, lt = torch.from_numpy(x), torch_layers(layers)
    _, am = gch.chain_groupmax_plain(xt, lt, slope)
    g = (torch.from_numpy(dy) * lt[-1][3]).contiguous()
    dx = gch.group_winners_bwd_plain(xt, lt, am, gch.group_winner_lists_plain(am, x.shape[2]), g, slope)
    _, vjp = jax.vjp(lambda a: reference_mlp_chain_groupmax(a, jax_layers(layers), slope), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def bn(z, layer):
    _, b, mean, mul, beta = layer
    return ((z + b - mean) * mul + beta).astype(np.float32)


def split3_chain(x2, layers, slope):
    """The kernels' forward: every product as the 3xTF32 split (a first
    layer under 8 inputs in f32, as the kernels keep it); the hidden
    pre-activations and the last layer's z."""
    h, zs = x2, []
    for i, layer in enumerate(layers):
        w = layer[0]
        prod = (h @ w).astype(np.float32) if i == 0 and w.shape[0] < 8 else split3_matmul(h, w)
        z = bn(prod, layer)
        if i == len(layers) - 1:
            return zs, z
        zs.append(z)
        h = np.maximum(z, slope * z).astype(np.float32)


@pytest.mark.parametrize("dims,k,slope", [(SA3, 32, 0.0), ((3, 32, 32, 64), 32, 0.0), ((67, 64, 64, 128), 16, 0.2)],
                         ids=["sa3", "sa0", "sa1-leaky"])
def test_split3_chain_within_tolerance(dims, k, slope):
    """The forward with every product through the 3xTF32 split stays within
    Y_TOL of the f32 chain, its argmax agrees wherever the top two lie
    further apart than the tolerance, and the backward over the winning
    rows, its products split too (the one-hot cotangent through W_L^T,
    then back through the f32 chain's masks), stays within DX_TOL of the
    plain backward."""
    x, layers, dy = case(45, 2, 4, k, dims)
    xt, lt = torch.from_numpy(x), torch_layers(layers)
    y_ref, am_ref = gch.chain_groupmax_plain(xt, lt, slope)
    zs, z = split3_chain(x.reshape(-1, dims[0]), layers, slope)
    z = z.reshape(2, 4, k, -1)
    torch.testing.assert_close(torch.from_numpy(z.max(axis=2)), y_ref, **Y_TOL)
    top = np.sort(z, axis=2)
    clear = torch.from_numpy(top[:, :, -1] - top[:, :, -2] > Y_TOL["atol"])
    assert torch.equal(torch.from_numpy(z.argmax(axis=2).astype(np.int32))[clear], am_ref[clear])
    g = (torch.from_numpy(dy) * lt[-1][3]).numpy()
    hit = am_ref.numpy()[:, :, None, :] == np.arange(k)[None, None, :, None]
    c = np.where(hit, g[:, :, None, :], 0.0).astype(np.float32).reshape(-1, dims[-1])
    dh = split3_matmul(c, np.ascontiguousarray(layers[-1][0].T))
    _, zs_ref = gch._chain(xt, lt, slope)
    for i in range(len(layers) - 2, -1, -1):
        zi = zs_ref[i].numpy().reshape(-1, dims[i + 1])
        ci = (np.where(zi > 0, dh, slope * dh) * layers[i][3]).astype(np.float32)
        dh = split3_matmul(ci, np.ascontiguousarray(layers[i][0].T))
    dx_ref = gch.chain_groupmax_bwd_plain(xt, lt, am_ref, torch.from_numpy(g), slope)
    torch.testing.assert_close(torch.from_numpy(dh.reshape(x.shape)), dx_ref, **DX_TOL)
    assert np.abs(tf32(x) - x).max() > 0  # the split is not the identity on these rows
