"""The CUDA chain + max-pool kernel against its plain PyTorch version, on
the card (pointcloudattack_tpu_torch/csrc/chain_maxpool.cu).

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chain_maxpool_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX).  It also holds
the seeded-input helpers that tests/test_torch_chain_maxpool.py shares.

Tolerances: y atol 1e-4 / rtol 1e-5 and dx atol 1e-4 / rtol 1e-4 cover
f32 sums of up to 643 terms taken in another order than the plain
version's, the last layer's through the forward's 3xTF32 split.  The
backward's lists stage is held bit for bit, and two backwards must give
the same bits.
"""

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch.ops import chain_maxpool as cm

NARROW = (3, 16, 32, 64)
PATH = (3, 64, 128, 1024)
SSG_SA3 = (259, 256, 512, 1024)
MSG_SA3 = (643, 256, 512, 1024)


def make_layers(rng, dims):
    """Seeded layers (w, b, mean, mul, beta) as float32 numpy arrays."""
    layers = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        layers.append((
            (rng.randn(cin, cout) / np.sqrt(cin)).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32),
            (rng.randn(cout) * 0.05).astype(np.float32),
            (rng.rand(cout) + 0.5).astype(np.float32),
            (rng.randn(cout) * 0.1).astype(np.float32),
        ))
    return layers


def to_torch(layers, device="cpu"):
    return [tuple(torch.from_numpy(a).to(device) for a in layer) for layer in layers]


def inputs(seed, b, n, dims):
    """Seeded x [b, n, dims[0]], layers and a cotangent dy [b, dims[-1]]."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, dims[0]).astype(np.float32)
    layers = make_layers(rng, dims)
    dy = rng.randn(b, dims[-1]).astype(np.float32)
    return x, layers, dy


def top2_gap(x, layers):
    """Per column, the gap between the two largest pre-pool values."""
    z = x
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        if i:
            z = torch.relu(z)
        z = (z @ w + b - mean) * mul + beta
    top = z.topk(2, dim=1).values
    return top[:, 0] - top[:, 1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def check_backward(x, layers, idx, g):
    """The backward's kernels against their plain versions: the lists bit
    for bit, dx within the tolerance, exactly 0 on the rows that win no
    column, two runs bit-equal; each stage launched once a call."""
    cm.reset_launches()
    lists = cm.winner_lists(idx, x.shape[1])
    want = cm.winner_lists_plain(idx.cpu(), x.shape[1])
    for name, got, ref in zip(cm.Winners._fields, lists, want):
        assert torch.equal(got.cpu(), ref), name
    dx_rows = cm.winners_bwd(x, layers, lists, g)
    dx = cm.chain_maxpool_bwd(x, layers, idx, g)
    dx2 = cm.chain_maxpool_bwd(x, layers, idx, g)
    torch.cuda.synchronize()
    assert cm.LAUNCHES == {"fwd": 0, "bwd": 2, "bwd_lists": 3, "bwd_rows": 3}
    assert torch.equal(dx, dx2) and torch.equal(dx, dx_rows)
    torch.testing.assert_close(dx, cm.winners_bwd_plain(x, layers, lists, g), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx, cm.chain_maxpool_bwd_plain(x, layers, idx, g), rtol=1e-4, atol=1e-4)
    wins = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device).scatter_(1, idx.long(), True)
    assert not bool(dx[~wins].any())
    return dx


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dims,b,n",
    [(PATH, 4, 1024), (PATH, 3, 1000), (NARROW, 2, 77), ((64, 128, 1024), 2, 300),
     ((3, 1024), 2, 129), ((3, 64, 128, 256, 1024), 2, 200),
     # every shape the paths give the kernels: PointNet's spine at C&W's and
     # KNN's B=64, GeoA3's B=8 (and its partial mode's 512-point subsample),
     # PointNet++'s last set abstraction (SSG, MSG)
     (PATH, 64, 1024), (PATH, 8, 1024), (PATH, 8, 512), (SSG_SA3, 16, 128), (MSG_SA3, 16, 128)],
)
def test_kernel_matches_plain_on_card(cuda_device, dims, b, n):
    x, layers, dy = inputs(7, b, n, dims)
    xg = torch.from_numpy(x).to(cuda_device)
    lg = to_torch(layers, cuda_device)
    cm.reset_launches()
    y, idx = cm.chain_maxpool_fwd(xg, lg)
    y_ref, idx_ref = cm.chain_maxpool_plain(xg, lg)
    torch.cuda.synchronize()
    assert cm.LAUNCHES["fwd"] == 1
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-4)
    # a column whose two best values lie within the tolerance may pick
    # either row; every other column must agree exactly
    clear = top2_gap(xg, lg) > 1e-4
    assert torch.equal(idx[clear], idx_ref[clear])
    g = (torch.from_numpy(dy).to(cuda_device) * lg[-1][3]).contiguous()
    check_backward(xg, lg, idx_ref, g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hub", "every row wins", "ties"])
def test_backward_edge_cases_on_card(cuda_device, case):
    """A hub (one row wins every column of its cloud), every row winning
    (N=128 < C_L=1024 at the set abstraction's widths) and ties (each point
    four times, so the forward picks the lowest copy)."""
    dims, b, n = (PATH, 3, 1024) if case != "every row wins" else (SSG_SA3, 4, 128)
    x, layers, dy = inputs(12, b, n, dims)
    if case == "ties":
        x = np.concatenate([x[:, : n // 4]] * 4, axis=1)
    xg = torch.from_numpy(x).to(cuda_device)
    lg = to_torch(layers, cuda_device)
    idx = cm.chain_maxpool_fwd(xg, lg)[1]
    if case == "hub":
        idx[0] = 17
    elif case == "every row wins":
        idx = (torch.arange(dims[-1], device=cuda_device, dtype=torch.int32) % n).repeat(b, 1).contiguous()
    else:
        assert int(idx.max()) < n // 4
    g = (torch.from_numpy(dy).to(cuda_device) * lg[-1][3]).contiguous()
    dx = check_backward(xg, lg, idx, g)
    if case == "hub":
        assert bool(dx[0, 17].abs().sum() > 0) and not bool(dx[0, :17].any())


@pytest.mark.cuda
def test_kernel_autograd_matches_plain_on_card(cuda_device):
    x, layers, dy = inputs(10, 2, 200, PATH)
    lg = to_torch(layers, cuda_device)
    dyg = torch.from_numpy(dy).to(cuda_device)
    grads = []
    for fn in (cm.mlp_chain_maxpool, lambda a, ls: cm.chain_maxpool_plain(a, ls)[0]):
        xg = torch.from_numpy(x).to(cuda_device).requires_grad_(True)
        (fn(xg, lg) * dyg).sum().backward()
        grads.append(xg.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_takes_transposed_weight_views_on_card(cuda_device):
    # PointMLP hands the chain w as a view of the module's [out, in] weight
    x, layers, dy = inputs(11, 2, 300, PATH)
    xg = torch.from_numpy(x).to(cuda_device)
    lg = to_torch(layers, cuda_device)
    views = [(w.t().contiguous().t(), *rest) for w, *rest in lg]
    assert not views[-1][0].is_contiguous()
    for fwd in (cm.chain_maxpool_fwd, cm.chain_maxpool_plain):
        y, idx = fwd(xg, views)
        y_ref, idx_ref = fwd(xg, lg)
        assert torch.equal(y, y_ref) and torch.equal(idx, idx_ref)
    g = (torch.from_numpy(dy).to(cuda_device) * lg[-1][3]).contiguous()
    assert torch.equal(cm.chain_maxpool_bwd(xg, views, idx, g), cm.chain_maxpool_bwd(xg, lg, idx, g))
    grads = []
    for ls in (views, lg):
        xr = xg.clone().requires_grad_(True)
        (cm.mlp_chain_maxpool(xr, ls) * torch.from_numpy(dy).to(cuda_device)).sum().backward()
        grads.append(xr.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_kernel_ties_take_the_first_index_on_card(cuda_device):
    rng = np.random.RandomState(8)
    base = rng.randn(1, 40, 3).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base] * 5, axis=1)).to(cuda_device)  # 200 rows
    lg = to_torch(make_layers(rng, PATH), cuda_device)
    _, idx = cm.chain_maxpool_fwd(x, lg)
    _, idx_ref = cm.chain_maxpool_plain(x, lg)
    assert torch.equal(idx, idx_ref)
    assert int(idx.max()) < 40


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x, layers, _ = inputs(9, 2, 16, NARROW)
    lg = to_torch(layers, cuda_device)
    xg = torch.from_numpy(x).to(cuda_device)
    with pytest.raises(ValueError):
        cm.chain_maxpool_fwd(xg.double(), lg)
    with pytest.raises(ValueError):
        cm.chain_maxpool_fwd(xg.transpose(0, 1), lg)
    with pytest.raises(ValueError):
        cm.chain_maxpool_fwd(xg, [tuple(t.cpu() for t in layer) for layer in lg])
    y, idx = cm.chain_maxpool_fwd(xg, lg)
    g = (torch.from_numpy(np.ones((2, NARROW[-1]), np.float32)).to(cuda_device) * lg[-1][3]).contiguous()
    with pytest.raises(ValueError):
        cm.chain_maxpool_bwd(xg, lg, idx.long(), g)
    with pytest.raises(ValueError):
        cm.chain_maxpool_bwd(xg, lg, idx, g[:, :-1].contiguous())
    with pytest.raises(ValueError):
        cm.winner_lists(idx.t(), 16)
    lists = cm.winner_lists(idx, 16)
    with pytest.raises(ValueError):
        cm.winners_bwd(xg, lg, lists._replace(cols=lists.cols.long()), g)
    with pytest.raises(ValueError):  # wider than the kernels' 1024
        cm.chain_maxpool_fwd(torch.zeros((1, 8, 1100), device=cuda_device), to_torch(make_layers(
            np.random.RandomState(0), (1100, 16)), cuda_device))
