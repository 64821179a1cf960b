"""The CUDA chain + max-pool kernel against its plain PyTorch version, on
the card (pointcloudattack_tpu_torch/csrc/chain_maxpool.cu).

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  The
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chain_maxpool_cuda.py

(``--noconftest`` because tests/conftest.py imports JAX).  It also holds
the seeded-input helpers that tests/test_torch_chain_maxpool.py shares.

Tolerances: y atol 1e-4 / rtol 1e-5 and dx atol 1e-4 / rtol 1e-4 cover
f32 sums of up to 128 terms taken in another order than cuBLAS takes them.
"""

import numpy as np
import pytest
import torch

from pointcloudattack_tpu_torch.ops import chain_maxpool as cm

NARROW = (3, 16, 32, 64)
PATH = (3, 64, 128, 1024)


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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dims,b,n",
    [(PATH, 4, 1024), (PATH, 3, 1000), (NARROW, 2, 77), ((64, 128, 1024), 2, 300),
     ((3, 1024), 2, 129), ((3, 64, 128, 256, 1024), 2, 200)],
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
    dx = cm.chain_maxpool_bwd(xg, lg, idx_ref, g)
    dx_ref = cm.chain_maxpool_bwd_plain(xg, lg, idx_ref, g)
    torch.cuda.synchronize()
    assert cm.LAUNCHES["bwd"] == 1
    torch.testing.assert_close(dx, dx_ref, rtol=1e-4, atol=1e-4)


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
