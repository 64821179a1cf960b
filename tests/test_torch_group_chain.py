"""The grouped chain + max and chain + mean ops of the port
(pointcloudattack_tpu_torch/ops/group_chain.py) against the JAX package's
f32 oracles, on the CPU.

The port's plain versions serve CPU tensors; the JAX side runs
``reference_mlp_chain_groupmax`` / ``reference_mlp_chain_groupmean`` (the
unfused f32 chains its custom VJPs differentiate) and ``jax.vjp`` of them,
not the Pallas kernels in interpret mode, whose products truncate to bf16.
Cases: 1 and 2 layers, slope 0 and 0.2, a ragged G, K=7 and K=20, and a
group whose rows tie.  Tolerance atol 1e-5 (f32 sums over at most 64 terms
in another order).

The max's input gradient sends each column's cotangent to its first
argmax, as the TPU kernel's VJP does, where ``jnp.max``'s VJP splits a tie
evenly: on tied rows the test holds the first row's gradient to the sum of
the oracle's shares and the others' to 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.pallas.dense_max_kernel import (
    reference_mlp_chain_groupmax,
    reference_mlp_chain_groupmean,
)
from pointcloudattack_tpu_torch.ops import group_chain as gch

ATOL = 1e-5


def case(seed, b, g, k, dims):
    """Seeded x [b, g, k, C0], layers (w, b, mean, mul, beta) and dy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, g, k, dims[0]).astype(np.float32)
    layers = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        layers.append(tuple(a.astype(np.float32) for a in (
            rng.randn(cin, cout) / np.sqrt(cin), rng.randn(cout) * 0.1, rng.randn(cout) * 0.05,
            rng.rand(cout) + 0.5, rng.randn(cout) * 0.1)))
    dy = rng.randn(b, g, dims[-1]).astype(np.float32)
    return x, layers, dy


def torch_layers(layers, grad=False):
    return [tuple(torch.from_numpy(a.copy()).requires_grad_(grad) for a in layer) for layer in layers]


def jax_layers(layers):
    return tuple(tuple(jnp.asarray(a) for a in layer) for layer in layers)


CASES = [  # (seed, B, G, K, dims, slope)
    (0, 2, 12, 20, (9, 32), 0.2),        # CurveNet's initial LPFA, one layer
    (1, 2, 10, 20, (16, 16), 0.2),       # a residual LPFA
    (2, 1, 7, 7, (12, 24, 8), 0.2),      # K=7, two layers, a ragged G
    (3, 2, 5, 20, (9, 32, 32), 0.0),     # ReLU between the layers
    (4, 1, 33, 3, (5, 7), 0.0),          # one layer, ReLU
]
IDS = ["initial", "residual", "k7_two_layers", "relu_two_layers", "k3_relu"]


@pytest.mark.parametrize("seed,b,g,k,dims,slope", CASES, ids=IDS)
def test_groupmax_matches_oracle(seed, b, g, k, dims, slope):
    x, layers, dy = case(seed, b, g, k, dims)
    want, vjp = jax.vjp(lambda a: reference_mlp_chain_groupmax(a, jax_layers(layers), slope), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    gch.reset_launches()
    y = gch.mlp_chain_groupmax(xt, torch_layers(layers), slope)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    assert all(v == 0 for v in gch.LAUNCHES.values())  # plain versions on the CPU
    assert y.shape == (b, g, dims[-1])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=0, atol=ATOL)
    # am: the row whose value is the max, and no earlier row reaches it
    yy, am = gch.chain_groupmax_plain(torch.from_numpy(x), torch_layers(layers), slope)
    z, _ = gch._chain(torch.from_numpy(x), torch_layers(layers), slope)
    assert am.dtype == torch.int32
    assert torch.equal(z.gather(2, am.long()[:, :, None]).squeeze(2), yy)
    earlier = torch.arange(k)[None, None, :, None] < am[:, :, None, :]
    assert not bool(((z >= yy[:, :, None]) & earlier).any())


@pytest.mark.parametrize("seed,b,g,k,dims,slope", CASES, ids=IDS)
def test_groupmean_matches_oracle(seed, b, g, k, dims, slope):
    x, layers, dy = case(seed, b, g, k, dims)
    want, vjp = jax.vjp(lambda a: reference_mlp_chain_groupmean(a, jax_layers(layers), slope), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    gch.reset_launches()
    y = gch.mlp_chain_groupmean(xt, torch_layers(layers), slope)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    assert all(v == 0 for v in gch.LAUNCHES.values())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=0, atol=ATOL)


@pytest.mark.parametrize("pool", ["max", "mean"])
def test_parameter_gradients_match_oracle(pool):
    """Parameter gradients come from autograd through the plain forward,
    as the JAX VJPs take them from the oracles."""
    x, layers, dy = case(5, 2, 6, 20, (9, 16, 16))
    ref = reference_mlp_chain_groupmax if pool == "max" else reference_mlp_chain_groupmean
    op = gch.mlp_chain_groupmax if pool == "max" else gch.mlp_chain_groupmean
    _, vjp = jax.vjp(lambda ls: ref(jnp.asarray(x), ls, 0.2), jax_layers(layers))
    (want,) = vjp(jnp.asarray(dy))
    tl = torch_layers(layers, grad=True)
    y = op(torch.from_numpy(x), tl, 0.2)
    got = torch.autograd.grad(y, [t for layer in tl for t in layer], torch.from_numpy(dy))
    for g, w in zip(got, [t for layer in want for t in layer]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)


def test_groupmax_ties_go_to_the_first_row():
    """Rows 2 and 5 of every group are copies of row 0 (as a ball query pads
    a short ball): am never names them, and the max's gradient reaches the
    first of the tied rows only, carrying the shares the oracle splits."""
    x, layers, dy = case(6, 2, 9, 7, (6, 16, 8))
    x[:, :, 2] = x[:, :, 0]
    x[:, :, 5] = x[:, :, 0]
    _, am = gch.chain_groupmax_plain(torch.from_numpy(x), torch_layers(layers), 0.2)
    assert not bool(((am == 2) | (am == 5)).any()) and bool((am == 0).any())
    _, vjp = jax.vjp(lambda a: reference_mlp_chain_groupmax(a, jax_layers(layers), 0.2), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(gch.mlp_chain_groupmax(xt, torch_layers(layers), 0.2), xt, torch.from_numpy(dy))
    dx = dx.numpy()
    np.testing.assert_allclose(dx[:, :, 0], want[:, :, 0] + want[:, :, 2] + want[:, :, 5], rtol=0, atol=ATOL)
    assert not dx[:, :, 2].any() and not dx[:, :, 5].any()
    rest = [1, 3, 4, 6]
    np.testing.assert_allclose(dx[:, :, rest], want[:, :, rest], rtol=0, atol=ATOL)


def test_bwd_plain_takes_the_scaled_cotangent():
    """The backward entry points take g = dy * mul_L (max) and
    dy * mul_L / K (mean), as the autograd Functions hand it."""
    x, layers, dy = case(7, 1, 4, 5, (6, 8))
    tl = torch_layers(layers)
    xt = torch.from_numpy(x)
    mul = tl[-1][3]
    _, am = gch.chain_groupmax_fwd(xt, tl, 0.2)
    xr = xt.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(gch.mlp_chain_groupmax(xr, tl, 0.2), xr, torch.from_numpy(dy))
    got = gch.chain_groupmax_bwd(xt, tl, am, torch.from_numpy(dy) * mul, 0.2)
    assert torch.equal(got, want)
    (want,) = torch.autograd.grad(gch.mlp_chain_groupmean(xr, tl, 0.2), xr, torch.from_numpy(dy))
    got = gch.chain_groupmean_bwd(xt, tl, torch.from_numpy(dy) * mul / 5, 0.2)
    assert torch.equal(got, want)
