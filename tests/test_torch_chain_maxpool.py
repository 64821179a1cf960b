"""Port of the fused chain + max-pool op (pointcloudattack_tpu_torch/ops/chain_maxpool.py)
against the JAX package's ``ops/pallas/dense_max_kernel.py``.

On the CPU the port runs its plain PyTorch versions; they are held to the
JAX f32 oracle ``reference_mlp_chain_maxpool`` and ``jax.grad`` of it at
atol 1e-5, and to the Pallas kernel in interpret mode at the loose
tolerance of tests/test_pallas_dense_max.py (interpret mode truncates the
matmul operands to bf16).  The CUDA kernel is held to the plain version
on the card by tests/test_torch_chain_maxpool_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.pallas.dense_max_kernel import (
    _chain_fwd_pallas,
    mlp_chain_maxpool as jax_mlp_chain_maxpool,
    reference_mlp_chain_maxpool,
)
from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
from test_torch_chain_maxpool_cuda import NARROW, PATH, inputs, make_layers, to_torch
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why


def to_jax(layers):
    return tuple(tuple(jnp.asarray(a) for a in layer) for layer in layers)


def jax_preact(x, layers):
    """The f32 chain before the pool, in the oracle's op order."""
    h = x
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        z = (h @ w + b - mean) * mul + beta
        h = jnp.maximum(z, 0.0) if i < len(layers) - 1 else z
    return h


@pytest.mark.parametrize("dims,n", [(NARROW, 64), (PATH, 128), ((64, 128, 1024), 96)])
def test_plain_forward_matches_f32_oracle(dims, n):
    x, layers, _ = inputs(0, 2, n, dims)
    y, idx = cm.chain_maxpool_plain(torch.from_numpy(x), to_torch(layers))
    want = reference_mlp_chain_maxpool(jnp.asarray(x), to_jax(layers))
    want_idx = jnp.argmax(jax_preact(jnp.asarray(x), to_jax(layers)), axis=1)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("dims,n", [(NARROW, 64), (PATH, 128), ((3, 1024), 64)])
def test_input_gradient_matches_jax_grad(dims, n):
    """dx through the autograd Function (plain backward on the CPU)."""
    x, layers, dy = inputs(1, 2, n, dims)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = cm.mlp_chain_maxpool(xt, to_torch(layers))
    (y * torch.from_numpy(dy)).sum().backward()
    jl = to_jax(layers)
    want = jax.grad(
        lambda a: jnp.sum(reference_mlp_chain_maxpool(a, jl) * jnp.asarray(dy))
    )(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_parameter_gradients_match_jax_grad():
    """Parameter cotangents come from autograd through the plain forward."""
    x, layers, dy = inputs(2, 2, 64, NARROW)
    tl = [tuple(t.requires_grad_(True) for t in layer) for layer in to_torch(layers)]
    y = cm.mlp_chain_maxpool(torch.from_numpy(x), tl)
    (y * torch.from_numpy(dy)).sum().backward()
    want = jax.grad(
        lambda ls: jnp.sum(reference_mlp_chain_maxpool(jnp.asarray(x), ls) * jnp.asarray(dy))
    )(to_jax(layers))
    for got_layer, want_layer in zip(tl, want):
        for got, w in zip(got_layer, want_layer):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims,n", [((64, 512), 256), (PATH, 128)])
def test_plain_forward_matches_interpret_mode_kernel(dims, n):
    """The Pallas kernel itself, run by the interpreter: bf16 operand
    truncation, hence the loose tolerance; it can move a near-tied
    column's winner, so idx is compared where the f32 top-2 gap is wide."""
    x, layers, _ = inputs(3, 2, n, dims)
    jl = to_jax(layers)
    want, want_idx = _chain_fwd_pallas(jnp.asarray(x), jl, interpret=True)
    y, idx = cm.chain_maxpool_plain(torch.from_numpy(x), to_torch(layers))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-2, atol=1e-2)
    top2 = np.sort(np.asarray(jax_preact(jnp.asarray(x), jl)), axis=1)[:, -2:]
    wide = (top2[:, 1] - top2[:, 0]) > 0.1
    np.testing.assert_array_equal(idx.numpy()[wide], np.asarray(want_idx)[wide])


def test_plain_gradient_matches_interpret_mode_kernel():
    """dx against the interpreted Pallas backward on the one-layer shape of
    tests/test_pallas_dense_max.py:60-78, at its tolerance.  (Deeper chains
    differ more there: bf16 also flips the ReLU masks of near-zero hidden
    units; the f32 oracle test above covers them at 1e-5.)  The backward
    is given the kernel's own winners, since bf16 can move a near tie."""
    x, layers, dy = inputs(3, 2, 256, (64, 512))
    jl, tl = to_jax(layers), to_torch(layers)
    _, want_idx = _chain_fwd_pallas(jnp.asarray(x), jl, interpret=True)
    want_dx = jax.grad(
        lambda a: jnp.sum(jax_mlp_chain_maxpool(a, jl, interpret=True) * jnp.asarray(dy))
    )(jnp.asarray(x))
    g = torch.from_numpy(dy) * tl[-1][3]
    dx = cm.chain_maxpool_bwd_plain(
        torch.from_numpy(x), tl, torch.from_numpy(np.array(want_idx)), g
    )
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=2e-2, atol=1e-2)


def test_ties_take_the_first_index():
    """Duplicate rows tie in every column: idx is the lowest row, and the
    whole cotangent lands on it, as the JAX kernel's argmax VJP puts it."""
    rng = np.random.RandomState(4)
    base = rng.randn(1, 8, 3).astype(np.float32)
    x = np.concatenate([base, base, base], axis=1)  # rows r, r+8, r+16 equal
    layers = make_layers(rng, NARROW)
    y, idx = cm.chain_maxpool_plain(torch.from_numpy(x), to_torch(layers))
    want_idx = jnp.argmax(jax_preact(jnp.asarray(x), to_jax(layers)), axis=1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert int(idx.max()) < 8
    g = torch.ones_like(y)
    dx = cm.chain_maxpool_bwd_plain(torch.from_numpy(x), to_torch(layers), idx, g)
    assert torch.count_nonzero(dx[:, 8:]) == 0
    assert torch.count_nonzero(dx[:, :8]) > 0


def test_cpu_path_launches_no_kernel():
    cm.reset_launches()
    x, layers, _ = inputs(5, 2, 64, NARROW)
    xt = torch.from_numpy(x).requires_grad_(True)
    cm.mlp_chain_maxpool(xt, to_torch(layers)).sum().backward()
    assert cm.LAUNCHES == {"fwd": 0, "bwd": 0, "bwd_lists": 0, "bwd_rows": 0}


def test_other_devices_raise():
    x, layers, _ = inputs(6, 1, 8, NARROW)
    meta = [tuple(t.to("meta") for t in layer) for layer in to_torch(layers)]
    with pytest.raises(ValueError, match="no implementation"):
        cm.chain_maxpool_fwd(torch.from_numpy(x).to("meta"), meta)
