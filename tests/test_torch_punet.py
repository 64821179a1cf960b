"""The port's PU-Net upsampler and its 3-NN interpolation
(pointcloudattack_tpu_torch/models/punet.py, ops/interpolate.py) against
the JAX package, on the CPU.

Tolerances:
- ``three_nn_interpolate`` on clouds inside the unit ball: values atol
  1e-5; the gradients of a weighted sum with respect to both clouds and the
  features within 1e-5 of their largest magnitude (up to 37 here: a near
  pair's 1 / d^2 scales the rounding of its distance, which the JAX package
  takes from an einsum and the port from coordinate sums).
- ``PUNet`` at npoint 64 (four set abstractions of 64, 32, 16 and 8
  centres) on flax-initialised variables, their biases drawn from a seed,
  exported by ``state_dict_from_flax("PUNet")``: the upsampled clouds and
  the input gradient of a weighted sum of them, atol 1e-5.  The JAX model
  runs its plain path on the CPU (no Pallas kernel), the port its plain
  group chain.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.models.punet import PUNet as JPUNet
from pointcloudattack_tpu.ops.interpolate import three_nn_interpolate as j_interpolate
from pointcloudattack_tpu_torch.models import punet
from pointcloudattack_tpu_torch.ops import fps as fps_mod
from pointcloudattack_tpu_torch.ops import group_chain as gch
from pointcloudattack_tpu_torch.ops.interpolate import three_nn_interpolate
from pointcloudattack_tpu_torch.train.weights import state_dict_from_flax
from torch_threads import threads

torch_threads = threads(2)  # tests/torch_threads.py says why

NPOINT, UP = 64, 4


def test_three_nn_interpolate_matches_jax():
    # clouds inside the unit ball, as PU-Net sees them: the distances' rounding (the JAX package's einsum
    # against the port's coordinate sums) reaches the weights through 1 / d
    rng = np.random.RandomState(0)
    dst = (rng.rand(2, 50, 3) - 0.5).astype(np.float32)
    src = (rng.rand(2, 12, 3) - 0.5).astype(np.float32)
    src[1, 5] = dst[1, 7]  # a destination point on a source point: d = 0
    feat = rng.randn(2, 12, 6).astype(np.float32)
    w = rng.randn(2, 50, 6).astype(np.float32)

    def jloss(a, b, f):
        return jnp.sum(j_interpolate(a, b, f) * w)

    want = np.asarray(j_interpolate(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(feat)))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(dst), jnp.asarray(src), jnp.asarray(feat))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (dst, src, feat)]
    got = three_nn_interpolate(*args)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    for a, g in zip(args, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(a.grad.numpy(), g, rtol=0, atol=1e-5 * max(1.0, np.abs(g).max()))


@pytest.fixture(scope="module")
def pair():
    """(JAX apply, its variables, the port's PUNet on the exported state dict)."""
    jm = JPUNet(npoint=NPOINT, up_ratio=UP)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, NPOINT, 3), jnp.float32)))
    rng = np.random.RandomState(1)
    # flax draws zero biases: give them values, so that every bias reaches its layer
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.05 * rng.randn(*a.shape)).astype(np.float32) if a.ndim == 1 else np.asarray(a), v)
    model = punet.PUNet(npoint=NPOINT, up_ratio=UP)
    model.load_state_dict(state_dict_from_flax("PUNet", v, up_ratio=UP), strict=True)
    model.eval()
    return jax.jit(lambda a: jm.apply(v, a)), model


def clouds(seed, b=2):
    x = np.random.RandomState(seed).randn(b, NPOINT, 3).astype(np.float32)
    return x / (2 * np.abs(x).max())  # inside the unit ball, as a normalised cloud


def test_punet_output_and_input_gradient_match_jax(pair):
    jfn, model = pair
    x = clouds(2)
    w = np.random.RandomState(3).randn(2, UP * NPOINT, 3).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x)))
    a = torch.from_numpy(x).requires_grad_(True)
    got = model(a)
    assert got.shape == (2, UP * NPOINT, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), jgrad, rtol=0, atol=1e-5)


def test_every_relu_goes_through_the_module_function_and_no_kernel_launches(pair, monkeypatch):
    """16 ReLUs a forward (4 pooled set abstractions, 3 propagations, 2 per
    expansion branch, the head's first layer), every one through
    ``punet.relu``, so that a caller can replay their signs; on CPU tensors
    no kernel launches."""
    _, model = pair
    calls = []
    orig = punet.relu
    monkeypatch.setattr(punet, "relu", lambda x: calls.append(x.shape) or orig(x))
    gch.reset_launches()
    fps_mod.reset_launches()
    a = torch.from_numpy(clouds(4)).requires_grad_(True)
    model(a).sum().backward()
    assert len(calls) == 4 + 3 + 2 * UP + 1
    assert all(v == 0 for v in gch.LAUNCHES.values()) and fps_mod.LAUNCHES["fps"] == 0
