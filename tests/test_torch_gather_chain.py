"""The port's gather + chain + max op (pointcloudattack_tpu_torch/ops/
gather_chain.py) against the JAX package's f32 oracle
``reference_gather_chain_groupmax`` (ops/pallas/gather_chain_kernel.py:710),
on the CPU, where the port runs its plain versions.

The oracle is the reference, not the Pallas kernel in interpret mode,
which truncates the matmul operands to bf16.  Tolerances: y atol 1e-5
(f32 sums of up to 323 terms in another order); dsrc and dctr against
``jax.vjp`` of the oracle at atol 1e-5.  Where duplicate indices make rows
tie exactly, ``jnp.max`` splits the cotangent among them and the port puts
it on the first; both rows gathered the same point, so the sums agree.
The CUDA kernel is held to the plain version on the card by
tests/test_torch_pointnet2_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.pallas import gather_chain_kernel as jgc
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from test_torch_chain_maxpool_cuda import make_layers, to_torch
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

SSG1 = (("diff", 0, 3, 0),)

# the f32 oracle, compiled once per layout and shape
reference_gather_chain_groupmax = jax.jit(jgc.reference_gather_chain_groupmax, static_argnums=4)


def ssg2(c):
    return (("diff", 0, 3, 0), ("pass", 3, c))


def msg2(c):
    return (("pass", 3, c), ("diff", 0, 3, 0))


DGCNN = (("diff", 0, 8, 0), ("center", 0, 8))  # centers are the source rows


def case(seed, b, n, g, k, cs, layout, widths, dup=False, centers_from_src=False):
    """Seeded src, centers, idx, layers and cotangent for one layout."""
    rng = np.random.RandomState(seed)
    src = rng.randn(b, n, cs).astype(np.float32)
    if centers_from_src:
        cidx = rng.randint(0, n, size=(b, g))
        centers = np.take_along_axis(src, cidx[..., None], axis=1)
    else:
        centers = src[:, :g, :3] + 0.01 * rng.randn(b, g, 3).astype(np.float32)
    idx = rng.randint(0, n, size=(b, g, k)).astype(np.int32)
    if dup:  # the ball query's padding: a group repeats its first index
        idx[:, :, k // 2 :] = idx[:, :, :1]
    c0 = gc.layout_width(layout)
    layers = make_layers(rng, (c0, *widths))
    dy = rng.randn(b, g, widths[-1]).astype(np.float32)
    return src, centers, idx, layers, dy


def to_jax(layers):
    return tuple(tuple(jnp.asarray(a) for a in layer) for layer in layers)


CASES = {
    "ssg1": dict(seed=0, b=2, n=64, g=16, k=8, cs=3, layout=SSG1, widths=(16, 16, 32)),
    "ssg2": dict(seed=1, b=2, n=32, g=8, k=16, cs=19, layout=ssg2(19), widths=(32, 32, 64)),
    "msg2": dict(seed=2, b=2, n=32, g=8, k=16, cs=35, layout=msg2(35), widths=(16, 24, 32)),
    "dgcnn": dict(seed=3, b=2, n=40, g=12, k=6, cs=8, layout=DGCNN, widths=(16, 32),
                  centers_from_src=True),
    "k_beyond_tile": dict(seed=4, b=1, n=256, g=4, k=128, cs=3, layout=SSG1, widths=(16, 16, 32)),
    "duplicates": dict(seed=5, b=2, n=48, g=8, k=16, cs=11, layout=ssg2(11), widths=(16, 32),
                       dup=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_f32_oracle(name):
    src, centers, idx, layers, _ = case(**CASES[name])
    layout = CASES[name]["layout"]
    want = reference_gather_chain_groupmax(
        jnp.asarray(src), jnp.asarray(centers), jnp.asarray(idx), to_jax(layers), layout)
    gc.reset_launches()
    y, am = gc.gather_chain_fwd(torch.from_numpy(src), torch.from_numpy(centers),
                                torch.from_numpy(idx), to_torch(layers), layout)
    assert gc.LAUNCHES == {"fwd": 0, "bwd": 0}
    assert am.dtype == torch.int32 and tuple(am.shape) == tuple(y.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # am is the first row attaining the max
    rows = gc.gather_rows(torch.from_numpy(src), torch.from_numpy(centers), torch.from_numpy(idx), layout)
    z, _ = gc._chain(rows, to_torch(layers))
    at_am = torch.gather(z, 2, am.long()[:, :, None, :])[:, :, 0]
    assert torch.equal(at_am, y)
    before = torch.arange(z.shape[2])[:, None] < am[:, :, None, :]
    assert not ((z == y[:, :, None, :]) & before).any()


@pytest.mark.parametrize("name", list(CASES))
def test_input_gradients_match_jax_vjp(name):
    """dsrc and dctr through the autograd Function (the plain backward on
    the CPU) against jax.vjp of the oracle."""
    src, centers, idx, layers, dy = case(**CASES[name])
    layout = CASES[name]["layout"]
    jl = to_jax(layers)
    _, vjp = jax.vjp(
        lambda s, c: reference_gather_chain_groupmax(s, c, jnp.asarray(idx), jl, layout),
        jnp.asarray(src), jnp.asarray(centers))
    want_src, want_ctr = vjp(jnp.asarray(dy))
    s = torch.from_numpy(src).requires_grad_(True)
    c = torch.from_numpy(centers).requires_grad_(True)
    y = gc.gather_chain_groupmax(s, c, torch.from_numpy(idx), to_torch(layers), layout)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_src), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_ctr), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want_ctr)).max() > 0  # the centers do receive a gradient


def test_parameter_gradients_match_jax_grad():
    """Parameter cotangents come from autograd through the plain forward."""
    src, centers, idx, layers, dy = case(**CASES["ssg2"])
    layout = CASES["ssg2"]["layout"]
    tl = [tuple(t.requires_grad_(True) for t in layer) for layer in to_torch(layers)]
    y = gc.gather_chain_groupmax(torch.from_numpy(src), torch.from_numpy(centers),
                                 torch.from_numpy(idx), tl, layout)
    (y * torch.from_numpy(dy)).sum().backward()
    want = jax.grad(lambda ls: jnp.sum(reference_gather_chain_groupmax(
        jnp.asarray(src), jnp.asarray(centers), jnp.asarray(idx), ls, layout) * dy))(to_jax(layers))
    for got_layer, want_layer in zip(tl, want):
        for got, w in zip(got_layer, want_layer):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_plain_backward_puts_the_cotangent_on_the_first_tie():
    """All K rows of group g gather point g: every column ties, and the
    whole cotangent lands on that point once, with its negation on the
    group's center."""
    src, centers, idx, layers, dy = case(**CASES["ssg1"])
    g_count = idx.shape[1]
    idx[:] = np.arange(g_count, dtype=np.int32)[None, :, None]
    tl = to_torch(layers)
    args = (torch.from_numpy(src), torch.from_numpy(centers), torch.from_numpy(idx), tl, SSG1)
    y, am = gc.gather_chain_plain(*args)
    assert int(am.max()) == 0
    g = torch.from_numpy(dy) * tl[-1][3]
    dsrc, dctr = gc.gather_chain_bwd_plain(*args, am, g)
    assert torch.count_nonzero(dsrc[:, g_count:]) == 0
    assert torch.count_nonzero(dsrc[:, :g_count]) > 0
    torch.testing.assert_close(dctr, -dsrc[:, :g_count], rtol=0, atol=0)


def test_other_devices_raise():
    src, centers, idx, layers, _ = case(**CASES["ssg1"])
    meta = [tuple(t.to("meta") for t in layer) for layer in to_torch(layers)]
    with pytest.raises(ValueError, match="no implementation"):
        gc.gather_chain_fwd(torch.from_numpy(src).to("meta"), torch.from_numpy(centers).to("meta"),
                            torch.from_numpy(idx).to("meta"), meta, SSG1)
