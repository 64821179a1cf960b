"""The gather op's last two routes (pointcloudattack_tpu_torch/ops/
gather_chain.py) against the JAX package's f32 oracles, on the CPU, where
the port runs its plain versions:

* the mean pool with and without the rows' activation (``pre_act``), at
  LeakyReLU slope 0.2 and at ReLU, against ``reference_gather_chain_groupmean``
  (ops/pallas/gather_chain_kernel.py:728) and ``jax.vjp`` of it;
* the max pool at slope 0.2 against ``reference_gather_chain_groupmax``;
* the ball route against JAX's ``query_ball_point`` followed by
  ``reference_gather_chain_groupmax``: the slots equal JAX's indices
  exactly, y and the input gradients within atol 1e-5, at empty,
  overfull, on-the-radius (a 1/16 grid) and N < K balls, the cases of the
  JAX package's own ``test_ball_fused_empty_and_overfull``.

The oracles, not the Pallas kernels in interpret mode, which truncate the
matmul operands to bf16.  Tolerances: y atol 1e-5 (f32 sums in another
order); dsrc and dctr atol 1e-5, and on the ball route rtol 1e-5 beside it:
every slot of an empty ball falls back to point 0, whose dsrc then sums
the cotangents of 384 rows (16 slots of 24 balls) to about 9, and an f32
sum of that many terms in another order moves by some 2e-6 of its size.
The CUDA kernels are held to the plain versions on the card by
tests/test_torch_gather_routes_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.ball_query import query_ball_point as j_query_ball_point
from pointcloudattack_tpu.ops.pallas import gather_chain_kernel as jgc
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from test_torch_chain_maxpool_cuda import make_layers, to_torch
from test_torch_gather_chain import to_jax
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

ATOL = 1e-5
reference_mean = jax.jit(jgc.reference_gather_chain_groupmean, static_argnums=(4, 5, 6))
reference_max = jax.jit(jgc.reference_gather_chain_groupmax, static_argnums=(4, 5, 6))


def mean_case(seed, b=2, n=48, c=12, k=10, widths=(16,), dup=False):
    """Folded residual-LPFA-like sources S and centers T, kNN-like indices
    (each point's own row first), layers and cotangent."""
    rng = np.random.RandomState(seed)
    src = rng.randn(b, n, c).astype(np.float32)
    ctr = (src + 0.3 * rng.randn(b, n, c)).astype(np.float32)
    idx = rng.randint(0, n, size=(b, n, k)).astype(np.int32)
    idx[:, :, 0] = np.arange(n)
    if dup:
        idx[:, :, k // 2:] = idx[:, :, 1:2]
    layers = make_layers(rng, (c, *widths))
    dy = rng.randn(b, n, widths[-1]).astype(np.float32)
    return src, ctr, idx, layers, dy


MEAN_CASES = {
    "pre_act slope 0.2": dict(kw={}, slope=0.2, pre_act=True),
    "no pre_act slope 0.2": dict(kw={}, slope=0.2, pre_act=False),
    "pre_act relu": dict(kw={}, slope=0.0, pre_act=True),
    "two layers": dict(kw=dict(widths=(24, 16)), slope=0.2, pre_act=True),
    "duplicates": dict(kw=dict(dup=True), slope=0.2, pre_act=True),
}


@pytest.mark.parametrize("name", list(MEAN_CASES))
def test_mean_route_matches_jax_oracle(name):
    """y and (dsrc, dctr) through the autograd op against the oracle and
    ``jax.vjp`` of it; no kernel is launched on the CPU."""
    case = MEAN_CASES[name]
    src, ctr, idx, layers, dy = mean_case(3, **case["kw"])
    layout = (("diff", 0, src.shape[-1], 0),)
    slope, pre_act = case["slope"], case["pre_act"]
    want, vjp = jax.vjp(lambda s, c: reference_mean(s, c, jnp.asarray(idx), to_jax(layers), layout, slope, pre_act),
                        jnp.asarray(src), jnp.asarray(ctr))
    want_src, want_ctr = vjp(jnp.asarray(dy))
    s = torch.from_numpy(src).requires_grad_(True)
    c = torch.from_numpy(ctr).requires_grad_(True)
    gc.reset_launches()
    y = gc.gather_chain_groupmean(s, c, torch.from_numpy(idx), to_torch(layers), layout, slope, pre_act)
    (y * torch.from_numpy(dy)).sum().backward()
    assert all(n == 0 for n in gc.LAUNCHES.values())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_src), rtol=0, atol=ATOL)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_ctr), rtol=0, atol=ATOL)
    assert np.abs(np.asarray(want_ctr)).max() > 0


def test_mean_plain_backward_is_the_autograd_gradient():
    """The plain backward that the kernel is held to on the card (g = dy *
    mul_L / K on every row, through the activations) gives autograd's
    gradient of the plain forward."""
    src, ctr, idx, layers, dy = mean_case(4, widths=(20, 16))
    layout = (("diff", 0, src.shape[-1], 0),)
    tl = to_torch(layers)
    s = torch.from_numpy(src).requires_grad_(True)
    c = torch.from_numpy(ctr).requires_grad_(True)
    y = gc.gather_chain_mean_plain(s, c, torch.from_numpy(idx), tl, layout, 0.2, True)
    want_s, want_c = torch.autograd.grad(y, (s, c), torch.from_numpy(dy))
    g = torch.from_numpy(dy) * tl[-1][3] / idx.shape[2]
    got_s, got_c = gc.gather_chain_mean_bwd_plain(torch.from_numpy(src), torch.from_numpy(ctr), torch.from_numpy(idx),
                                                  tl, layout, g, 0.2, True)
    torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_c, want_c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("widths", [(32,), (24, 32)])
def test_slope_max_matches_jax_oracle(widths):
    """The initial LPFA's gather (center / pass / diff on the points
    themselves) at LeakyReLU 0.2: y, and the input gradient through both
    the sources and the centers, which are the same points."""
    rng = np.random.RandomState(5)
    xyz = (rng.randn(2, 64, 3) * 0.5).astype(np.float32)
    idx = rng.randint(0, 64, size=(2, 64, 8)).astype(np.int32)
    layers = make_layers(rng, (9, *widths))
    dy = rng.randn(2, 64, widths[-1]).astype(np.float32)
    layout = (("center", 0, 3), ("pass", 0, 3), ("diff", 0, 3, 0))
    want, vjp = jax.vjp(lambda p: reference_max(p, p, jnp.asarray(idx), to_jax(layers), layout, 0.2, False),
                        jnp.asarray(xyz))
    (want_g,) = vjp(jnp.asarray(dy))
    p = torch.from_numpy(xyz).requires_grad_(True)
    y = gc.gather_chain_groupmax(p, p, torch.from_numpy(idx), to_torch(layers), layout, slope=0.2)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=0, atol=ATOL)


def ball_case(seed=7, b=2, n=128, s=24, cp=8, kind="ssg"):
    """The JAX package's ``_ball_case``: points in the unit cube, features,
    the first ``s`` points as centers, a 2-layer chain."""
    rng = np.random.RandomState(seed)
    xyz = rng.rand(b, n, 3).astype(np.float32)
    src = np.concatenate([xyz, rng.randn(b, n, cp).astype(np.float32)], axis=-1)
    ctr = xyz[:, :s].copy()
    layout = (("diff", 0, 3, 0), ("pass", 3, 3 + cp)) if kind == "ssg" else (("pass", 3, 3 + cp), ("diff", 0, 3, 0))
    layers = make_layers(rng, (3 + cp, 32, 64))
    return src, ctr, xyz, layout, layers, rng.randn(b, s, 64).astype(np.float32)


def grid_case():
    """Points and centers on a 1/16 grid in a cube of side 0.5, radius 0.25:
    many squared distances equal the squared radius exactly, so the ``<=``
    decides."""
    src, ctr, xyz, layout, layers, dy = ball_case(seed=8, n=256)
    xyz = (np.round(xyz * 8) / 16).astype(np.float32)
    src[..., :3] = xyz
    return src, xyz[:, :24].copy(), xyz, layout, layers, dy


BALL_CASES = {
    "ssg": (lambda: ball_case(), 0.25, 16),
    "msg": (lambda: ball_case(kind="msg"), 0.25, 16),
    # every center 1.5 beyond its point in each coordinate: no point of the unit cube within 0.1
    "empty": (lambda: (lambda c: (c[0], c[1] + 1.5, *c[2:]))(ball_case()), 0.1, 16),
    "overfull": (lambda: ball_case(), 2.0, 16),
    "on the radius": (grid_case, 0.25, 16),
    "N < K": (lambda: ball_case(n=20, s=8), 0.5, 32),
}


@pytest.mark.parametrize("name", list(BALL_CASES))
def test_ball_route_matches_jax_query_and_oracle(name):
    make, radius, k = BALL_CASES[name]
    src, ctr, xyz, layout, layers, dy = make()
    dy = dy[:, : ctr.shape[1]]
    jidx = np.asarray(j_query_ball_point(radius, k, jnp.asarray(xyz), jnp.asarray(ctr)))
    want, vjp = jax.vjp(lambda s_, c_: reference_max(s_, c_, jnp.asarray(jidx), to_jax(layers), layout, 0.0, False),
                        jnp.asarray(src), jnp.asarray(ctr))
    want_src, want_ctr = vjp(jnp.asarray(dy))
    y_plain, _, idx = gc.ball_gather_chain_plain(torch.from_numpy(src), torch.from_numpy(ctr), torch.from_numpy(xyz),
                                                 to_torch(layers), layout, radius, k)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    s = torch.from_numpy(src).requires_grad_(True)
    c = torch.from_numpy(ctr).requires_grad_(True)
    x = torch.from_numpy(xyz).requires_grad_(True)
    gc.reset_launches()
    y = gc.ball_gather_chain_groupmax(s, c, x, to_torch(layers), layout, radius, k)
    (y * torch.from_numpy(dy)).sum().backward()
    assert all(n == 0 for n in gc.LAUNCHES.values())
    assert torch.equal(y.detach(), y_plain) and x.grad is None  # xyz takes no gradient
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_src), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_ctr), rtol=ATOL, atol=ATOL)


def test_ball_cases_reach_what_they_name():
    """The cases hold what their names say: every ball empty (the fill is
    point 0), every ball overfull, pairs exactly on the radius, fewer
    points than slots."""
    def sqr(name):
        _, ctr, xyz = BALL_CASES[name][0]()[:3]
        return ((ctr[:, :, None, :].astype(np.float64) - xyz[:, None, :, :]) ** 2).sum(-1)

    assert (sqr("empty") > 0.1 ** 2).all()
    assert ((sqr("overfull") <= 2.0 ** 2).sum(-1) > 16).all()
    assert (sqr("on the radius") == 0.25 ** 2).sum() > 50
    within = (sqr("N < K") <= 0.5 ** 2).sum(-1)
    assert sqr("N < K").shape[-1] < BALL_CASES["N < K"][2] and (within < BALL_CASES["N < K"][2]).all()


def test_other_devices_raise():
    src, ctr, idx, layers, _ = mean_case(6)
    meta = [tuple(t.to("meta") for t in layer) for layer in to_torch(layers)]
    t = [torch.from_numpy(a).to("meta") for a in (src, ctr, idx)]
    with pytest.raises(ValueError, match="no implementation"):
        gc.gather_chain_mean_fwd(*t, meta, (("diff", 0, src.shape[-1], 0),))
    with pytest.raises(ValueError, match="no implementation"):
        gc.ball_gather_chain_fwd(t[0], t[1], t[0][..., :3], meta, (("diff", 0, 3, 0),), 0.2, 4)
