"""The ball route's hoisted kernels (pointcloudattack_tpu_torch/ops/
ball_hoist.py) on the CPU, where its wrappers run their plain versions:
the slots, the first layer folded into P and Q, the stack with its hidden
signs, the winners, the reverse lists and the pull, composed into y, am,
dsrc and dctr, against JAX's ``query_ball_point`` followed by the JAX
package's f32 oracle ``reference_gather_chain_groupmax``
(ops/pallas/gather_chain_kernel.py:710) and ``jax.vjp`` of it.

Tolerances: y atol 1e-5 (``P[j] + Q[i]`` rounds otherwise than the
oracle's product of the built row); the argmax equal to JAX's first
argmax except where a column's two best rows lie within 1e-5; dsrc and
dctr atol 1e-5 with rtol 1e-5 beside it (an empty ball's slots all fall
back to point 0, whose dsrc sums hundreds of rows' cotangents in another
order).  Where the padding copies of a short ball's first member tie
exactly, ``jnp.max`` splits the cotangent among them and the route puts it
on the first; all gathered the same point, so the sums agree.  The
winners, the reverse lists and the pull are held to numpy and CPU
scatters bit for bit.  The CUDA kernels are held to these plain versions
on the card by tests/test_torch_ball_hoist_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.ball_query import query_ball_point as j_query_ball_point
from pointcloudattack_tpu.ops.pallas import gather_chain_kernel as jgc
from pointcloudattack_tpu_torch.ops import ball_hoist as bh
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.ops.gather import index_points
from test_torch_chain_maxpool_cuda import make_layers, to_torch
from test_torch_gather_chain import to_jax
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

ATOL = 1e-5
reference_max = jax.jit(jgc.reference_gather_chain_groupmax, static_argnums=(4, 5, 6))
SSG = lambda cp: (("diff", 0, 3, 0), ("pass", 3, 3 + cp))  # noqa: E731
MSG = lambda cp: (("pass", 3, 3 + cp), ("diff", 0, 3, 0))  # noqa: E731

# (seed, B, N, G, feature width, layout, radius, K, widths, how): "far" moves
# every center 1.5 out (every ball empty), "grid" snaps the cloud to a 1/16
# grid (squared distances equal to the squared radius)
CASES = {
    "ssg K=4": (0, 2, 96, 24, 5, SSG, 0.25, 4, (16, 24), None),
    "msg K=8": (1, 2, 96, 24, 6, MSG, 0.25, 8, (16, 12, 24), None),
    "ssg K=16, three hidden layers": (2, 2, 128, 24, 5, SSG, 0.3, 16, (16, 20, 12, 24), None),
    "short balls": (3, 2, 96, 24, 4, SSG, 0.12, 16, (16, 24), None),
    "empty balls": (4, 2, 96, 24, 4, MSG, 0.1, 8, (16, 24), "far"),
    "overfull balls": (5, 2, 96, 24, 4, MSG, 2.0, 8, (16, 40), None),
    "N < K": (6, 2, 20, 8, 4, SSG, 0.5, 32, (16, 24), None),
    "on the radius": (7, 2, 256, 24, 4, SSG, 0.25, 16, (16, 24), "grid"),
}


def case(seed, b, n, g, cp, layout, radius, k, widths, how):
    """Points in the unit cube with features, the first ``g`` points as
    centers, seeded layers and cotangent: numpy arrays."""
    rng = np.random.RandomState(seed)
    xyz = rng.rand(b, n, 3).astype(np.float32)
    if how == "grid":
        xyz = (np.round(xyz * 8) / 16).astype(np.float32)
    src = np.concatenate([xyz, rng.randn(b, n, cp).astype(np.float32)], axis=-1)
    ctr = xyz[:, :g].copy()
    if how == "far":
        ctr += 1.5
    layers = make_layers(rng, (3 + cp, *widths))
    return src, ctr, xyz, layout(cp), layers, rng.randn(b, g, widths[-1]).astype(np.float32)


def jax_picks(src, ctr, idx, layers, layout):
    """The oracle's last-layer pre-activations' first argmax over each
    group's rows, and each column's gap between its two best rows."""
    h = jgc._reference_rows(jnp.asarray(src), jnp.asarray(ctr), jnp.asarray(idx), layout)
    for i, (w, b, mean, mul, beta) in enumerate(to_jax(layers)):
        z = (h @ w + b - mean) * mul + beta
        h = jnp.maximum(z, 0.0) if i < len(layers) - 1 else z
    top = jnp.sort(h, axis=2)
    return np.asarray(jnp.argmax(h, axis=2)), np.asarray(top[:, :, -1] - top[:, :, -2])


def route(name):
    """The plain route on one case: (inputs, slots, (P, Q, y, am, signs),
    g, (dsrc, dctr))."""
    args = CASES[name]
    src, ctr, xyz, layout, layers, dy = case(*args)
    s, c, x = (torch.from_numpy(a) for a in (src, ctr, xyz))
    tl = to_torch(layers)
    idx = bh.slots(x, c, args[6], args[7])
    fwd = bh.hoisted_fwd_plain(s, c, idx, tl, layout)
    g = (torch.from_numpy(dy) * tl[-1][3]).contiguous()
    bwd = bh.hoisted_bwd_plain(s, c, idx, tl, layout, fwd[3], g, fwd[4])
    return (src, ctr, xyz, layout, layers, dy), idx, fwd, g, bwd


@pytest.mark.parametrize("name", list(CASES))
def test_plain_route_matches_jax(name):
    """Slots equal to JAX's query; y, am, dsrc and dctr against the oracle
    and its VJP."""
    (src, ctr, xyz, layout, layers, dy), idx, (p, q, y, am, signs), _, (dsrc, dctr) = route(name)
    radius, k = CASES[name][6], CASES[name][7]
    jidx = np.asarray(j_query_ball_point(radius, k, jnp.asarray(xyz), jnp.asarray(ctr)))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    want, vjp = jax.vjp(lambda s_, c_: reference_max(s_, c_, jnp.asarray(jidx), to_jax(layers), layout, 0.0, False),
                        jnp.asarray(src), jnp.asarray(ctr))
    want_src, want_ctr = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    jam, gap = jax_picks(src, ctr, jidx, layers, layout)
    assert not ((am.numpy() != jam) & (gap > ATOL)).any()
    np.testing.assert_allclose(dsrc.numpy(), np.asarray(want_src), rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(dctr.numpy(), np.asarray(want_ctr), rtol=ATOL, atol=ATOL)
    assert np.abs(np.asarray(want_src)).max() > 0 and np.abs(np.asarray(want_ctr)).max() > 0
    assert tuple(signs.shape) == idx.shape + (sum(-(-w // 32) for w in bh.sign_widths(layers)),)


@pytest.mark.parametrize("name", ["ssg K=4", "msg K=8", "short balls", "empty balls", "N < K"])
def test_winners_and_lists_are_a_stable_sort(name):
    """The winners: each group's distinct argmax rows, ascending, packed
    group after group, with their bitmap; each point's list: the winning
    rows whose slot gathered it, ascending, a numpy stable sort."""
    _, idx, (_, _, _, am, _), _, _ = route(name)
    b, g, k = idx.shape
    n = CASES[name][2]
    win = bh.winners_plain(am, k)
    a = am.numpy().reshape(b * g, -1)
    rows = np.concatenate([i * k + np.unique(a[i]) for i in range(b * g)])
    np.testing.assert_array_equal(win.wrow.numpy(), rows)
    np.testing.assert_array_equal(win.off.numpy(), np.concatenate([[0], np.cumsum([len(np.unique(r)) for r in a])]))
    bits = bh.unpack_signs(win.mask, [k])[0].numpy()
    np.testing.assert_array_equal(np.flatnonzero(bits.reshape(-1)), rows)
    start, lst = bh.lists_plain(idx, win, n)
    keys = idx.numpy().reshape(-1)[rows]
    off = win.off.numpy()
    for c in range(b):
        lo, hi = off[c * g], off[(c + 1) * g]
        order = lo + np.argsort(keys[lo:hi], kind="stable")
        np.testing.assert_array_equal(lst.numpy()[lo:hi], order)
        for j in range(n):
            got = lst.numpy()[lo + start[c, j] : lo + start[c, j + 1]]
            np.testing.assert_array_equal(got, lo + np.flatnonzero(keys[lo:hi] == j))
    assert start.dtype == torch.int32 and lst.dtype == torch.int32 and int(start[:, -1].sum()) == len(rows)


@pytest.mark.parametrize("name", ["ssg K=4", "overfull balls", "empty balls"])
def test_pull_plain_sums_in_list_order(name):
    """dP equals the CPU scatter of each winning row's d1 onto the point its
    slot gathered (``index_add_``, which adds in ascending winner order, the
    lists' order) bit for bit, and dQ each group's sum of its winners' d1 in
    ascending k."""
    (_, _, _, _, layers, _), idx, (_, _, _, am, signs), g, _ = route(name)
    b, ng, k = idx.shape
    n = CASES[name][2]
    win = bh.winners_plain(am, k)
    d1 = bh.stack_bwd_plain(win, am, g, signs, to_torch(layers), k)
    start, lst = bh.lists_plain(idx, win, n)
    dp, dq = bh.pull_plain(start, lst, win, d1, n, ng)
    rows = win.wrow.long()
    cloud = rows // (ng * k)
    want = torch.zeros(b * n, d1.shape[1]).index_add_(0, cloud * n + idx.reshape(-1)[rows].long(), d1)
    assert torch.equal(dp, want.view(b, n, -1))
    off = win.off.tolist()
    for i in range(b * ng):
        acc = torch.zeros(d1.shape[1])
        for w in range(off[i], off[i + 1]):
            acc = acc + d1[w]
        assert torch.equal(dq.view(b * ng, -1)[i], acc)


@pytest.mark.parametrize("name", ["msg K=8", "overfull balls"])
def test_backward_is_deterministic(name):
    """Two plain backwards give the same bits, and the route's wrappers on
    the CPU give the plain composition's bits, launching nothing."""
    (src, ctr, _, layout, layers, _), idx, (_, _, _, am, signs), g, (dsrc, dctr) = route(name)
    s, c, tl = torch.from_numpy(src), torch.from_numpy(ctr), to_torch(layers)
    again = bh.hoisted_bwd_plain(s, c, idx, tl, layout, am, g, signs)
    assert torch.equal(again[0], dsrc) and torch.equal(again[1], dctr)
    bh.reset_launches()
    got = bh.hoisted_bwd(s, c, idx, tl, layout, am, g, signs)
    assert torch.equal(got[0], dsrc) and torch.equal(got[1], dctr)
    y, am2, signs2, _ = bh.hoisted_fwd(s, c, idx, tl, layout)
    assert torch.equal(am2, am) and torch.equal(signs2, signs)
    assert all(v == 0 for v in bh.LAUNCHES.values())


def test_signs_pack_and_unpack():
    """Each hidden layer's sides, 32 a word from a new word, unit 32 w + i
    at bit i, and back; the high bit of a word is the int32's sign."""
    rng = np.random.RandomState(9)
    sides = [torch.from_numpy(rng.rand(3, 5, w) > 0.5) for w in (16, 40, 32)]
    packed = bh.pack_signs(sides)
    assert packed.dtype == torch.int32 and packed.shape == (3, 5, 1 + 2 + 1)
    assert all(torch.equal(u, v) for u, v in zip(bh.unpack_signs(packed, (16, 40, 32)), sides))
    one = bh.pack_signs([torch.arange(32) == 31])
    assert int(one) == -(2 ** 31)


def test_stack_plain_signs_are_the_hidden_sides():
    """The stack's signs are its hidden pre-activations' sides, and its y and
    am those of ``gather_chain``'s plain max on the same slots within
    rounding."""
    (src, ctr, _, layout, layers, _), idx, (p, q, y, am, signs), _, _ = route("msg K=8")
    tl = to_torch(layers)
    z = index_points(p, idx) + q[:, :, None, :]
    sides = []
    for i, (w, b, mean, mul, beta) in enumerate(tl):
        z = ((z if i == 0 else torch.relu(z) @ w) + b - mean) * mul + beta
        if i < len(tl) - 1:
            sides.append(z > 0)
    assert all(torch.equal(u, v) for u, v in zip(bh.unpack_signs(signs, bh.sign_widths(tl)), sides))
    y_ref, am_ref = gc.gather_chain_plain(torch.from_numpy(src), torch.from_numpy(ctr), idx, tl, layout)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=ATOL)


def test_other_devices_raise():
    t = torch.zeros(1, 4, 3, device="meta")
    i = torch.zeros(1, 4, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        bh.slots(t, t, 0.2, 2)
    with pytest.raises(ValueError, match="no implementation"):
        bh.winners(i, 2)
    with pytest.raises(ValueError, match="no implementation"):
        bh.reverse_lists(i, bh.Winners(i, i, i), 4)
