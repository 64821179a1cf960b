"""The one-layer gather max route (pointcloudattack_tpu_torch/ops/
gather_hoist.py) on the CPU, where its wrappers run their plain versions:
the weight fold, the reverse lists and the pull, composed into y, am, dsrc
and dctr, against the JAX package's f32 oracle
``reference_gather_chain_groupmax`` (ops/pallas/gather_chain_kernel.py:710)
and ``jax.vjp`` of it; and the op's CPU path, which that route leaves as it
was.

Tolerances: y atol 1e-5 (``P[j] + Q[i]`` rounds otherwise than the
oracle's product of the built row, in sums of up to 16 terms); dsrc and
dctr atol 1e-5.  Where duplicate indices make rows of a group tie exactly,
``jnp.max`` splits the cotangent among them and the route puts it on the
first; both rows gathered the same point, so the sums agree.  The CUDA
kernels are held to these plain versions on the card by
tests/test_torch_gather_hoist_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloudattack_tpu.ops.pallas import gather_chain_kernel as jgc
from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.ops import gather_hoist as gh
from test_torch_chain_maxpool_cuda import make_layers, to_torch
from torch_threads import threads

torch_threads = threads(1)  # tests/torch_threads.py says why

reference = jax.jit(jgc.reference_gather_chain_groupmax, static_argnums=4)

DGCNN = (("diff", 0, 8, 0), ("center", 0, 8))
INITIAL = (("center", 0, 3), ("pass", 0, 3), ("diff", 0, 3, 0))  # CurveNet's initial LPFA
SSG2 = (("diff", 0, 3, 0), ("pass", 3, 11))

# (seed, B, N, G, K, Cs, Cc, layout, C1, shared, how): shared: the centers
# are the sources (N = G); how: "dup" half of each group's slots repeat its
# first, "hub" point 5 in the first 4 slots of every other group, "neg" a
# BatchNorm scale below 0 in every other unit
CASES = {
    "dgcnn": (0, 2, 40, 40, 6, 8, 8, DGCNN, 16, True, None),
    "initial": (1, 2, 48, 48, 8, 3, 3, INITIAL, 32, True, None),
    "ssg2": (2, 2, 32, 12, 8, 11, 3, SSG2, 16, False, None),
    "duplicates": (3, 2, 40, 40, 8, 8, 8, DGCNN, 16, True, "dup"),
    "hub": (4, 2, 40, 40, 8, 8, 8, DGCNN, 16, True, "hub"),
    "negative scale": (5, 2, 40, 40, 6, 8, 8, DGCNN, 24, True, "neg"),
}


def case(seed, b, n, g, k, cs, cc, layout, c1, shared, how):
    rng = np.random.RandomState(seed)
    src = rng.randn(b, n, cs).astype(np.float32)
    centers = src if shared else rng.randn(b, g, cc).astype(np.float32)
    idx = rng.randint(0, n, size=(b, g, k)).astype(np.int32)
    if how == "dup":
        idx[:, :, k // 2 :] = idx[:, :, :1]
    elif how == "hub":
        idx[:, ::2, :4] = 5
    layers = make_layers(rng, (gc.layout_width(layout), c1))
    if how == "neg":
        layers[0][3][::2] *= -1.0
    dy = rng.randn(b, g, c1).astype(np.float32)
    return src, centers, idx, layers, dy


def tensors(src, centers, idx, shared):
    s = torch.from_numpy(src)
    return s, (s if shared else torch.from_numpy(centers)), torch.from_numpy(idx)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_route_matches_jax_vjp(name):
    """y and am of the plain product and max, and dsrc and dctr of the plain
    reverse lists, pull and product, against the oracle and its VJP."""
    args = CASES[name]
    layout, shared = args[7], args[9]
    src, centers, idx, layers, dy = case(*args)
    jl = tuple(tuple(jnp.asarray(a) for a in layer) for layer in layers)
    want, vjp = jax.vjp(lambda s, c: reference(s, c, jnp.asarray(idx), jl, layout),
                        jnp.asarray(src), jnp.asarray(centers))
    want_src, want_ctr = vjp(jnp.asarray(dy))
    s, c, i = tensors(src, centers, idx, shared)
    layer = to_torch(layers)[0]
    gh.reset_launches()
    y, am = gh.hoisted_fwd(s, c, i, layer, layout)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    g = (torch.from_numpy(dy) * layer[3]).contiguous()
    dsrc, dctr = gh.hoisted_bwd(s, c, i, layer, layout, am, g)
    assert all(n == 0 for n in gh.LAUNCHES.values())
    np.testing.assert_allclose(dsrc.numpy(), np.asarray(want_src), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dctr.numpy(), np.asarray(want_ctr), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want_ctr)).max() > 0 and np.abs(np.asarray(want_src)).max() > 0


@pytest.mark.parametrize("name", ["dgcnn", "initial", "ssg2"])
def test_split_weight_folds_the_layout(name):
    """The built rows times w equal src @ W_src + centers @ W_ctr at every
    row."""
    args = CASES[name]
    layout, shared = args[7], args[9]
    src, centers, idx, layers, _ = case(*args)
    s, c, i = tensors(src, centers, idx, shared)
    w = to_torch(layers)[0][0]
    ws, wc = gh.split_weight(w, layout, s.shape[2], c.shape[2])
    rows = gc.gather_rows(s, c, i, layout) @ w
    folded = (s @ ws)[torch.arange(s.shape[0])[:, None, None], i.long()] + (c @ wc)[:, :, None]
    torch.testing.assert_close(folded, rows, rtol=0, atol=1e-5)


def test_split_weight_rejects_what_the_rows_cannot_take():
    w = torch.zeros(16, 4)
    with pytest.raises(ValueError, match="does not take"):
        gh.split_weight(w, (("diff", 0, 3, 0),), 3, 3)
    with pytest.raises(ValueError, match="exceeds"):
        gh.split_weight(w, (("diff", 0, 8, 0), ("center", 0, 8)), 8, 6)
    with pytest.raises(ValueError, match="bad layout"):
        gh.split_weight(w, (("sum", 0, 8), ("center", 0, 8)), 8, 8)


@pytest.mark.parametrize("how", [None, "dup", "hub"])
def test_lists_plain_is_a_stable_counting_sort(how):
    """Point j's entries are exactly the (i, k) with idx = j, ascending, each
    as (i << 3) | k at K=7; the offsets are the running counts."""
    _, _, idx, _, _ = case(6, 3, 30, 25, 7, 4, 4, (("pass", 0, 4),), 8, False, how)
    start, lst = gh.lists_plain(torch.from_numpy(idx), 30)
    assert start.dtype == torch.int32 and lst.dtype == torch.int32 and tuple(start.shape) == (3, 31)
    assert gh.key_bits(7) == 3 and gh.key_bits(8) == 3 and gh.key_bits(9) == 4 and gh.key_bits(1) == 0
    flat = idx.reshape(3, -1)
    for b in range(3):
        for j in range(30):
            got = lst[b, start[b, j] : start[b, j + 1]].numpy()
            e = np.flatnonzero(flat[b] == j)
            np.testing.assert_array_equal(got, (e // 7) << 3 | e % 7)
    assert int(start[:, -1].min()) == flat.shape[1]


@pytest.mark.parametrize("how", [None, "dup", "hub"])
def test_pull_plain_sums_in_list_order(how):
    """The pull equals the CPU scatter of each column's cotangent onto the
    point its argmax row gathered (``index_add_``, which adds in ascending
    (i, k), the lists' order) bit for bit."""
    src, centers, idx, layers, dy = case(7, 2, 30, 30, 7, 8, 8, DGCNN, 16, True, how)
    s, c, i = tensors(src, centers, idx, True)
    _, am = gh.hoisted_fwd(s, c, i, to_torch(layers)[0], DGCNN)
    g = torch.from_numpy(dy)
    start, lst = gh.lists_plain(i, 30)
    dp = gh.pull_plain(start, lst, am, g, 7)
    hit = am.long()[:, :, None, :] == torch.arange(7)[:, None]  # [B, G, K, C]
    contrib = torch.where(hit, g[:, :, None, :], 0.0).reshape(2, -1, 16)
    want = torch.zeros(2, 30, 16)
    for b in range(2):
        want[b].index_add_(0, i[b].reshape(-1).long(), contrib[b])
    assert torch.equal(dp, want)


def test_one_layer_cpu_path_is_unchanged():
    """On the CPU the one-layer op keeps its plain versions bit for bit
    (the route is for CUDA tensors), and launches nothing."""
    src, centers, idx, layers, dy = case(*CASES["dgcnn"])
    layer = to_torch(layers)
    assert gh.takes(layer, False) and not gh.takes(layer, True) and not gh.takes(layer * 2, False)
    gc.reset_launches()
    gh.reset_launches()
    s = torch.from_numpy(src).requires_grad_(True)
    y = gc.gather_chain_groupmax(s, s, torch.from_numpy(idx), layer, DGCNN)
    (grad,) = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), s)
    x = torch.from_numpy(src)
    y_ref, am = gc.gather_chain_plain(x, x, torch.from_numpy(idx), layer, DGCNN)
    dsrc, dctr = gc.gather_chain_bwd_plain(x, x, torch.from_numpy(idx), layer, DGCNN, am,
                                           torch.from_numpy(dy) * layer[0][3])
    assert torch.equal(y.detach(), y_ref) and torch.equal(grad, dsrc + dctr)
    assert all(n == 0 for n in gc.LAUNCHES.values()) and all(n == 0 for n in gh.LAUNCHES.values())


def test_other_devices_raise():
    t = torch.zeros(1, 4, 2, device="meta")
    i = torch.zeros(1, 4, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        gh.products([(t[0], t[0, :2])], "product_fwd")
    with pytest.raises(ValueError, match="no implementation"):
        gh.gather_max(t, t, i, *([t[0, 0]] * 4))
    with pytest.raises(ValueError, match="no implementation"):
        gh.reverse_lists(i, 4)
    with pytest.raises(ValueError, match="no implementation"):
        gh.pull(torch.zeros(1, 5, dtype=torch.int32, device="meta"), i.view(1, 8), i, t, 2)
