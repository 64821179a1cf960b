"""The bookkeeping of ``chip_smoke.py`` that runs on the CPU: the least-work
counts behind its kNN and gather bounds, and the rule by which its KNN
card-against-CPU check lets a point part.

The gather bound charges a one-layer EdgeConv per point, not per edge row;
``test_gather_bound_factoring_computes_the_layer`` holds that factored
algorithm to the plain gather + layer + max (atol 1e-5: f32 sums in another
order).
"""

import sys
from pathlib import Path

import numpy as np
import torch

from pointcloudattack_tpu_torch.ops import gather_chain as gc
from pointcloudattack_tpu_torch.ops.knn import knn_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its bounds and its parting rule)
from torch_threads import threads  # noqa: E402

torch_threads = threads(1)  # tests/torch_threads.py says why


def test_knn_bound_charges_one_compare_a_pair():
    b, n, c, k = 16, 1024, 3, 20
    flops = b * n * n * (2 * c + 3) + 2 * b * n * c + b * n * k * np.log2(k)
    t, by = chip_smoke.knn_bound(b, n, c, k)
    assert by == "operations"
    assert t == flops / chip_smoke.PEAK_FLOPS * 1e3
    # k compares a pair (one selection pass per pick) would cost 3x more at C=3
    assert chip_smoke.bound(b * n * n * (2 * c + 2 + k), 0)[0] > 2.5 * t


def test_gather_bound_counts_per_point_products():
    layout = (("diff", 0, 64, 0), ("center", 0, 64))
    b, n, k = 16, 1024, 20
    got = chip_smoke.gather_fwd_flops(n, b, n, k, layout, (128, 64))
    assert got == 2.0 * b * 64 * (n * 64 + n * 128) + b * n * k * 64
    # a hidden layer after the first costs its full product on every row
    ssg = (("diff", 0, 3, 0), ("pass", 3, 131))
    rows = b * 128 * 64
    want = 2.0 * b * 128 * (512 * 131 + 128 * 3) + rows * 128 + chip_smoke.chain_flops(rows, (128, 128, 256))
    assert chip_smoke.gather_fwd_flops(512, b, 128, 64, ssg, (131, 128, 128, 256)) == want


def test_gather_bound_factoring_computes_the_layer():
    """The work the one-layer bound charges computes the layer: per point
    P = x W1 and Q = x (W2 - W1), the BatchNorm scale folded in, then
    max_j P[j] + Q[i] over each point's k neighbours."""
    rng = np.random.RandomState(0)
    b, n, c, k, cout = 2, 64, 8, 5, 16
    x = torch.from_numpy(rng.randn(b, n, c).astype(np.float32))
    idx = knn_plain(x, k)
    layout = (("diff", 0, c, 0), ("center", 0, c))
    (w, bias, mean, mul, beta), = chip_smoke.seeded_layers(rng, (2 * c, cout), "cpu")
    mul = mul * torch.from_numpy(np.where(rng.rand(cout) < 0.5, -1.0, 1.0).astype(np.float32))
    want, _ = gc.gather_chain_plain(x, x, idx, [(w, bias, mean, mul, beta)], layout)
    p = (x @ w[:c]) * mul
    q = (x @ (w[c:] - w[:c]) + bias - mean) * mul + beta
    nbr = torch.gather(p[:, None].expand(b, n, n, cout), 2, idx.long()[..., None].expand(b, n, k, cout))
    torch.testing.assert_close(nbr.amax(2) + q, want, rtol=0.0, atol=1e-5)


def _run(b=2, n=6, steps=4, seed=0):
    rng = np.random.RandomState(seed)
    it = torch.from_numpy(rng.randn(steps + 1, b, n, 3).astype(np.float32))
    grads = [torch.from_numpy(rng.randn(b, n, 3).astype(np.float32)) for _ in range(steps)]
    return it, grads


def test_parting_allowed_where_a_gradient_was_near_zero():
    card, g = _run()
    cpu = card.clone()
    g[1][0, 3, 2] = 1e-8  # rounding of 0 next to the cloud's largest, about 1
    cpu[2:, 0, 3, 2] += 3e-4  # Adam's step parts the point after it
    parted, why, unexplained = chip_smoke.parted_points(card, cpu, g, g)
    assert parted.nonzero().tolist() == [[0, 3]]
    assert unexplained == [] and "parted at step 2 in coordinates [2]" in why[0]


def test_parting_refused_where_every_gradient_was_clear_of_zero():
    card, g = _run()
    for gi in g:
        gi.copy_(gi.sign() * (gi.abs() + 0.1))
    cpu = card.clone()
    cpu[3:, 1, 4, 0] -= 1e-3
    cpu[:, 0, 1, 1] += 1e-3  # apart from the start: nothing explains it
    parted, _, unexplained = chip_smoke.parted_points(card, cpu, g, g)
    assert parted.nonzero().tolist() == [[0, 1], [1, 4]]
    assert sorted(unexplained) == [(0, 1), (1, 4)]


def test_geoa3_bounds_charge_the_functions_least_work():
    b, n, k = 8, 1024, 16
    t, by = chip_smoke.kappa_bound(b, n, k)
    flops = 9.0 * b * n * n + b * n * (k + 1) * np.log2(k + 1) + 11.0 * b * n * k + 5.0 * b * n
    assert by == "operations" and np.isclose(t, flops / chip_smoke.PEAK_FLOPS * 1e3)
    # the backward reads the inputs and the picks and writes two gradients: bytes bound it
    t, by = chip_smoke.kappa_bwd_bound(b, n, k)
    nbytes = 4.0 * (6 * b * n + b * n + b * n * k + 6 * b * n)
    assert by == "bytes" and np.isclose(t, nbytes / chip_smoke.PEAK_BYTES * 1e3)
    t, by = chip_smoke.both_bound(b, n, n)
    assert by == "operations" and np.isclose(t, 10.0 * b * n * n / chip_smoke.PEAK_FLOPS * 1e3)
    assert chip_smoke.both_bwd_bound(b, n, n)[1] == "bytes"


def _rounds(rounds=2, iters=3, b=2, n=6, seed=1):
    rng = np.random.RandomState(seed)
    it = torch.from_numpy(rng.randn(rounds * iters, b, n, 3).astype(np.float32))
    grads = [torch.from_numpy(rng.randn(b, n, 3).astype(np.float32)) + 2.0 for _ in range(rounds * iters)]
    return it, grads


def test_round_partings_explain_the_first_parting():
    card, g = _rounds()
    cpu = card.clone()
    cpu[2, 1, 4, 0] += 1e-3  # round 0, step 2: point 4 of cloud 1
    cpu[4:, 0, 2, 1] -= 1e-3  # round 1, step 4 (its second): point 2 of cloud 0
    parted, lines, ok = chip_smoke.round_partings(card, cpu, g, 3)
    assert parted.nonzero().tolist() == [[0, 2], [1, 4]] and not ok  # no gradient near 0: unexplained
    g[1][1, 4, 0] = 1e-6  # rounding of 0 next to the cloud's largest, about 3
    parted, lines, ok = chip_smoke.round_partings(card, cpu, g, 3)
    assert ok and "round 0 cloud 1: 1 points part first at step 2" in lines[0]
    # the two sides' gradients of the coordinate differ by more than GRAD_APART at an earlier step
    g[1][1, 4, 0] = 2.0
    g_cpu = [t.clone() for t in g]
    assert not chip_smoke.round_partings(card, cpu, g, 3, g_cpu=g_cpu)[2]
    g_cpu[0][1, 4, 0] = 2.0 * (1 + 2 * chip_smoke.GRAD_APART)
    assert chip_smoke.round_partings(card, cpu, g, 3, g_cpu=g_cpu)[2]


def test_round_partings_explain_a_parting_by_another_choice():
    card, g = _rounds()
    cpu = card.clone()
    cpu[1:3, 0, 3, 2] += 1e-3  # round 0: point 3 of cloud 0 parts at step 1
    same = lambda c, a: {"nearest": torch.zeros(1, dtype=torch.int64)}  # noqa: E731
    assert not chip_smoke.round_partings(card, cpu, g, 3, same)[2]
    other = lambda c, a: {"nearest": (a[0, 3, 2] > card[0, 0, 3, 2] + 5e-4).long().view(1)}  # noqa: E731
    parted, lines, ok = chip_smoke.round_partings(card, cpu, g, 3, other)
    assert not ok  # at step 0, before the parting, both sides still chose alike
    cpu[0, 0, 3, 2] += 1e-6  # now step 0 differs by less than PART_ATOL, yet chooses otherwise
    other = lambda c, a: {"nearest": (a[0, 3, 2] > card[0, 0, 3, 2]).long().view(1)}  # noqa: E731
    parted, lines, ok = chip_smoke.round_partings(card, cpu, g, 3, other)
    assert ok and "(0, 'nearest')" in lines[0]


def test_group_bound_counts_the_chain_as_chain_bound_does():
    b, g, k, dims = 8, 1024, 20, (9, 32)
    rows = b * g * k
    fwd = chip_smoke.group_bound(b, g, k, dims, "max")
    want = chip_smoke.bound(chip_smoke.chain_flops(rows, dims),
                            4.0 * rows * 9 + 2 * 4.0 * b * g * 32 + chip_smoke.param_bytes(dims))
    assert fwd == want
    # the max's backward charges the winning rows and, at one layer, reads no rows; the mean's runs every
    # row twice and reads them
    win = 5000
    assert chip_smoke.group_bound(b, g, k, dims, "max", win)[0] == chip_smoke.bound(
        chip_smoke.chain_bwd_flops(win, b * g, dims), 4.0 * rows * 9 + 2 * 4.0 * b * g * 32
        + 2 * chip_smoke.param_bytes(dims))[0]
    two = (9, 32, 32)
    assert chip_smoke.group_bound(b, g, k, two, "max", win)[0] == chip_smoke.bound(
        chip_smoke.chain_bwd_flops(win, b * g, two), 2 * 4.0 * rows * 9 + 2 * 4.0 * b * g * 32
        + 2 * chip_smoke.param_bytes(two))[0]
    mean = chip_smoke.group_bound(b, g, k, (16, 16), "mean", rows)
    assert mean == chip_smoke.bound(2 * chip_smoke.chain_flops(rows, (16, 16)),
                                    2 * 4.0 * rows * 16 + 4.0 * b * g * 16 + 2 * chip_smoke.param_bytes((16, 16)))
    assert mean[1] == "bytes"  # 16 -> 16 over 20-row groups moves more than it computes
    assert chip_smoke.group_bound(b, 64, k, (128, 128), "mean", b * 64 * k)[1] == "operations"


def test_bn_passes_count_the_walk_batchnorms():
    assert chip_smoke.bn_passes("CurveNet", "cic11.curvegrouping.walk.agent_mlp.1") == 5
    assert chip_smoke.bn_passes("CurveNet", "cic22.curvegrouping.walk.momentum_mlp.1") == 4
    assert chip_smoke.bn_passes("CurveNet", "cic22.lpfa.mlp.0.1") == 1
    assert chip_smoke.bn_passes("DGCNN", "walk.agent_mlp") == 1


def test_make_victim_checks_each_batchnorms_updates():
    """make_victim's train pass over CurveNet updates the walk's BatchNorms
    5 and 4 times and every other once; a count of 1 for all would fail."""
    x = torch.from_numpy((np.random.RandomState(2).randn(2, 1024, 3) * 0.5).astype(np.float32))
    fn, state = chip_smoke.make_victim("CurveNet", "cpu", x, ("dp1",))
    counts = {k.removesuffix(".num_batches_tracked"): int(v) for k, v in state.items()
              if k.endswith("num_batches_tracked")}
    assert counts["cic11.curvegrouping.walk.agent_mlp.1"] == 5
    assert counts["cic21.curvegrouping.walk.momentum_mlp.1"] == 4
    assert {v for k, v in counts.items() if "walk" not in k} == {1}
    assert fn(x).shape == (2, chip_smoke.NUM_CLASSES)


def test_replayed_choices_take_the_given_choices():
    """CurveNet on the CPU replaying its own recorded choices and activation
    signs (``replay`` with ``curvenet_hooks``) gives the same logits and
    input gradient, each taken choice 0 from its own; walk picks that are
    other candidates change the curves, and the replay reports how far below
    the best they lie; flipped signs move the gradient and are counted for
    their cloud.  The masked max pools count their repeated rows (a short
    ball's padding) as exact ties."""
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.ops import group_chain as gch
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    model = models.make_model("CurveNet", 10, generator=torch.Generator().manual_seed(0), k=8)
    fn = make_model_fn(model, None, "cpu")
    curves = []
    model.cic11.curvegrouping.walk.register_forward_hook(lambda m, a, out: curves.append(out.detach()))
    x = torch.from_numpy((np.random.RandomState(3).randn(1, 1024, 3) * 0.5).astype(np.float32))
    hooks = chip_smoke.curvenet_hooks()
    orig = {k: getattr(mod, name) for k, (mod, name, _, _) in hooks.items()}
    rec = {k: [] for k in hooks}
    choice_of = {"pick": lambda out, y: out, "starts": lambda out, att, n: out,
                 "max": lambda out, t, d: t.detach() == out.detach().unsqueeze(d),
                 "group": lambda out, *args: out[1], "sign": lambda out, t, *slope: t.detach() > 0,
                 "mean": lambda out, t, layers, slope: gch._chain(t.detach(), layers, slope)[0] > 0}

    def recording(kind):
        def run(*args):
            out = orig[kind](*args)
            rec[kind].append(choice_of[kind](out, *args))
            return out
        return run

    def logits_and_grad():
        a = x.clone().requires_grad_(True)
        logits = fn(a)
        return logits.detach(), torch.autograd.grad(logits[0, 0] - logits[0, 1], a)[0]

    for k, (mod, name, _, _) in hooks.items():
        setattr(mod, name, recording(k))
    try:
        want, g_want = logits_and_grad()
    finally:
        for k, (mod, name, _, _) in hooks.items():
            setattr(mod, name, orig[k])
    # 2 head ReLUs, the initial LPFA's output, and in each of the 8 CICs conv1, the LPFA's rows and the
    # output, plus the curve aggregation in the 4 that walk
    assert {k: len(v) for k, v in rec.items()} == {"pick": 20, "starts": 4, "max": 3, "group": 1, "sign": 31,
                                                   "mean": 8}

    def replayed(queues):
        with chip_smoke.replay(hooks, lambda kind: queues[kind].pop(0)) as stats:
            got, g = logits_and_grad()
        assert not any(queues.values())
        return got, g, stats

    got, g_got, stats = replayed({k: list(v) for k, v in rec.items()})
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert float((g_got - g_want).norm() / g_want.norm()) <= 1e-6
    assert all(st["off"] == 0 for st in stats.values()) and stats["pick"]["choices"] == 20 * 100
    assert stats["max"]["exact"] > 0 and stats["max"]["near"] >= stats["max"]["exact"]
    assert stats["sign"]["calls"] == 31 and stats["mean"]["calls"] == 8
    assert "within 1e-05 of a tie" in chip_smoke.choice_line(stats)
    queues = {k: list(v) for k, v in rec.items()}
    queues["pick"][0] = (queues["pick"][0] + 1) % 8  # another neighbour at the first step of the first walk
    _, _, stats = replayed(queues)
    assert stats["pick"]["off"] > 0
    assert float((curves[-1] - curves[0]).abs().max()) > 1e-2  # the first walk went elsewhere
    queues = {k: list(v) for k, v in rec.items()}
    first = queues["mean"][0].clone()  # the first residual LPFA's activation signs
    near = first.flatten().clone()
    near[:40] = ~near[:40]
    queues["mean"][0] = near.view_as(first)
    _, g_flip, stats = replayed(queues)
    assert int(stats["mean"]["other"][0][0]) == 40 and stats["mean"]["off"] > 0
    assert float((g_flip - g_want).norm() / g_want.norm()) > 1e-6


def test_kappa_idx_bound_charges_the_given_set():
    """The given-set forward reads the indices, the points and the normals
    and writes kappa: bytes bound it at GeoA3's shape (about 0.0002 ms)."""
    b, n, k = 8, 1024, 16
    t, by = chip_smoke.kappa_idx_bound(b, n, k)
    nbytes = 4.0 * (b * n * k + 6 * b * n + b * n)
    assert by == "bytes" and np.isclose(t, nbytes / chip_smoke.PEAK_BYTES * 1e3) and 1.5e-4 < t < 3e-4
    assert 19.0 * b * n * k / chip_smoke.PEAK_FLOPS * 1e3 < t


def test_geoa3_hooks_replay_the_cached_sets_and_the_jitter():
    """GeoA3 at curv_knn_refresh 2 with jitter, on the CPU, replaying its
    own cached neighbour sets and jitter (``knn_hooks`` on the curvature's
    module, ``jitter_hooks``) gives the same result; another jitter moves
    it, and sets other than its own are counted."""
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks import geoa3 as geo_mod
    from pointcloudattack_tpu_torch.losses import geometry as geo_losses
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    fn = make_model_fn(models.make_model("PointNet", 10, generator=torch.Generator().manual_seed(0)), None, "cpu")
    x = torch.from_numpy((np.random.RandomState(4).randn(2, 64, 3) * 0.5).astype(np.float32))
    cfg = geo_mod.GeoA3Config(binary_max_steps=2, iter_max_steps=3, curv_knn_refresh=2, use_jitter=True,
                              jitter_refresh_iters=2)
    offsets = torch.from_numpy((np.random.RandomState(5).randn(2, 2, 64, 3) * 1e-3).astype(np.float32))
    hooks = {**chip_smoke.knn_hooks(geo_losses), **chip_smoke.jitter_hooks()}
    rec = {k: [] for k in hooks}
    orig = {k: getattr(mod, name) for k, (mod, name, _, _) in hooks.items()}

    def recording(kind):
        def run(*args, **kw):
            out = orig[kind](*args, **kw)
            rec[kind].append(out)
            return out
        return run

    def attack(gen=None):
        return geo_mod.build_geoa3_attack(fn, cfg)(x, torch.zeros(2, dtype=torch.long), generator=gen,
                                                   init_offsets=offsets)

    for k, (mod, name, _, _) in hooks.items():
        setattr(mod, name, recording(k))
    try:
        want = attack(torch.Generator().manual_seed(1))
    finally:
        for k, (mod, name, _, _) in hooks.items():
            setattr(mod, name, orig[k])
    assert [len(rec["knn"]), len(rec["jitter"])] == [2 * 2, 2 * 2]  # iterations 0 and 2 of each round

    def replayed(queues):
        with chip_smoke.replay(hooks, lambda kind: queues[kind].pop(0)) as stats:
            got = attack(torch.Generator().manual_seed(2))  # other draws: the jitter must come from the queue
        assert not any(queues.values())
        return got, stats

    got, stats = replayed({k: list(v) for k, v in rec.items()})
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert stats["knn"]["off"] == 0 and stats["knn"]["calls"] == 4 and stats["jitter"]["calls"] == 4
    queues = {k: list(v) for k, v in rec.items()}
    queues["jitter"][0] = queues["jitter"][0] * 2.0
    queues["knn"][1] = queues["knn"][1].flip(-1)  # the same sets in another order: not off
    queues["knn"][2] = queues["knn"][2].roll(1, dims=1)  # other points' sets
    got, stats = replayed(queues)
    assert not torch.equal(got[0], want[0]) and stats["knn"]["off"] == 1
    assert sum(int(n.sum()) for n in stats["knn"]["other"]) > 0
