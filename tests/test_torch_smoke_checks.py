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
import pytest
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


def test_row_min_bound_and_its_issued_floor():
    """Row 6 at the KNN attack's [64, 1024, 3]^2: 8 operations a pair over
    the data sheet's 67 TFLOP/s, 0.0080 ms; at one operation an issued FP32
    instruction (its ``__fsub_rn`` / ``__fmul_rn`` / ``__fadd_rn`` do not
    fuse), 33.5 TOP/s, 0.0160 ms."""
    t, by = chip_smoke.chamfer_bound(64, 1024, 1024)
    assert by == "operations" and round(t, 4) == 0.0080
    floor, by = chip_smoke.chamfer_bound(64, 1024, 1024, issued=True)
    assert by == "operations" and round(floor, 4) == 0.0160 and np.isclose(floor, 2 * t)


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


def _ball_inputs(seed=0, b=2, n=96, g=24, cp=5, widths=(16, 24)):
    """A small set abstraction on the CPU: src (xyz and features), ball
    centers among the points, the SSG layout, seeded layers and cotangent."""
    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    src = torch.cat([xyz, torch.from_numpy(rng.randn(b, n, cp).astype(np.float32))], -1)
    ctr = xyz[:, :g].contiguous()
    layout = (("diff", 0, 3, 0), ("pass", 3, 3 + cp))
    layers = chip_smoke.seeded_layers(rng, (3 + cp, *widths), "cpu")
    dy = torch.from_numpy(rng.randn(b, g, widths[-1]).astype(np.float32))
    return src, ctr, layers, layout, dy


def test_check_ball_holds_the_slots_and_the_rows(monkeypatch):
    """``check_ball`` passes the plain ball route, and raises where the
    slots leave ``query_ball_point``'s by one index, where y leaves the plain
    version's by more than Y_TOL, where a clear winner's pick moves, or where
    a kernel of the route (its stack backward's d1, its pull's dP, its
    winners) leaves its plain version."""
    from pointcloudattack_tpu_torch.ops import ball_hoist as bh

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    src, ctr, layers, layout, dy = _ball_inputs()
    errs, _, _, win, idx = chip_smoke.check_ball("plain", src, ctr, layers, layout, 0.3, 16, dy)
    assert errs["y"] == 0.0 and win > 0 and idx.shape == (2, 24, 16)
    assert all(errs[key] == 0.0 for key in chip_smoke.BALL_KEYS)
    plain = gc.ball_gather_chain_fwd

    def other_slot(*args):
        y, am, slots = plain(*args)
        slots = slots.clone()
        slots[0, 0, -1] = (slots[0, 0, -1] + 1) % src.shape[1]
        return y, am, slots

    def other_y(*args):
        y, am, slots = plain(*args)
        return y + 2 * chip_smoke.Y_TOL["atol"], am, slots

    def other_pick(*args):
        y, am, slots = plain(*args)
        am = am.clone()
        am[0, 0, 0] = (am[0, 0, 0] + 1) % args[6]
        return y, am, slots

    for fault, msg in ((other_slot, "slots differ"), (other_y, "not close"), (other_pick, "clear winner")):
        monkeypatch.setattr(gc, "ball_gather_chain_fwd", fault)
        with pytest.raises(AssertionError, match=msg):
            chip_smoke.check_ball("faulty", src, ctr, layers, layout, 0.3, 16, dy)
    monkeypatch.setattr(gc, "ball_gather_chain_fwd", plain)
    # each fault in a kernel's wrapper only (on the CPU the wrapper runs the plain version the check holds it to)
    stack_bwd, pull, winners = bh.stack_bwd, bh.pull, bh.winners
    faults = {
        "stack_bwd": (lambda *a, **k: stack_bwd(*a, **k) * 1.001, "not close"),
        "pull": (lambda *a, **k: (lambda d: (d[0] * (1 + 2 ** -20), d[1]))(pull(*a, **k)), "dP"),
        "winners": (lambda am, k: (lambda w: bh.Winners(w.mask, w.off, w.wrow.flip(0)))(winners(am, k)),
                    "winners|not close"),
    }
    for name, (fault, msg) in faults.items():
        with monkeypatch.context() as m:
            m.setattr(bh, name, fault)
            with pytest.raises(AssertionError, match=msg):
                chip_smoke.check_ball("faulty", src, ctr, layers, layout, 0.3, 16, dy)


def test_check_gather_mean_catches_a_faulty_kernel(monkeypatch):
    """``check_gather_mean`` passes the plain mean, and raises where the
    forward is off by 1e-3 or a backward output is 0.1% off."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rng = np.random.RandomState(1)
    src, ctr = (torch.from_numpy(rng.randn(2, 40, 8).astype(np.float32)) for _ in range(2))
    idx = torch.from_numpy(rng.randint(0, 40, size=(2, 40, 6)).astype(np.int32))
    layers = chip_smoke.seeded_layers(rng, (8, 12), "cpu")
    dy = torch.from_numpy(rng.randn(2, 40, 12).astype(np.float32))
    layout = (("diff", 0, 8, 0),)
    errs, g = chip_smoke.check_gather_mean("plain", src, ctr, idx, layers, layout, dy)
    assert errs == {"y": 0.0, "dsrc": 0.0, "dctr": 0.0} and g.shape == (2, 40, 12)
    fwd, bwd = gc.gather_chain_mean_fwd, gc.gather_chain_mean_bwd
    faults = {
        "fwd": lambda *a, **k: fwd(*a, **k) + 1e-3,
        "dsrc": lambda *a, **k: (lambda d: (d[0] * 1.001, d[1]))(bwd(*a, **k)),
        "dctr": lambda *a, **k: (lambda d: (d[0], d[1] * 1.001))(bwd(*a, **k)),
    }
    for name, fault in faults.items():
        with monkeypatch.context() as m:
            m.setattr(gc, "gather_chain_mean_fwd" if name == "fwd" else "gather_chain_mean_bwd", fault)
            with pytest.raises(AssertionError):
                chip_smoke.check_gather_mean(name, src, ctr, idx, layers, layout, dy)


def test_ball_scan_pairs_count_to_the_kth_member():
    """A ball with K or more members is scanned up to its K-th member; one
    with fewer, over every point."""
    xyz = torch.tensor([[[0.0, 0, 0], [5, 0, 0], [0.1, 0, 0], [0.2, 0, 0], [9, 9, 9]]])
    ctr = torch.tensor([[[0.0, 0, 0], [5.0, 0, 0]]])
    # ball 0 holds points 0, 2, 3: its 2nd member is point 2, so 3 pairs; ball 1 holds 1 point: all 5
    assert chip_smoke.ball_scan_pairs(xyz, ctr, 0.25, 2) == 3 + 5
    assert chip_smoke.ball_scan_pairs(xyz, ctr, 0.25, 3) == 4 + 5


def test_gather_mean_bound_charges_every_row():
    """With the rows' activation there is no factoring: the chain on every
    row forward, twice backward; the inputs read and the outputs written
    once."""
    b, n, c, k = 8, 1024, 32, 20
    src, ctr = torch.zeros(b, n, c), torch.zeros(b, n, c)
    idx = torch.zeros(b, n, k, dtype=torch.int32)
    fwd, bwd = chip_smoke.gather_mean_bounds(src, ctr, idx, (("diff", 0, c, 0),), (c, c))
    rows = b * n * k
    nbytes = 4.0 * (3 * b * n * c + b * n * k) + chip_smoke.param_bytes((c, c))
    assert fwd == chip_smoke.bound(2.0 * rows * c * c, nbytes)
    assert bwd[0] > fwd[0] and bwd == chip_smoke.bound(
        4.0 * rows * c * c, 4.0 * (5 * b * n * c + b * n * k) + 2 * chip_smoke.param_bytes((c, c)))


def test_gather_route_hooks_replay_the_signs():
    """CurveNet on the gather route on the CPU, replaying its own recorded
    choices and signs (``curvenet_hooks(gather=True)`` with ``pick_hooks``):
    the same logits and gradient, each taken choice 0 from its own; the
    first gather mean's layer-output signs flipped at 16 units of one row
    move the gradient and are counted (its rows' signs come first, 16 a
    row, then the layer's)."""
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.ops.chain_maxpool import act
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    model = models.make_model("CurveNet", 10, generator=torch.Generator().manual_seed(0), k=8, fused_gather=True)
    fn = make_model_fn(model, None, "cpu")
    x = torch.from_numpy((np.random.RandomState(3).randn(1, 1024, 3) * 0.5).astype(np.float32))
    hooks = {**chip_smoke.pick_hooks(), **chip_smoke.curvenet_hooks(gather=True)}
    hooks = {k: v for k, v in hooks.items() if k not in ("chain", "gather_dgcnn", "ball")}
    orig = {k: getattr(mod, name) for k, (mod, name, _, _) in hooks.items()}
    rec = {k: [] for k in hooks}

    def gmean_signs(out, src, centers, idx, layers, layout, slope=0.0, pre_act=False):
        rows = gc.gather_rows(src.detach(), centers.detach(), idx, layout)
        z = gc._chain(act(rows, slope) if pre_act else rows, [tuple(t.detach() for t in l) for l in layers],
                      slope)[0]
        return torch.cat([rows > 0, z > 0], -1)

    def gather_picks(out, src, centers, idx, layers, layout, slope=0.0):
        return (gc.gather_chain_plain(src.detach(), centers.detach(), idx, layers, layout, slope)[1],)

    choice_of = {"pick": lambda out, y: out, "starts": lambda out, att, n: out,
                 "max": lambda out, t, d: t.detach() == out.detach().unsqueeze(d),
                 "gather_curvenet": gather_picks, "sign": lambda out, t, *slope: t.detach() > 0,
                 "gmean": gmean_signs}

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

    for k in choice_of:
        mod, name, _, _ = hooks[k]
        setattr(mod, name, recording(k))
    try:
        want, g_want = logits_and_grad()
    finally:
        for k, (mod, name, _, _) in hooks.items():
            setattr(mod, name, orig[k])
    assert {k: len(rec[k]) for k in choice_of} == {"pick": 20, "starts": 4, "max": 3, "gather_curvenet": 1,
                                                   "sign": 23, "gmean": 8}

    def replayed(queues):
        with chip_smoke.replay(hooks, lambda kind: queues[kind].pop(0)) as stats:
            got, g = logits_and_grad()
        assert not any(queues.values())
        return got, g, stats

    got, g_got, stats = replayed({k: list(v) for k, v in rec.items()})
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert float((g_got - g_want).norm() / g_want.norm()) <= 1e-6
    assert all(st["off"] == 0 for st in stats.values()) and stats["gmean"]["calls"] == 8
    queues = {k: list(v) for k, v in rec.items()}
    flipped = queues["gmean"][0].clone()
    assert flipped.shape[-1] == 32
    flipped[0, 0, 0, 16:] = ~flipped[0, 0, 0, 16:]
    queues["gmean"][0] = flipped
    _, g_flip, stats = replayed(queues)
    assert int(stats["gmean"]["other"][0][0]) == 16 and stats["gmean"]["off"] > 0
    assert float((g_flip - g_want).norm() / g_want.norm()) > 1e-6


def test_ball_hook_takes_the_picks_and_holds_the_slots():
    """``pick_hooks``' ball hook on the CPU: the card's picks on the CPU's
    own slots, 0 off where the card's slots are the CPU's, 1 or more for a
    cloud where one slot differs."""
    src, ctr, layers, layout, _ = _ball_inputs(2)
    _, _, _, on_cpu = chip_smoke.pick_hooks()["ball"]
    args = (src, ctr, src[..., :3].contiguous(), layers, layout, 0.3, 16)
    y, am, idx = gc.ball_gather_chain_plain(*args)
    y2, gap, off = on_cpu(gc.ball_gather_chain_groupmax, (idx, am), *args)
    assert torch.equal(y2, y) and float(off.max()) == 0.0 and gap.shape == off.shape and gap.shape[0] == 2
    slots = idx.clone()
    slots[1, 3, 0] += 1
    _, _, off = on_cpu(gc.ball_gather_chain_groupmax, (slots, am), *args)
    assert float(off[1].min()) >= 1.0 and float(off[0].max()) == 0.0


def test_gather_hook_takes_the_hidden_sides():
    """``pick_hooks``' gather hook (DGCNN's) on the CPU with the hidden
    layer's sides given beside the picks: its own sides give 0 off and the
    same output; one unit of one row on the other side is counted and moves
    the rows' gradient."""
    src, ctr, layers, layout, _ = _ball_inputs(3)
    idx = gc.ball_gather_chain_plain(src, ctr, src[..., :3].contiguous(), layers, layout, 0.3, 16)[2]
    _, _, _, on_cpu = chip_smoke.pick_hooks()["gather_dgcnn"]
    y, am = gc.gather_chain_plain(src, ctr, idx, layers, layout)
    w, b, mean, mul, beta = layers[0]
    pos = ((gc.gather_rows(src, ctr, idx, layout) @ w + b - mean) * mul + beta) > 0
    s = src.clone().requires_grad_(True)
    y2, gap, off = on_cpu(gc.gather_chain_groupmax, (am, pos), s, ctr, idx, layers, layout)
    assert torch.equal(y2.detach(), y) and float(off.max()) == 0.0
    (g_own,) = torch.autograd.grad(y2.sum(), s)
    flipped = pos.clone()
    flipped[0, 0, 0, 0] = ~flipped[0, 0, 0, 0]
    s = src.clone().requires_grad_(True)
    y3, _, off = on_cpu(gc.gather_chain_groupmax, (am, flipped), s, ctr, idx, layers, layout)
    (g_flip,) = torch.autograd.grad(y3.sum(), s)
    hidden = pos[0].numel()  # the hidden sides follow the picks in each cloud's row of ``off``
    assert int((off[0, -hidden:] > 0).sum()) == 1 and float(off[1].max()) == 0.0
    assert not torch.equal(g_flip, g_own)


def test_relu_hooks_replay_the_pooled_and_head_signs():
    """PointNet++ SSG on the CPU replaying its own recorded ReLU signs
    (``relu_hooks``: after each fused max pool and in the head) gives the
    same log-probs and gradient, each taken sign 0 from its own; one head
    unit's sign flipped moves the gradient and is counted."""
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    fn = make_model_fn(models.make_model("PointNet++Ssg", 10, generator=torch.Generator().manual_seed(0)), None,
                       "cpu")
    x = torch.from_numpy((np.random.RandomState(6).randn(1, 1024, 3) * 0.5).astype(np.float32))
    hooks = chip_smoke.relu_hooks()
    orig = {k: getattr(mod, name) for k, (mod, name, _, _) in hooks.items()}
    rec = {k: [] for k in hooks}

    def recording(kind):
        def run(t):
            rec[kind].append(t.detach() > 0)
            return orig[kind](t)
        return run

    def logp_and_grad():
        a = x.clone().requires_grad_(True)
        logp = fn(a)
        return logp.detach(), torch.autograd.grad(logp[0, 0] - logp[0, 1], a)[0]

    for k, (mod, name, _, _) in hooks.items():
        setattr(mod, name, recording(k))
    try:
        want, g_want = logp_and_grad()
    finally:
        for k, (mod, name, _, _) in hooks.items():
            setattr(mod, name, orig[k])
    # the two neighbourhood set abstractions' pools, the group-all one's, and the head's two layers
    assert {k: len(v) for k, v in rec.items()} == {"relu": 3, "pointnet_relu": 0, "head_relu": 2}

    def replayed(queues):
        with chip_smoke.replay(hooks, lambda kind: queues[kind].pop(0)) as stats:
            got, g = logp_and_grad()
        assert not any(queues.values())
        return got, g, stats

    got, g_got, stats = replayed({k: list(v) for k, v in rec.items()})
    assert torch.equal(got, want) and torch.equal(g_got, g_want)
    assert all(st["off"] == 0 for st in stats.values())
    queues = {k: list(v) for k, v in rec.items()}
    first = queues["head_relu"][0].clone()
    unit = int(first[0].nonzero()[0])  # an open unit of the head's first layer
    first[0, unit] = False
    queues["head_relu"][0] = first
    _, g_flip, stats = replayed(queues)
    assert int(stats["head_relu"]["other"][0][0]) == 1 and stats["head_relu"]["off"] > 0
    assert not torch.equal(g_flip, g_want)


def test_relu_hooks_replay_pointnets_last_head_sign():
    """PointNet's last head ReLU, which ``models/pointnet.py`` calls by its
    own name for ``common.relu``, is a choice of its own ("pointnet_relu"):
    replaying the recorded signs gives the same gradient, and one open unit
    flipped moves it and is counted."""
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    fn = make_model_fn(models.make_model("PointNet", 10, generator=torch.Generator().manual_seed(0)), None, "cpu")
    x = torch.from_numpy((np.random.RandomState(7).randn(2, 256, 3) * 0.5).astype(np.float32))
    hooks = chip_smoke.relu_hooks()
    orig = {k: getattr(mod, name) for k, (mod, name, _, _) in hooks.items()}
    rec = {k: [] for k in hooks}

    def recording(kind):
        def run(t):
            rec[kind].append(t.detach() > 0)
            return orig[kind](t)
        return run

    def grad():
        a = x.clone().requires_grad_(True)
        logp = fn(a)
        return torch.autograd.grad((logp[:, 0] - logp[:, 1]).sum(), a)[0]

    for k, (mod, name, _, _) in hooks.items():
        setattr(mod, name, recording(k))
    try:
        g_want = grad()
    finally:
        for k, (mod, name, _, _) in hooks.items():
            setattr(mod, name, orig[k])
    # the transformer's pool and its two layers and the head's first layer; then the head's last
    assert {k: len(v) for k, v in rec.items()} == {"relu": 4, "pointnet_relu": 1, "head_relu": 0}
    queues = {k: list(v) for k, v in rec.items()}
    with chip_smoke.replay(hooks, lambda kind: queues[kind].pop(0)) as stats:
        g_got = grad()
    assert torch.equal(g_got, g_want) and stats["pointnet_relu"]["calls"] == 1
    queues = {k: list(v) for k, v in rec.items()}
    last = queues["pointnet_relu"][0].clone()
    last[0, int(last[0].nonzero()[0])] = False  # an open unit of cloud 0
    queues["pointnet_relu"][0] = last
    with chip_smoke.replay(hooks, lambda kind: queues[kind].pop(0)) as stats:
        g_flip = grad()
    assert int(stats["pointnet_relu"]["other"][0][0]) == 1 and stats["pointnet_relu"]["off"] > 0
    assert not torch.equal(g_flip[0], g_want[0]) and torch.equal(g_flip[1], g_want[1])


@pytest.mark.parametrize("fp32,total", [(False, 0.0667), (True, 0.0786)])
def test_mean_backward_bounds_of_the_eight_lpfas(fp32, total):
    """The one-layer mean backward's bounds at CurveNet's eight residual
    LPFAs: bytes at the 16 and 32 widths (x read and dx written once),
    operations at 64 and 128: the recompute over the FP32 peak and the
    product back as three TF32 products over the tensor cores' (0.0667 ms
    summed), or over the FP32 peak too with ``fp32`` (0.0786 ms)."""
    got = {name: chip_smoke.group_bound(chip_smoke.CN_B, ng, chip_smoke.CN_K, (c0, *w), "mean",
                                        chip_smoke.CN_B * ng * chip_smoke.CN_K, fp32=fp32)
           for name, (ng, c0, w, pool) in chip_smoke.CURVENET_GROUP_SHAPES.items() if pool == "mean"}
    assert [by for _, by in got.values()] == ["bytes"] * 4 + ["operations"] * 4
    rows = chip_smoke.CN_B * 1024 * chip_smoke.CN_K
    assert got["cic21"][0] >= 2 * 4.0 * rows * 32 / chip_smoke.PEAK_BYTES * 1e3
    flops = 2.0 * 8 * 64 * 20 * 128 * 128  # one product at the 128 width
    back = flops / chip_smoke.PEAK_FLOPS if fp32 else 3 * flops / chip_smoke.PEAK_TF32
    assert np.isclose(got["cic41"][0], (flops / chip_smoke.PEAK_FLOPS + back) * 1e3)
    assert np.isclose(sum(t for t, _ in got.values()), total, atol=5e-5)


def _mean_case(seed=3, b=2, g=5, k=7, c=6):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, g, k, c).astype(np.float32))
    layers = chip_smoke.seeded_layers(rng, (c, c), "cpu")
    return x, layers


def test_mask_flips_read_the_backward_masks():
    """On the CPU the plain forward and backward share their
    pre-activations: no mask differs.  A backward whose masks come from
    other pre-activations (every BatchNorm shift moved by 0.3) is caught,
    unit by unit."""
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    x, layers = _mean_case()
    assert chip_smoke.mask_flips(x, layers, 0.2) == 0
    assert chip_smoke.mask_flips(x, layers, 0.0) == 0
    (w, b, mean, mul, beta), = layers
    z, _ = gch._chain(x, layers, 0.2)
    z2, _ = gch._chain(x, [(w, b, mean, mul, beta + 0.3)], 0.2)
    want = int(((z > 0) != (z2 > 0)).sum())
    assert want > 0
    orig = gch.chain_groupmean_bwd

    def faulty(x, layers, g, slope=0.0, wts=None):
        (w, b, mean, mul, beta), = layers
        return orig(x, [(w, b, mean, mul, beta + 0.3)], g, slope)

    gch.chain_groupmean_bwd = faulty
    try:
        assert chip_smoke.mask_flips(x, layers, 0.2) == want
    finally:
        gch.chain_groupmean_bwd = orig
    with pytest.raises(ValueError, match="one-layer"):
        chip_smoke.mask_flips(x[..., :6], chip_smoke.seeded_layers(np.random.RandomState(0), (6, 4, 6), "cpu"))


def test_check_kappa_holds_the_forward_bit_equal(monkeypatch):
    """check_kappa holds kappa to the plain version's bits: one ulp off in
    one row fails it, where the earlier relative tolerance let it pass."""
    from pointcloudattack_tpu_torch.ops import kappa

    rng = np.random.RandomState(4)
    a = torch.from_numpy((rng.randn(2, 64, 3) * 0.5).astype(np.float32))
    nrm = torch.from_numpy(rng.randn(2, 64, 3).astype(np.float32))
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    dk = torch.from_numpy(rng.randn(2, 64).astype(np.float32))
    assert chip_smoke.check_kappa("test", "plain", a, nrm, dk, 5) == 0.0
    orig = kappa.kappa_fwd

    def off(adv, normal, k):
        kap, picks = orig(adv, normal, k)
        kap = kap.clone()
        kap[0, 3] = torch.nextafter(kap[0, 3], torch.tensor(2.0))
        return kap, picks

    monkeypatch.setattr(kappa, "kappa_fwd", off)
    with pytest.raises(AssertionError, match="kappa"):
        chip_smoke.check_kappa("test", "one ulp off", a, nrm, dk, 5)


def test_fps_bound_counts_ten_operations_a_point_a_step():
    t, by = chip_smoke.fps_bound(16, 1024, 512)
    assert by == "operations"
    assert t == pytest.approx(10.0 * 16 * 511 * 1024 / chip_smoke.PEAK_FLOPS * 1e3)


@pytest.mark.parametrize("name", list(chip_smoke.FPS_EDGE_CASES))
def test_fps_edge_cases_make_the_named_clouds(name):
    b, n, npoint, kind = chip_smoke.FPS_EDGE_CASES[name]
    xyz, start = chip_smoke.fps_case(7, b, n, kind, device="cpu")
    assert tuple(xyz.shape) == (b, n, 3) and xyz.dtype == torch.float32 and 1 <= npoint <= n
    assert (start is not None) == (kind == "start")
    if kind == "repeated":
        assert bool((xyz == xyz[:, :1]).all())
    if start is not None:
        assert start.dtype == torch.int32 and tuple(start.shape) == (b,) and int(start.max()) < n


@pytest.mark.parametrize("name", list(chip_smoke.BOTH_EDGE_CASES))
def test_both_edge_cases_make_the_named_clouds(name):
    from pointcloudattack_tpu_torch.ops import chamfer

    b, n, m, kind = chip_smoke.BOTH_EDGE_CASES[name]
    x, y = chip_smoke.both_case(7, b, min(n, 256), min(m, 512), kind, device="cpu")
    _, _, _, carg = chamfer.both_plain(x, y)
    if kind == "hub":
        assert bool((carg == 0).all())  # every y point's nearest is x's point 0


def _knn_victim():
    clouds, labels = chip_smoke.synthetic_data(4, 1, 4, "cpu")
    clouds = clouds[:, :128].contiguous()
    fn, _ = chip_smoke.make_victim("PointNet", "cpu", clouds, ("dropout",))
    return fn, clouds, chip_smoke.victim_labels(fn, clouds, labels, "slice-knn")


def test_first_step_reading_names_the_op_that_parts(monkeypatch):
    """knn_first_steps (traced_first_steps on the KNN loss) finds two
    bit-equal runs bit-equal; with a row min whose second call moves row
    0's argmin (as a kernel whose ties went another way would), it counts
    the coordinates that differ and names the row min as the first traced
    op to part, the chain's forward before it being bit-equal."""
    from pointcloudattack_tpu_torch.ops import chamfer

    fn, clouds, target = _knn_victim()
    assert chip_smoke.knn_first_steps("test", fn, clouds, target) == (0, None)
    orig, calls = chamfer.min_rows_fwd, []

    def flaky(x, y):
        mins, arg = orig(x, y)
        calls.append(1)
        if len(calls) % 2 == 0:
            arg = arg.clone()
            arg[0, 0] = (arg[0, 0] + 1) % y.shape[1]
        return mins, arg

    monkeypatch.setattr(chamfer, "min_rows_fwd", flaky)
    differ, parted = chip_smoke.knn_first_steps("test", fn, clouds, target)
    assert parted == "chamfer.min_rows_fwd" and 0 < differ <= 3


def test_geoa3_first_step_reading_traces_the_curvature_and_bundle(monkeypatch):
    """geoa3_first_steps traces the chain, the bundle and the curvature's
    wrappers; a curvature backward whose second call gives other bits is
    named as the first traced op to part."""
    from pointcloudattack_tpu_torch.ops import kappa

    fn, clouds, target = _knn_victim()
    assert chip_smoke.geoa3_first_steps("test", fn, clouds, target) == (0, None)
    orig, calls = kappa.kappa_bwd, []

    def flaky(*args, **kw):
        dadv, dnrm = orig(*args, **kw)
        calls.append(1)
        if len(calls) % 2 == 0:
            dadv = dadv.clone()
            dadv[0, 0, 0] += 1.0
        return dadv, dnrm

    monkeypatch.setattr(kappa, "kappa_bwd", flaky)
    differ, parted = chip_smoke.geoa3_first_steps("test", fn, clouds, target)
    assert parted == "kappa.kappa_bwd" and differ >= 1


@pytest.mark.parametrize("name", list(chip_smoke.ROWMIN_EDGE_CASES))
def test_rowmin_edge_cases_make_the_named_clouds(name):
    from pointcloudattack_tpu_torch.ops import chamfer

    b, n, m, kind = chip_smoke.ROWMIN_EDGE_CASES[name]
    x, y = chip_smoke.rowmin_case(7, b, min(n, 256), min(m, 512), kind, device="cpu")
    mins, arg = chamfer.min_rows_plain(x, y)
    assert tuple(x.shape) == (b, min(n, 256), 3) and tuple(y.shape) == (b, min(m, 512), 3)
    if kind == "equal":
        assert bool((mins == 0).all()) and not arg.any()
    if kind == "overflow":  # the odd rows' distances all +inf, argmin 0; the others finite past y's first quarter
        assert bool(torch.isinf(mins[:, 1::2]).all()) and not arg[:, 1::2].any()
        assert bool(torch.isfinite(mins[:, ::2]).all()) and bool((arg[:, ::2] >= y.shape[1] // 4).all())


def test_check_chamfer_without_a_gradient_catches_a_moved_argmin(monkeypatch):
    """check_chamfer(grad=False) holds mins and argmin bit for bit: an
    argmin moved in one row fails it."""
    from pointcloudattack_tpu_torch.ops import chamfer

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    x, y = chip_smoke.rowmin_case(3, 2, 64, 96, "overflow", device="cpu")
    w = torch.ones(2, 64)
    assert chip_smoke.check_chamfer("test", "plain", x, y, w, grad=False) == 0.0
    orig = chamfer.min_rows_fwd

    def moved(a, b):
        mins, arg = orig(a, b)
        arg = arg.clone()
        arg[1, 2] += 1
        return mins, arg

    monkeypatch.setattr(chamfer, "min_rows_fwd", moved)
    with pytest.raises(AssertionError, match="argmin"):
        chip_smoke.check_chamfer("test", "moved", x, y, w, grad=False)


def test_given_idx_repeats_slots_and_leaves_the_cloud():
    """given_idx's set: slot 1 repeats slot 0, every 11th row names itself,
    every 5th and 7th row hold an index outside the cloud; check_kappa_idx_fwd
    holds kappa on it bit for bit (the plain version, given the row's own
    index in place of each index outside, against itself here)."""
    from pointcloudattack_tpu_torch.ops import kappa

    b, n, k = 2, 200, 16
    idx = chip_smoke.given_idx(3, b, n, k, device="cpu")
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (b, n, k)
    rest = torch.arange(n) % 11 != 0  # every 11th row's slot 0 was then set to the row itself
    assert bool((idx[:, rest, 1] == idx[:, rest, 0]).all())
    assert bool((idx[:, ::11, 0] == torch.arange(0, n, 11, dtype=torch.int32)).all())
    assert bool((idx[:, ::5, k - 1] == -1).all()) and bool((idx[:, ::7, k // 2] == n + 3).all())
    a = torch.from_numpy((np.random.RandomState(1).randn(b, n, 3) * 0.5).astype(np.float32))
    nrm = torch.nn.functional.normalize(torch.from_numpy(np.random.RandomState(2).randn(b, n, 3).astype(np.float32)),
                                        dim=-1)
    own = torch.arange(n, dtype=torch.int32)[None, :, None].expand_as(idx)
    inside = torch.where((idx >= 0) & (idx < n), idx, own).contiguous()
    assert chip_smoke.check_kappa_idx_fwd("test", "in the cloud", a, nrm, inside, k) == 0.0
    assert bool(torch.isfinite(kappa.kappa_idx_plain(a, nrm, inside, k)).all())


def test_traces_patch_while_open_and_restore():
    """dgcnn_trace and op_trace are context managers: while open they
    replace the traced functions, and on leaving they put them back."""
    from pointcloudattack_tpu_torch.models import dgcnn as dg
    from pointcloudattack_tpu_torch.ops import chamfer

    knn0, rows0 = dg.knn, chamfer.min_rows_fwd
    with chip_smoke.dgcnn_trace() as rec:
        assert rec == [] and dg.knn is not knn0
    with chip_smoke.op_trace(((chamfer, "min_rows_fwd"),)) as rec:
        assert rec == [] and chamfer.min_rows_fwd is not rows0
    assert dg.knn is knn0 and chamfer.min_rows_fwd is rows0


def test_op_trace_records_inputs_of_punet_group_chains_and_samplings():
    """``op_trace(..., inputs=True)`` records the positional arguments of
    PU-Net's four group chains and four FPS calls in run order, copied, so
    that a chain run again on its recorded rows and layers gives the rows
    the forward pooled; the traced functions are put back on leaving."""
    from pointcloudattack_tpu_torch.models import punet
    from pointcloudattack_tpu_torch.ops import grouping

    torch.manual_seed(0)
    model = punet.PUNet(npoint=64)
    pc = torch.from_numpy(np.random.RandomState(4).rand(2, 64, 3).astype(np.float32))
    chain0, fps0 = punet.mlp_chain_groupmax, grouping.farthest_point_sample
    outs = []

    def keep(x, layers, slope=0.0):
        outs.append(chain0(x, layers, slope))
        return outs[-1]

    punet.mlp_chain_groupmax = keep
    try:
        with chip_smoke.op_trace(((punet, "mlp_chain_groupmax"), (grouping, "farthest_point_sample")),
                                 inputs=True) as rec, torch.no_grad():
            model(pc)
    finally:
        punet.mlp_chain_groupmax = chain0
    assert grouping.farthest_point_sample is fps0
    groups = [args for name, args in rec if name == "punet.mlp_chain_groupmax"]
    samplings = [args for name, args in rec if name == "grouping.farthest_point_sample"]
    assert len(groups) == 4 and len(samplings) == 4
    assert [npoint for _, npoint in samplings] == [64, 32, 16, 8]
    assert [tuple(x.shape[:3]) for x, _ in groups] == [(2, 64, 32), (2, 32, 32), (2, 16, 32), (2, 8, 32)]
    for (x, layers), y in zip(groups, outs):
        assert x.is_contiguous() and len(layers) == 3
        assert torch.equal(chain0(x, layers, 0.0), y)


def test_defense_hooks_replay_the_mask_the_draw_and_the_signs():
    """DUP-Net (PU-Net at npoint 64) and SRS on the CPU, replaying their own
    recorded choices (``replay`` with ``dupnet_hooks``: SOR's mask and
    neighbours, SRS's draw, PU-Net's FPS picks, ball slots, group-chain picks
    and hidden signs, 3-NN picks and ReLU signs) give the same clouds and
    input gradient, each taken choice 0 from its own; a flipped SOR mask
    entry or flipped ReLU signs move the result and are counted; another SRS
    draw is taken as it is."""
    from pointcloudattack_tpu_torch.attacks.evaluation import with_defense
    from pointcloudattack_tpu_torch.models.punet import PUNet
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    model = PUNet(npoint=64)
    model.reset_parameters(torch.Generator().manual_seed(0))
    dup = with_defense(lambda x: x, "dupnet", npoint=64, dup_variables=model.state_dict())
    srs = with_defense(lambda x: x, "srs", key=3)
    x = torch.from_numpy((np.random.RandomState(4).randn(1, 80, 3) * 0.3).astype(np.float32))
    x[0, 5] = 3.0  # an outlier for SOR to drop
    w = torch.from_numpy(np.random.RandomState(5).randn(1, 256 + 40, 3).astype(np.float32))
    hooks = chip_smoke.dupnet_hooks()
    orig = {k: getattr(mod, name) for k, (mod, name, _, _) in hooks.items()}
    rec = {k: [] for k in hooks}

    def group_choice(out, t, layers, slope=0.0):
        z, zs = gch._chain(t.detach(), layers, slope)
        return (gch.chain_groupmax_plain(t.detach(), layers, slope)[1], *(zl > 0 for zl in zs))

    choice_of = {"sor": lambda out, *a: out, "sor_knn": lambda out, *a: out, "srs": lambda out, *a: out,
                 "fps": lambda out, *a: out, "slots": lambda out, *a: out, "punet_group": group_choice,
                 "nn3": lambda out, *a: out[1], "punet_relu": lambda out, t: t.detach() > 0}

    def recording(kind):
        def run(*args):
            out = orig[kind](*args)
            rec[kind].append(choice_of[kind](out, *args))
            return out
        return run

    def clouds_and_grad():
        a = x.clone().requires_grad_(True)
        out = torch.cat([dup(a), srs(a)], dim=1)
        return out.detach(), torch.autograd.grad((out * w).sum(), a)[0]

    for k, (mod, name, _, _) in hooks.items():
        setattr(mod, name, recording(k))
    try:
        want, g_want = clouds_and_grad()
    finally:
        for k, (mod, name, _, _) in hooks.items():
            setattr(mod, name, orig[k])
    # SOR once; four set abstractions (FPS, slots, chain); three propagations (3-NN); 16 ReLUs
    assert {k: len(v) for k, v in rec.items()} == {"sor": 1, "sor_knn": 1, "srs": 1, "fps": 4, "slots": 4,
                                                   "punet_group": 4, "nn3": 3, "punet_relu": 16}
    assert not bool(rec["sor"][0][0, 5])

    def replayed(queues):
        with chip_smoke.replay(hooks, lambda kind: queues[kind].pop(0)) as stats:
            got, g = clouds_and_grad()
        assert not any(queues.values())
        return got, g, stats

    got, g_got, stats = replayed({k: list(v) for k, v in rec.items()})
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert float((g_got - g_want).norm() / g_want.norm()) <= 1e-6
    assert all(st["off"] == 0 for st in stats.values()) and stats["punet_relu"]["calls"] == 16
    queues = {k: list(v) for k, v in rec.items()}
    keep = queues["sor"][0].clone()
    keep[0, 5] = True  # the outlier kept
    queues["sor"][0] = keep
    got, _, stats = replayed(queues)
    assert stats["sor"]["off"] > 0 and float((got - want).abs().max()) > 1e-3
    queues = {k: list(v) for k, v in rec.items()}
    queues["srs"][0] = torch.roll(queues["srs"][0], 1, dims=1)
    first = queues["punet_relu"][0].clone()
    flipped = first.flatten().clone()
    flipped[:40] = ~flipped[:40]
    queues["punet_relu"][0] = flipped.view_as(first)
    got, g_flip, stats = replayed(queues)
    assert stats["srs"]["off"] == 0 and not torch.equal(got[:, 256:], want[:, 256:])
    assert int(stats["punet_relu"]["other"][0][0]) == 40 and stats["punet_relu"]["off"] > 0
    assert float((g_flip - g_want).norm() / g_want.norm()) > 1e-6
