"""Time chip_smoke.py's attack cells, and rows 2, 3 and 6-10's kernels, in one checkout.

Run on a machine with one H100, once per checkout to compare, in turns
(for example parent, change, change, parent):

    python3 scripts/slice_turns.py /path/to/checkout [CELL ...] [--profile]

CELL is one of ``slice`` (C&W 1 x 200 on PointNet, B=64; the default),
``slice-ssg``, ``slice-msg`` (C&W on PointNet++ SSG and MSG, B=16),
``slice-knn`` (KNN 500 iterations on PointNet, B=64, nn_refresh 1),
``slice-knn-ssg`` (KNN on SSG), ``slice-dgcnn`` (C&W 1 x 100 on DGCNN,
B=16), ``slice-geoa3`` and ``slice-geoa3-r4`` (GeoA3 10 x 100 on PointNet,
B=8, the curvature's neighbour set cached for 4 iterations in the second),
``slice-curvenet`` (C&W 1 x 100 on CurveNet, B=8), ``slice-geoa3-curvenet``
(GeoA3 2 x 50 on CurveNet, B=8, on the log-softmax), ``kernels-knn`` (the
self-kNN at the four EdgeConv inputs of one DGCNN forward, the nine kNN
inputs of one CurveNet forward and GeoA3's cached curvature set),
``kernels-kappa`` (the curvature backward at GeoA3's shape, on the
selecting forward's picks and on a stale given set), ``kernels-kappa-fwd``
(the selecting curvature forward at GeoA3's shape), ``kernels-group-mean``
(the group mean backward at the eight residual LPFA shapes of one CurveNet
forward, B=8, K=20), ``kernels-group-fwd`` (the group forwards at the nine
LPFA shapes of one CurveNet forward: the initial LPFA's max, then the eight
residual means and their sum), ``kernels-group-max-bwd`` (the initial
LPFA's max backward), ``kernels-fps`` (farthest point sampling at SSG's two
shapes, B=16, and CurveNet's two, B=8), ``kernels-both`` (the
two-direction bundle's forward and backward at GeoA3's shape),
``kernels-rowmin`` (the Chamfer row min on the KNN attack's iterate,
[64,1024,3]^2 and [16,1024,3]^2), ``kernels-kappa-idx-fwd`` (the
curvature forward on a stale given set at GeoA3's shape, then beside a
one-element zero_() in one profiler window, the launch floor),
``kernels-group-punet`` (the group max forward and backward at PU-Net's
four set abstractions, on the rows of one DUP-Net forward over SI-query's
clouds, B=32, K=32, and their sums) and ``slice-cw-dupnet`` (C&W 1 x 20
on PointNet through DUP-Net, B=16, PU-Net's weights seeded).  It
builds that checkout's kernels, makes each victim and its clouds as
chip_smoke.py does (seeded random weights with the clouds' BatchNorm
statistics, N=1024), runs each attack four times, printing each run's
seconds and the CUDA caching allocator's counters over it (device
allocations and frees, syncs, retries), then the min of runs 1-3 (run 0 is
the warm-up).  A kernel cell prints, for each input, the wrapper's time by
CUDA events over back-to-back calls and each kernel's device time under
the profiler.  With ``--profile`` it then prints, for each victim it
timed, chip_smoke.py's profile line (10 iterations of the attack under
torch.profiler: kernel time and the device's idle share; GeoA3 also at
curv_knn_refresh 4 when ``slice-geoa3-r4`` ran).  It reads only
names that chip_smoke.py has kept since PR 10, so that checkout and later
ones run it; the kernel cells call only the ops' public entry points
(``ops.fps.farthest_point_sample``, ``ops.chamfer.both_fwd``,
``both_bwd`` and ``min_rows_fwd``, ``ops.kappa.kappa_idx_fwd``,
``ops.group_chain.chain_groupmax_fwd``, ``chain_groupmean_fwd`` and
``chain_groupmax_bwd``), which every checkout with those kernels has; the
DUP-Net cells read chip_smoke.py's defense helpers (``punet_state``,
``defended``, ``defended_victim``, ``op_trace``), which every checkout with
the defenses has.
"""

import sys
import time

CELLS = ("slice", "slice-ssg", "slice-msg", "slice-knn", "slice-knn-ssg", "slice-dgcnn", "slice-geoa3", "slice-geoa3-r4",
         "slice-curvenet", "slice-geoa3-curvenet", "kernels-knn", "kernels-kappa", "kernels-kappa-fwd", "kernels-group-mean",
         "kernels-group-fwd", "kernels-group-max-bwd", "kernels-fps", "kernels-both", "kernels-rowmin",
         "kernels-kappa-idx-fwd", "kernels-group-punet", "slice-cw-dupnet")
VICTIMS = {"slice": "PointNet", "slice-ssg": "PointNet++Ssg", "slice-msg": "PointNet++Msg", "slice-knn": "PointNet KNN",
           "slice-knn-ssg": "PointNet++Ssg", "slice-dgcnn": "DGCNN", "slice-geoa3": "PointNet GeoA3",
           "slice-geoa3-r4": "PointNet GeoA3", "slice-curvenet": "CurveNet", "slice-geoa3-curvenet": "CurveNet GeoA3",
           "slice-cw-dupnet": "PointNet DUP-Net"}
PROFILE_TAGS = {"PointNet": "profile", "PointNet KNN": "profile-knn", "PointNet++Ssg": "profile-ssg",
                "PointNet++Msg": "profile-msg",
                "DGCNN": "profile-dgcnn", "PointNet GeoA3": "profile-geoa3", "CurveNet": "profile-curvenet",
                "CurveNet GeoA3": "profile-geoa3-curvenet", "PointNet DUP-Net": "profile-cw-dupnet"}


def victim(cs, name):
    """(model_fn, data, target) of chip_smoke.py's cells on ``name``."""
    if name == "PointNet":
        clouds, labels = cs.synthetic_data(cs.NUM_CLASSES, 2, 0, "cuda")
        model_fn, _ = cs.make_victim(name, "cuda", clouds, ("dropout",))
        data = clouds[: cs.B]
        return model_fn, data, cs.victim_labels(model_fn, data, labels[: cs.B])
    if name == "PointNet KNN":
        clouds, labels = cs.synthetic_data(cs.NUM_CLASSES, 2, cs.KNN_DATA, "cuda")
        model_fn, _ = cs.make_victim("PointNet", "cuda", clouds, ("dropout",))
        data = clouds[: cs.B]
        return model_fn, data, cs.victim_labels(model_fn, data, labels[: cs.B], "slice-knn")
    if name == "DGCNN":
        data, labels = cs.synthetic_data(8, 2, cs.DG_DATA, "cuda")
        model_fn, _ = cs.make_victim(name, "cuda", data, ("dp1", "dp2"))
        return model_fn, data, cs.victim_labels(model_fn, data, labels, "slice-dgcnn")
    if name == "PointNet GeoA3":
        data, labels = cs.synthetic_data(8, 1, cs.GEO_DATA, "cuda")
        model_fn, _ = cs.make_victim("PointNet", "cuda", data, ("dropout",))
        return model_fn, data, cs.victim_labels(model_fn, data, labels, "slice-geoa3")
    if name == "CurveNet":
        data, labels = cs.synthetic_data(8, 1, cs.CN_DATA, "cuda")
        model_fn, _ = cs.make_victim(name, "cuda", data, ("dp1",))
        return model_fn, data, cs.victim_labels(model_fn, data, labels, "slice-curvenet")
    if name == "PointNet DUP-Net":
        data, labels = cs.synthetic_data(8, 4, cs.SIQ_DATA, "cuda")
        _, dfn, _, target = cs.defended_victim("dupnet", data, labels, "slice-cw-dupnet", cs.punet_state())
        return dfn, data[: cs.DUP_CW_B], target[: cs.DUP_CW_B]
    if name == "CurveNet GeoA3":
        import torch

        data, labels = cs.synthetic_data(8, 1, cs.GEO_DATA, "cuda")
        fn, _ = cs.make_victim("CurveNet", "cuda", data, ("dp1",))
        logp_fn = lambda x: torch.log_softmax(fn(x), dim=-1)  # noqa: E731
        return logp_fn, data, cs.victim_labels(logp_fn, data, labels, "slice-geoa3-curvenet")
    data, labels = cs.synthetic_data(8, 2, cs.PN2_DATA[name], "cuda")
    model_fn, _ = cs.make_victim(name, "cuda", data, ("drop1", "drop2"))
    tag = "slice-ssg" if name == "PointNet++Ssg" else "slice-msg"
    return model_fn, data, cs.victim_labels(model_fn, data, labels, tag)


def geoa3(cs, model_fn, rounds, iters, refresh=1):
    from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack

    return build_geoa3_attack(model_fn, GeoA3Config(binary_max_steps=rounds, iter_max_steps=iters,
                                                    curv_knn_refresh=refresh))


def knn_attack(cs, model_fn, iters):
    from pointcloudattack_tpu_torch.attacks.knn import KNNAttackConfig, build_knn_attack

    cfg = KNNAttackConfig(attack_lr=cs.KNN_LR, num_iter=iters, kappa=cs.KAPPA, budget=cs.BUDGET, nn_refresh=1)
    return build_knn_attack(model_fn, cfg)


def attack_of(cs, cell, model_fn):
    if cell == "slice":
        return cs.cw_attack(model_fn, cs.NUM_ITER)
    if cell == "slice-knn":
        return knn_attack(cs, model_fn, cs.KNN_ITER)
    if cell == "slice-knn-ssg":
        return knn_attack(cs, model_fn, cs.KNN_SSG_ITER)
    if cell == "slice-dgcnn":
        return cs.cw_attack(model_fn, cs.DG_ITER)
    if cell in ("slice-geoa3", "slice-geoa3-r4"):
        return geoa3(cs, model_fn, cs.GEO_ROUNDS, cs.GEO_ITER, cs.GEO_REFRESH if cell.endswith("r4") else 1)
    if cell == "slice-curvenet":
        return cs.cw_attack(model_fn, cs.CN_ITER)
    if cell == "slice-geoa3-curvenet":
        return geoa3(cs, model_fn, cs.CN_GEO_ROUNDS, cs.CN_GEO_ITER)
    if cell == "slice-cw-dupnet":
        return cs.cw_attack(model_fn, cs.DUP_CW_ITER)
    return cs.cw_attack(model_fn, cs.PN2_ITER)


def kernel_times(cs, root, cell, label, fn):
    """One kernel input: the wrapper's ms (CUDA events over back-to-back
    calls) and each kernel's device ms under the profiler."""
    import torch

    ms = cs.time_ms(fn, reps=20)
    dev = cs.device_ms(fn)
    print(f"{root} [{cell}] {label}: {ms:.4f} ms a call on {torch.cuda.get_device_name(0)}; device "
          + ", ".join(f"{n} {v:.4f}" for n, v in dev.items()) + f" ({sum(dev.values()):.4f} in all)", flush=True)
    return ms, dev


def knn_inputs(mod, model_fn, data):
    """The (x, k) of every kNN that the victim module ``mod`` runs in one
    forward of ``model_fn`` on ``data``."""
    import torch

    orig, seen = mod.knn, []

    def rec(x, k):
        seen.append((x.detach().clone(), k))
        return orig(x, k)

    mod.knn = rec
    try:
        with torch.no_grad():
            model_fn(data)
    finally:
        mod.knn = orig
    return seen


def kernels_knn(cs, root, made):
    from pointcloudattack_tpu_torch.models import curvenet, dgcnn
    from pointcloudattack_tpu_torch.ops.knn import knn

    if "DGCNN" not in made:
        made["DGCNN"] = victim(cs, "DGCNN")
    inputs = [(f"dgcnn conv{i + 1}", x, k)
              for i, (x, k) in enumerate(knn_inputs(dgcnn, made["DGCNN"][0], made["DGCNN"][1]))]
    inputs.append(("geoa3 cached set", cs.synthetic_data(8, 1, cs.GEO_DATA, "cuda")[0], cs.GEO_K + 1))
    cn_data = cs.synthetic_data(8, 1, cs.CN_DATA, "cuda")[0]
    cn_fn, _ = cs.make_victim("CurveNet", "cuda", cn_data, ("dp1",))
    inputs += [(f"curvenet knn{i + 1}", x, k) for i, (x, k) in enumerate(knn_inputs(curvenet, cn_fn, cn_data))]
    for what, x, k in inputs:
        kernel_times(cs, root, "kernels-knn", f"{what} {tuple(x.shape)} k={k}", lambda: knn(x, k))


def geoa3_iterate(cs):
    """chip_smoke.py's phase_kernels_geoa3 inputs: an iterate 1e-3 from
    GeoA3's clouds with its nearest clean point's normal, dkappa, the
    clouds with an iterate 1e-2 from them, and the bundle's cotangents."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.geometry.normals import estimate_normal
    from pointcloudattack_tpu_torch.losses.geometry import nn1_idx
    from pointcloudattack_tpu_torch.ops.gather import index_points

    data = cs.synthetic_data(8, 1, cs.GEO_DATA, "cuda")[0]
    rng = np.random.RandomState(11)
    b, n, _ = data.shape
    dev = lambda arr: torch.from_numpy(arr.astype(np.float32)).cuda()  # noqa: E731
    adv = (data + dev(rng.randn(b, n, 3) * 1e-3)).contiguous()
    nrm = index_points(estimate_normal(data), nn1_idx(adv, data)).contiguous()
    dk = dev(rng.randn(b, n) * 1e-3)
    gr, gc = dev(rng.rand(b, n)), dev(rng.rand(b, n))  # chip_smoke.py's bundle cotangents
    moved = (data + dev(rng.randn(b, n, 3) * 1e-2)).contiguous()
    return adv, nrm, dk, data, moved, gr, gc


def kernels_kappa(cs, root):
    """The curvature backward on ``geoa3_iterate``'s inputs: on the
    selecting forward's picks; and on the clouds' own sets, stale on the
    iterate 1e-2 away."""
    from pointcloudattack_tpu_torch.ops import kappa

    adv, nrm, dk, data, moved, _, _ = geoa3_iterate(cs)
    b, n, _ = adv.shape
    idx = cs.stale_idx(moved, data)[0]
    _, picks = kappa.kappa_fwd(adv, nrm, cs.GEO_K)
    kernel_times(cs, root, "kernels-kappa", f"kappa_bwd [{b},{n},3] k={cs.GEO_K} (the forward's picks)",
                 lambda: kappa.kappa_bwd(adv, nrm, picks, dk, cs.GEO_K))
    kernel_times(cs, root, "kernels-kappa", f"kappa_idx_bwd [{b},{n},3] k={cs.GEO_K} (a stale set)",
                 lambda: kappa.kappa_bwd(moved, nrm, idx, dk, cs.GEO_K, counter="kappa_idx_bwd"))


def kernels_kappa_fwd(cs, root):
    """The selecting curvature forward on ``geoa3_iterate``'s iterate."""
    from pointcloudattack_tpu_torch.ops import kappa

    adv, nrm, *_ = geoa3_iterate(cs)
    b, n, _ = adv.shape
    kernel_times(cs, root, "kernels-kappa-fwd", f"kappa_fwd [{b},{n},3] k={cs.GEO_K}",
                 lambda: kappa.kappa_fwd(adv, nrm, cs.GEO_K))


def kernels_group_mean(cs, root):
    """The group mean backward at chip_smoke.py's eight residual LPFA cases
    (its seeds), and their sum."""
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    total, dev_total = 0.0, 0.0
    for i, (name, (ng, c0, widths, pool)) in enumerate(cs.CURVENET_GROUP_SHAPES.items()):
        if pool != "mean":
            continue
        x, layers, dy = cs.group_case(60 + i, cs.CN_B, ng, cs.CN_K, (c0, *widths))
        g = (dy * layers[-1][3] / cs.CN_K).contiguous()
        ms, dev = kernel_times(cs, root, "kernels-group-mean", f"{name} {tuple(x.shape)} -> {widths[-1]}",
                               lambda: gch.chain_groupmean_bwd(x, layers, g, cs.CN_SLOPE))
        total, dev_total = total + ms, dev_total + sum(dev.values())
    print(f"{root} [kernels-group-mean] the eight a backward: {total:.4f} ms through the wrapper, {dev_total:.4f} ms "
          "of device time", flush=True)


def group_cases(cs, pool):
    """chip_smoke.py's LPFA cases of one pool (its seeds): (name, x, layers, dy)."""
    for i, (name, (ng, c0, widths, p)) in enumerate(cs.CURVENET_GROUP_SHAPES.items()):
        if p == pool:
            yield (name, *cs.group_case(60 + i, cs.CN_B, ng, cs.CN_K, (c0, *widths)))


def kernels_group_fwd(cs, root):
    """The group forwards at chip_smoke.py's nine LPFA cases: the initial
    LPFA's max, then the eight residual means and their sum."""
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    for name, x, layers, _ in group_cases(cs, "max"):
        kernel_times(cs, root, "kernels-group-fwd", f"max {name} {tuple(x.shape)} -> {layers[-1][0].shape[1]}",
                     lambda: gch.chain_groupmax_fwd(x, layers, cs.CN_SLOPE))
    total, dev_total = 0.0, 0.0
    for name, x, layers, _ in group_cases(cs, "mean"):
        ms, dev = kernel_times(cs, root, "kernels-group-fwd", f"mean {name} {tuple(x.shape)} -> {layers[-1][0].shape[1]}",
                               lambda: gch.chain_groupmean_fwd(x, layers, cs.CN_SLOPE))
        total, dev_total = total + ms, dev_total + sum(dev.values())
    print(f"{root} [kernels-group-fwd] the eight mean forwards: {total:.4f} ms through the wrapper, {dev_total:.4f} ms "
          "of device time", flush=True)


def kernels_group_max_bwd(cs, root):
    """The initial LPFA's max backward on its forward's argmax, with
    chip_smoke.py's cotangent."""
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    for name, x, layers, dy in group_cases(cs, "max"):
        _, am = gch.chain_groupmax_fwd(x, layers, cs.CN_SLOPE)
        g = (dy * layers[-1][3]).contiguous()
        kernel_times(cs, root, "kernels-group-max-bwd", f"max {name} {tuple(x.shape)} -> {layers[-1][0].shape[1]}",
                     lambda: gch.chain_groupmax_bwd(x, layers, am, g, cs.CN_SLOPE))


def kernels_fps(cs, root):
    """Farthest point sampling on chip_smoke.py's clouds (its seeds): SSG's
    two set abstractions at B=16 and CurveNet's two at B=8, and the sum of
    each forward's two."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops import fps

    for what, b, shapes in (("ssg", cs.PN2_B, ((1024, 512), (512, 128))), ("curvenet", cs.CN_B, ((1024, 256), (256, 64)))):
        total, dev_total = 0.0, 0.0
        for n, npoint in shapes:
            xyz = torch.from_numpy((np.random.RandomState(n).randn(b, n, 3) * 0.5).astype(np.float32)).cuda()
            ms, dev = kernel_times(cs, root, "kernels-fps", f"{what} [{b},{n},3] -> {npoint}",
                                   lambda: fps.farthest_point_sample(xyz, npoint))
            dev_ms = sum(dev.values())
            print(f"{root} [kernels-fps] {what} [{b},{n},3] -> {npoint}: {dev_ms * 1e3 / (npoint - 1):.4f} us of device "
                  "time a step", flush=True)
            total, dev_total = total + ms, dev_total + dev_ms
        print(f"{root} [kernels-fps] {what} forward's two: {total:.4f} ms through the wrapper, {dev_total:.4f} ms of "
              "device time", flush=True)


def kernels_both(cs, root):
    """The two-direction bundle's forward and backward on ``geoa3_iterate``'s
    iterate against GeoA3's clouds, with chip_smoke.py's cotangents."""
    from pointcloudattack_tpu_torch.ops import chamfer

    adv, _, _, data, _, gr, gc = geoa3_iterate(cs)
    b, n, _ = adv.shape
    fwd = chamfer.both_fwd(adv, data)
    kernel_times(cs, root, "kernels-both", f"both_fwd [{b},{n},3]^2", lambda: chamfer.both_fwd(adv, data))
    kernel_times(cs, root, "kernels-both", f"both_bwd [{b},{n},3]^2",
                 lambda: chamfer.both_bwd(adv, data, fwd[1], fwd[3], gr, gc))


def kernels_rowmin(cs, root):
    """The Chamfer row min on chip_smoke.py's phase-13 iterate (the KNN
    clouds plus noise of 0.01, its seed) against the clouds, at B = 64 and
    16."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops import chamfer

    data = cs.synthetic_data(cs.NUM_CLASSES, 2, cs.KNN_DATA, "cuda")[0][: cs.B]
    rng = np.random.RandomState(8)
    adv = (data + torch.from_numpy(rng.randn(*data.shape).astype(np.float32) * 0.01).cuda()).contiguous()
    for b in (64, 16):
        x, y = adv[:b].contiguous(), data[:b].contiguous()
        kernel_times(cs, root, "kernels-rowmin", f"min_rows [{b},{x.shape[1]},3]^2", lambda: chamfer.min_rows_fwd(x, y))


def kernels_kappa_idx_fwd(cs, root):
    """The curvature forward on the clouds' own sets, stale on
    ``geoa3_iterate``'s iterate 1e-2 away; then its device time beside a
    one-element zero_() in one profiler window, the launch floor."""
    import torch

    from pointcloudattack_tpu_torch.ops import kappa

    _, nrm, _, data, moved, _, _ = geoa3_iterate(cs)
    b, n, _ = moved.shape
    idx = cs.stale_idx(moved, data)[0]
    kernel_times(cs, root, "kernels-kappa-idx-fwd", f"kappa_idx_fwd [{b},{n},3] k={cs.GEO_K} (a stale set)",
                 lambda: kappa.kappa_idx_fwd(moved, nrm, idx, cs.GEO_K))
    one = torch.zeros(1, device="cuda")
    dev = cs.device_ms(lambda: (kappa.kappa_idx_fwd(moved, nrm, idx, cs.GEO_K), one.zero_()), reps=20)
    print(f"{root} [kernels-kappa-idx-fwd] beside a one-element zero_() (the launch floor), device "
          + ", ".join(f"{name} {v:.4f}" for name, v in dev.items()), flush=True)


def kernels_group_punet(cs, root):
    """The group max forward and backward at PU-Net's four set
    abstractions, on the rows and layers of one DUP-Net forward over
    SI-query's clouds (chip_smoke.py's [kernels-punet] inputs and
    cotangents), and the sums of their device times."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.models import punet
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    data = cs.synthetic_data(8, 4, cs.SIQ_DATA, "cuda")[0]
    dup = cs.defended(lambda x: x, "dupnet", cs.punet_state())
    with torch.no_grad(), cs.op_trace(((punet, "mlp_chain_groupmax"),), inputs=True) as rec:
        dup(data)
    total = {"fwd": 0.0, "bwd": 0.0}
    for i, (x, layers) in enumerate(args for _, args in rec):
        b, ng, k, c0 = x.shape
        dims = [c0] + [layer[0].shape[1] for layer in layers]
        dy = torch.from_numpy(np.random.RandomState(120 + i).randn(b, ng, dims[-1]).astype(np.float32)).cuda()
        _, am = gch.chain_groupmax_fwd(x, layers, 0.0)
        g = (dy * layers[-1][3]).contiguous()
        for d, fn in (("fwd", lambda: gch.chain_groupmax_fwd(x, layers, 0.0)),
                      ("bwd", lambda: gch.chain_groupmax_bwd(x, layers, am, g, 0.0))):
            _, dev = kernel_times(cs, root, "kernels-group-punet", f"max {d} sa{i} {tuple(x.shape)} -> {dims[1:]}", fn)
            total[d] += sum(dev.values())
    print(f"{root} [kernels-group-punet] the four a DUP-Net forward: forward {total['fwd']:.4f} ms, backward "
          f"{total['bwd']:.4f} ms of device time", flush=True)


KERNEL_CELLS = {"kernels-kappa": kernels_kappa, "kernels-kappa-fwd": kernels_kappa_fwd,
                "kernels-group-mean": kernels_group_mean, "kernels-group-fwd": kernels_group_fwd,
                "kernels-group-max-bwd": kernels_group_max_bwd, "kernels-fps": kernels_fps, "kernels-both": kernels_both,
                "kernels-rowmin": kernels_rowmin, "kernels-kappa-idx-fwd": kernels_kappa_idx_fwd,
                "kernels-group-punet": kernels_group_punet}


def main():
    root = sys.argv[1]
    cells = [a for a in sys.argv[2:] if a != "--profile"] or ["slice"]
    profile = "--profile" in sys.argv[2:]
    unknown = [c for c in cells if c not in CELLS]
    if unknown:
        raise SystemExit(f"unknown cells {unknown}; cells are {CELLS}")
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import pointcloudattack_tpu_torch  # noqa: F401  (TF32 off)

    keys = ("num_device_alloc", "num_device_free", "num_sync_all_streams", "num_alloc_retries")
    gen = torch.Generator(device="cuda")
    made = {}
    for cell in cells:
        if cell == "kernels-knn":
            kernels_knn(cs, root, made)
            continue
        if cell in KERNEL_CELLS:
            KERNEL_CELLS[cell](cs, root)
            continue
        name = VICTIMS[cell]
        if name not in made:
            made[name] = victim(cs, name)
        model_fn, data, target = made[name]
        attack = attack_of(cs, cell, model_fn)
        times = []
        for rep in range(4):
            gen.manual_seed(rep)
            before = torch.cuda.memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            attack(data, target, generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            after = torch.cuda.memory_stats()
            print(f"{root} [{cell}] run {rep}: {times[-1]:.6f} s",
                  {k: after.get(k, 0) - before.get(k, 0) for k in keys}, flush=True)
        print(f"{root} [{cell}] min of runs 1-3: {min(times[1:]):.6f} s on {torch.cuda.get_device_name(0)}",
              flush=True)
    if profile:
        for name, (model_fn, data, target) in made.items():
            if name == "PointNet GeoA3" and "slice-geoa3-r4" in cells:
                cs.phase_profile("profile-geoa3-r4", model_fn, data, target, geoa3(cs, model_fn, 1, 10, cs.GEO_REFRESH),
                                 f"GeoA3 1x10 curv_knn_refresh {cs.GEO_REFRESH}")
            if name in ("PointNet GeoA3", "CurveNet GeoA3"):
                cs.phase_profile(PROFILE_TAGS[name], model_fn, data, target, geoa3(cs, model_fn, 1, 10), "GeoA3 1x10")
            elif name == "PointNet KNN":
                cs.phase_profile(PROFILE_TAGS[name], model_fn, data, target, knn_attack(cs, model_fn, 10), "KNN 10")
            else:
                cs.phase_profile(PROFILE_TAGS[name], model_fn, data, target)


if __name__ == "__main__":
    main()
