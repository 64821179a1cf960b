"""Time chip_smoke.py's attack cells in one checkout.

Run on a machine with one H100, once per checkout to compare, in turns
(for example parent, change, change, parent):

    python3 scripts/slice_turns.py /path/to/checkout [CELL ...] [--profile]

CELL is one of ``slice`` (C&W 1 x 200 on PointNet, B=64; the default),
``slice-ssg``, ``slice-msg`` (C&W on PointNet++ SSG and MSG, B=16) and
``slice-knn-ssg`` (KNN on SSG).  It builds that checkout's kernels, makes
each victim and its clouds as chip_smoke.py does (seeded random weights
with the clouds' BatchNorm statistics, N=1024), runs each attack four
times, printing each run's seconds and the CUDA caching allocator's
counters over it (device allocations and frees, syncs, retries), then the
min of runs 1-3 (run 0 is the warm-up).  With ``--profile`` it then prints,
for each victim it timed, chip_smoke.py's profile line (10 C&W iterations
under torch.profiler: kernel time and the device's idle share).  It reads
only names that chip_smoke.py has kept since PointNet++ moved to the ball
route, so an earlier checkout runs it too.
"""

import sys
import time

CELLS = ("slice", "slice-ssg", "slice-msg", "slice-knn-ssg")
VICTIMS = {"slice": "PointNet", "slice-ssg": "PointNet++Ssg", "slice-msg": "PointNet++Msg",
           "slice-knn-ssg": "PointNet++Ssg"}


def victim(cs, name):
    """(model_fn, data, target) of chip_smoke.py's cells on ``name``."""
    if name == "PointNet":
        clouds, labels = cs.synthetic_data(cs.NUM_CLASSES, 2, 0, "cuda")
        model_fn, _ = cs.make_victim(name, "cuda", clouds, ("dropout",))
        data = clouds[: cs.B]
        return model_fn, data, cs.victim_labels(model_fn, data, labels[: cs.B])
    data, labels = cs.synthetic_data(8, 2, cs.PN2_DATA[name], "cuda")
    model_fn, _ = cs.make_victim(name, "cuda", data, ("drop1", "drop2"))
    tag = "slice-ssg" if name == "PointNet++Ssg" else "slice-msg"
    return model_fn, data, cs.victim_labels(model_fn, data, labels, tag)


def attack_of(cs, cell, model_fn):
    if cell == "slice":
        return cs.cw_attack(model_fn, cs.NUM_ITER)
    if cell == "slice-knn-ssg":
        from pointcloudattack_tpu_torch.attacks.knn import KNNAttackConfig, build_knn_attack

        cfg = KNNAttackConfig(attack_lr=cs.KNN_LR, num_iter=cs.KNN_SSG_ITER, kappa=cs.KAPPA, budget=cs.BUDGET,
                              nn_refresh=1)
        return build_knn_attack(model_fn, cfg)
    return cs.cw_attack(model_fn, cs.PN2_ITER)


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
            tag = {"PointNet": "profile", "PointNet++Ssg": "profile-ssg", "PointNet++Msg": "profile-msg"}[name]
            cs.phase_profile(tag, model_fn, data, target)


if __name__ == "__main__":
    main()
