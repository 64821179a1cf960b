"""Time C&W on PointNet (chip_smoke.py's [slice] cell) in one checkout.

Run on a machine with one H100, once per checkout to compare, in turns
(for example parent, change, change, parent):

    python3 scripts/slice_turns.py /path/to/checkout

It builds that checkout's kernels, makes the [slice] victim and clouds as
chip_smoke.py does (seeded, B=64, N=1024, 40 classes) and runs C&W 1 x 200
four times, printing each run's seconds and the CUDA caching allocator's
counters over it (device allocations and frees, syncs, retries); the first
run is the warm-up.
"""

import sys
import time


def main():
    root = sys.argv[1]
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import pointcloudattack_tpu_torch  # noqa: F401  (TF32 off)

    clouds, labels = cs.synthetic_data(cs.NUM_CLASSES, 2, 0, "cuda")
    model_fn, _ = cs.make_victim("PointNet", "cuda", clouds, ("dropout",))
    data = clouds[: cs.B]
    target = cs.victim_labels(model_fn, data, labels[: cs.B])
    attack = cs.cw_attack(model_fn, cs.NUM_ITER)
    gen = torch.Generator(device="cuda")
    keys = ("num_device_alloc", "num_device_free", "num_sync_all_streams", "num_alloc_retries")
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
        print(f"{root} run {rep}: {times[-1]:.4f} s", {k: after.get(k, 0) - before.get(k, 0) for k in keys}, flush=True)
    print(f"{root} min of runs 1-3: {min(times[1:]):.4f} s on {torch.cuda.get_device_name(0)}")


if __name__ == "__main__":
    main()
