"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

It takes about a minute, the kernel build included.

Phases, each raising on failure (nothing is caught; any failure exits
non-zero and prints no result):

1. device   CUDA present, capability (9, 0); the card's name and power limit.
2. build    nvcc builds the kernels from this checkout's csrc/.
3. kernels  the chain + max-pool kernel against its plain PyTorch version at
            PointNet's spine shape (B=64, N=1024, 3 -> 64 -> 128 -> 1024) and
            at a ragged N=1000; forward and backward times beside the plain
            version's.
4. slice    the headline attack: untargeted C&W on PointNet, f32, B=64,
            N=1024, 40 classes, kappa 30, budget 0.18, 1 x 200 Adam steps,
            seeded random weights with BatchNorm statistics taken from the
            clouds, on synthetic clouds labelled with the victim's own clean
            predictions (so every success comes from the gradient steps);
            the kernels must carry it (launch counts) and ASR must be above 0.
5. parity   a short attack (B=8, 1 x 10) on the card and on the CPU (the
            plain versions) from the same weights and noise must agree:
            success, best distance and the adversarial clouds.
6. profile  torch.profiler over 10 CW iterations at the headline shape:
            kernel time by name and the device's idle share.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel record.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SRC = "pointcloudattack_tpu_torch/csrc/chain_maxpool.cu"
TPU_FWD = "pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:188"
TPU_BWD = "pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:216"

B, N, NUM_CLASSES = 64, 1024, 40
SPINE = (3, 64, 128, 1024)
BINARY_STEP, NUM_ITER, KAPPA, BUDGET = 1, 200, 30.0, 0.18
Y_TOL = dict(rtol=1e-5, atol=1e-4)  # 128-term f32 sums in another order
DX_TOL = dict(rtol=1e-4, atol=1e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; it needs an NVIDIA GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper GPU (capability 9.0), found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} capability {cap}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    return smi


def phase_build():
    from pointcloudattack_tpu_torch.ops import _build

    _build.load_library()
    info = _build.build_info()
    log(f"[build] {'built' if info.built else 'loaded'} {info.path} in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build]   {line.strip()}")


def seeded_chain(seed, b, n, dims, device):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, n, dims[0]).astype(np.float32)).to(device)
    layers = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        arrs = (
            rng.randn(cin, cout) / np.sqrt(cin), rng.randn(cout) * 0.1,
            rng.randn(cout) * 0.05, rng.rand(cout) + 0.5, rng.randn(cout) * 0.1,
        )
        layers.append(tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs))
    dy = torch.from_numpy(rng.randn(b, dims[-1]).astype(np.float32)).to(device)
    return x, layers, dy


def top2_gap(x, layers):
    import torch

    z = x
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        if i:
            z = torch.relu(z)
        z = (z @ w + b - mean) * mul + beta
    top = z.topk(2, dim=1).values
    return top[:, 0] - top[:, 1]


def time_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_chain(cm, b, n, seed):
    """Kernel against plain at one shape; returns (max |dy|, max |ddx|)."""
    import torch

    x, layers, dy = seeded_chain(seed, b, n, SPINE, "cuda")
    y, idx = cm.chain_maxpool_fwd(x, layers)
    y_ref, idx_ref = cm.chain_maxpool_plain(x, layers)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    near = top2_gap(x, layers) <= Y_TOL["atol"]
    wrong = (idx != idx_ref) & ~near
    if int(wrong.sum()):
        raise AssertionError(f"idx differs in {int(wrong.sum())} columns with a clear winner")
    g = (dy * layers[-1][3]).contiguous()
    dx = cm.chain_maxpool_bwd(x, layers, idx_ref, g)
    dx_ref = cm.chain_maxpool_bwd_plain(x, layers, idx_ref, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx, dx_ref, **DX_TOL)
    err_y = float((y - y_ref).abs().max())
    err_dx = float((dx - dx_ref).abs().max())
    log(f"[kernels] B={b} N={n} chain {SPINE}: y max|err| {err_y:.3e}; idx equal except "
        f"{int((idx != idx_ref).sum())} of {int(near.sum())} near-tie columns "
        f"(top-2 gap <= {Y_TOL['atol']}); dx max|err| {err_dx:.3e}")
    return err_y, err_dx, (x, layers, idx_ref, g)


def phase_kernels():
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm

    err_y, err_dx, (x, layers, idx, g) = check_chain(cm, B, N, seed=0)
    check_chain(cm, 8, 1000, seed=1)  # ragged tail: 1000 is no multiple of the row tile

    # W^T made once, as the autograd path takes it from the module's weight
    wts = [layer[0].t().contiguous() for layer in layers]
    fwd = lambda: cm.chain_maxpool_fwd(x, layers)
    fwd_plain = lambda: cm.chain_maxpool_plain(x, layers)
    bwd = lambda: cm.chain_maxpool_bwd(x, layers, idx, g, wts)
    bwd_plain = lambda: cm.chain_maxpool_bwd_plain(x, layers, idx, g)
    # in turns, plain / kernel / kernel / plain, within this one call
    t = {k: [] for k in ("fwd", "fwd_plain", "bwd", "bwd_plain")}
    for order in (("fwd_plain", "fwd", "bwd_plain", "bwd"), ("fwd", "fwd_plain", "bwd", "bwd_plain")):
        for k in order:
            t[k].append(time_ms({"fwd": fwd, "fwd_plain": fwd_plain, "bwd": bwd, "bwd_plain": bwd_plain}[k]))
    ms = {k: sum(v) / len(v) for k, v in t.items()}
    flops = 2 * B * N * sum(a * b for a, b in zip(SPINE[:-1], SPINE[1:]))
    log(f"[kernels] B={B} N={N}: forward kernel {ms['fwd']:.4f} ms, plain {ms['fwd_plain']:.4f} ms "
        f"(kernel {flops / ms['fwd'] / 1e9:.2f} TFLOP/s f32); backward kernel {ms['bwd']:.4f} ms, "
        f"plain {ms['bwd_plain']:.4f} ms; runs {t}")
    return {"err_y": err_y, "err_dx": err_dx, **ms}


def make_victim(device, clouds):
    """PointNet with seeded random weights and the BatchNorm statistics of
    ``clouds`` (one train-mode pass at momentum 1): ``(model_fn, state)``.

    At its initial BatchNorm statistics a random PointNet gives every cloud
    nearly the same logits, and the attack moves none of them in 200 steps;
    with the statistics of the data its logits follow the input.
    """
    import torch
    from torch import nn

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    model = models.make_model("PointNet", NUM_CLASSES, generator=torch.Generator().manual_seed(0))
    model.to(device).train()
    model.dropout.eval()
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm1d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model(clouds)
    for m in bns:
        m.momentum = 0.1
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return make_model_fn(model, None, device), state


def headline_data(device):
    """The 80 clouds of ``make_synthetic_clouds(40, 2, 1024, seed=0)`` and
    their labels; the attack takes the first 64, as bench.py does."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds

    clouds, labels = make_synthetic_clouds(NUM_CLASSES, 2, N, seed=0)
    return torch.from_numpy(clouds).to(device), torch.from_numpy(labels.astype(np.int64)).to(device)


def victim_labels(model_fn, data, labels):
    """The victim's clean predictions, the labels the attack must flip.
    With random weights the dataset labels say nothing: the victim misses
    nearly all of them, so against them the attack succeeds at step 0."""
    import torch

    with torch.no_grad():
        pred = model_fn(data).argmax(dim=-1)
    log(f"[slice] the victim agrees with the dataset labels on {int((pred == labels).sum())}"
        f"/{len(pred)} clouds; the attack is held to its clean predictions "
        f"({len(torch.unique(pred))} distinct classes)")
    return pred


def phase_slice(model_fn, data, target):
    import torch

    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm

    cfg = CWPerturbConfig(binary_step=BINARY_STEP, num_iter=NUM_ITER, kappa=KAPPA, budget=BUDGET)
    attack = build_cw_attack(model_fn, cfg)
    gen = torch.Generator(device="cuda")

    def run(seed):
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = attack(data, target, generator=gen)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    cm.reset_launches()
    res, t_warm = run(1)  # the counted main-path run, also the warm-up
    launches = dict(cm.LAUNCHES)
    forwards = BINARY_STEP * NUM_ITER + 1  # one per Adam step, one final
    want = {"fwd": 2 * forwards, "bwd": 2 * BINARY_STEP * NUM_ITER}
    log(f"[slice] kernel launches during the attack: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")

    adv = res.best_attack
    if tuple(adv.shape) != (B, N, 3) or not bool(torch.isfinite(adv).all()):
        raise AssertionError("best_attack is not a finite [B, N, 3] tensor")
    moved = (adv - data).norm(dim=-1).max()
    if float(moved) > BUDGET * (1 + 1e-5):
        raise AssertionError(f"a point moved {float(moved)} > budget {BUDGET}")
    succ = res.success
    if not bool(torch.isfinite(res.best_dist[succ]).all()):
        raise AssertionError("non-finite best_dist on a successful example")
    asr = float(succ.float().mean())
    log(f"[slice] ASR {asr:.3f} ({int(succ.sum())}/{B}); max per-point move {float(moved):.4f}; "
        f"mean best L2 of successes {float(res.best_dist[succ].mean()) if asr else float('nan'):.5f}")
    if asr <= 0:
        raise AssertionError("ASR is 0")

    times = [run(2 + i)[1] for i in range(3)]
    tmin, tmean = min(times), sum(times) / len(times)
    log(f"[slice] CW {BINARY_STEP}x{NUM_ITER} B={B} N={N}: warm-up {t_warm:.4f} s; "
        f"timed {[round(t, 6) for t in times]} s/batch; min {tmin:.6f} s "
        f"({B / tmin:.3f} clouds/s), mean {tmean:.6f} s ({B / tmean:.3f} clouds/s)")
    return launches


def phase_parity(model_fn, state, data, target):
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b = 8
    cfg = CWPerturbConfig(binary_step=1, num_iter=10, kappa=KAPPA, budget=BUDGET)
    noise = torch.from_numpy(np.random.RandomState(5).randn(1, b, N, 3).astype(np.float32))
    cpu_fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state, "cpu")
    res_gpu = build_cw_attack(model_fn, cfg)(data[:b], target[:b], init_noise=noise.cuda())
    res_cpu = build_cw_attack(cpu_fn, cfg)(data[:b].cpu(), target[:b].cpu(), init_noise=noise)
    succ_gpu = res_gpu.success.cpu()
    # every cloud starts as the victim's clean prediction, so what follows
    # depends on the Adam steps, i.e. on the backward kernel's dx
    diff = (res_gpu.best_attack.cpu() - res_cpu.best_attack).abs()
    rel = ((res_gpu.best_dist.cpu() - res_cpu.best_dist).abs() / res_cpu.best_dist).max()
    log(f"[parity] card vs CPU, B={b} 1x10: success card {succ_gpu.tolist()} cpu "
        f"{res_cpu.success.tolist()}; best_dist card {res_gpu.best_dist.cpu().tolist()}, "
        f"max rel diff {float(rel):.3e}; best_attack max |diff| {float(diff.max()):.3e}, "
        f"{int((diff > 1e-5).any(-1).sum())} of {b * N} points beyond 1e-5")
    if not torch.equal(succ_gpu, res_cpu.success):
        raise AssertionError("success differs between the card and the CPU")
    if not bool(res_cpu.success.any()):
        raise AssertionError("the short attack flipped no cloud: it tests no gradient")
    torch.testing.assert_close(res_gpu.best_dist.cpu(), res_cpu.best_dist, rtol=1e-3, atol=0.0)
    torch.testing.assert_close(res_gpu.best_attack.cpu(), res_cpu.best_attack, rtol=0.0, atol=1e-5)


def phase_profile(model_fn, data, target):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack

    iters = 10
    attack = build_cw_attack(
        model_fn, CWPerturbConfig(binary_step=1, num_iter=iters, kappa=KAPPA, budget=BUDGET)
    )
    attack(data, target)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        attack(data, target)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side kernel events only (op rows would count their kernels twice)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:  # union of kernel intervals, us
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    window = (end - spans[0][0]) if spans else 0.0
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    total = sum(t for t, _ in by_name.values())
    log(f"[profile] CW 1x{iters} B={B} under the profiler: wall {wall * 1e3:.3f} ms; "
        f"{len(kernels)} kernels, {total / 1e3:.3f} ms of kernel time; device busy "
        f"{busy / 1e3:.3f} ms of the {window / 1e3:.3f} ms kernel window "
        f"(idle share {1 - busy / window if window else float('nan'):.3f})")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {t / 1e3:9.3f} ms  {t / total:6.3f}  x{n:<5d} {name[:90]}")


def main():
    if not (ROOT / KERNEL_SRC).is_file():
        raise SystemExit(f"chip_smoke: {KERNEL_SRC} not found beside this script; run it from a checkout")
    sys.path.insert(0, str(ROOT))

    smi = phase_device()
    import torch

    import pointcloudattack_tpu_torch  # noqa: F401  (TF32 off)

    phase_build()
    k = phase_kernels()
    clouds, labels = headline_data("cuda")
    model_fn, state = make_victim("cuda", clouds)
    data = clouds[:B]
    target = victim_labels(model_fn, data, labels[:B])
    launches = phase_slice(model_fn, data, target)
    phase_parity(model_fn, state, data, target)
    phase_profile(model_fn, data, target)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pointcloudattack_tpu"))
    if loaded:
        raise AssertionError(f"the JAX side was imported: {loaded}")

    record = {"kernels": [
        {"name": "chain_maxpool_fwd", "route": "cuda", "source": KERNEL_SRC, "replaces": TPU_FWD,
         "launches": launches["fwd"], "max_abs_err": k["err_y"], "ms": k["fwd"], "plain_ms": k["fwd_plain"]},
        {"name": "chain_maxpool_bwd", "route": "cuda", "source": KERNEL_SRC, "replaces": TPU_BWD,
         "launches": launches["bwd"], "max_abs_err": k["err_dx"], "ms": k["bwd"], "plain_ms": k["bwd_plain"]},
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
