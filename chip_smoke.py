"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

It takes about six to seven minutes, the kernel build included.

Phases, each raising on failure (nothing is caught; any failure exits
non-zero and prints no result):

1. device     CUDA present, capability (9, 0); the card's name and power limit.
2. build      nvcc builds the kernels from this checkout's csrc/, one process
              per source; then, for comparison, one nvcc call builds them
              one after another into a scratch directory.
3. kernels    the chain + max-pool kernel against its plain PyTorch version at
              PointNet's spine shape (B=64, N=1024, 3 -> 64 -> 128 -> 1024) and
              at a ragged N=1000; forward and backward times beside the plain
              version's.  Then the PointNet++ kernels at every shape the SSG
              and MSG paths give them (B=16, N=1024): FPS bit for bit, the
              gather + chain + max forward and backward, and the chain at the
              group-all widths (259 and 643 inputs, N=128), each with its
              time, the plain version's and the bound.
4. slice      the headline attack: untargeted C&W on PointNet, f32, B=64,
              N=1024, 40 classes, kappa 30, budget 0.18, 1 x 200 Adam steps,
              seeded random weights with BatchNorm statistics taken from the
              clouds, on synthetic clouds labelled with the victim's own clean
              predictions (so every success comes from the gradient steps);
              the kernels must carry it (launch counts) and ASR must be above 0.
5. parity     a short attack (B=8, 1 x 10) on the card and on the CPU (the
              plain versions) from the same weights and noise must agree:
              success, best distance and the adversarial clouds.
6. profile    torch.profiler over 10 CW iterations at the headline shape:
              kernel time by name and the device's idle share.
7. slice-ssg  C&W 1 x 100 on PointNet++ SSG, B=16, N=1024, 40 classes, kappa
              30, budget 0.18, on the 16 clouds of bench.py's cw_ssg cell, with
              a victim made as in phase 4; launch counts of FPS, gather and
              chain kernels, ASR > 0, s/batch over 3 reps after a warm-up.
8. slice-msg  the same on PointNet++ MSG (bench.py's cw_msg clouds).
9. parity-ssg / parity-msg  card against CPU, the CPU's max pools taking
              the card's picks (``pick_hooks``): an SSG attack (B=4, 1 x 10)
              from the same weights and noise (success, best distance and
              adversarial clouds; then log-probs and the loss gradient cloud
              by cloud at each of the card's iterates); MSG log-probs and the
              CW-loss input gradient at B=2.
10. profile-ssg  torch.profiler over 10 SSG CW iterations.
11. kernels-knn  the self-kNN kernel bit for bit against its plain version
              at the four EdgeConv inputs of one forward of the DGCNN victim
              (B=16, N=1024, k=20, C=3/64/64/128), at a ragged N=1000 and
              with every point 4 times (ties); times beside the bound.
12. kernels-gather-dgcnn  the gather kernel at the four EdgeConv shapes (K=20,
              the center segment, one layer) under check_gather's rules, and
              each EdgeConv stage fused against the unfused plain layer.
13. kernels-chamfer  the row-min kernel bit for bit (mins, argmin, dx) at
              [64,1024,3] x [64,1024,3] and at a ragged 1000 x 1000 with every
              y point 4 times.
14. slice-knn  the KNN attack on PointNet at bench.py's knn settings (B=64,
              kappa 30, budget 0.18, lr 1e-2, 500 of its 2500 iterations),
              nn_refresh 1 and 5 (knn_r5), then 100 iterations on PointNet++
              SSG (the cw_ssg clouds): exact launch counts, ASR > 0, every point
              within the budget, s/batch over 3 reps after a warm-up.
15. parity-knn  KNN on PointNet (B=8, 10 iterations) on the card and on the
              CPU from the same weights and noise: success identical,
              adversarial clouds within 1e-5 but at a few points (at most
              PART_SHARE) that parted where a coordinate's gradient lay
              within rounding of 0.
16. slice-dgcnn  C&W 1 x 100 on DGCNN at bench.py's cw_dgcnn settings (B=16):
              exact launch counts (kNN 4 and gather 4 per forward, gather 4 per
              backward), ASR > 0, s/batch.
17. parity-dgcnn  DGCNN at B=2, card against CPU, the CPU taking the card's kNN
              indices and max-pool picks: log-probs and the CW-loss gradient.
18. profile-dgcnn  torch.profiler over 10 DGCNN CW iterations.
19. kernels-geoa3  the curvature (kappa) kernels and the two-direction Chamfer
              kernels against their plain versions on the CPU at GeoA3's shape
              (B=8, N=1024, k=16), at a ragged N=1000 and with exact duplicates;
              times beside the plain versions' and the bounds.
20. slice-geoa3  GeoA3 on PointNet at bench.py's geoa3 settings (B=8, CE, 10
              rounds, 100 of their 500 iterations): exact launch counts, ASR > 0,
              finite clouds, s/batch over 3 reps after a warm-up.
21. parity-geoa3  GeoA3 (B=4, 2 x 10) on the card and on the CPU from the same
              weights and start offsets, the CPU on the card's normals: success,
              the kept step and best_loss, the clouds at points that never parted,
              and the loss gradient at each of the card's iterates.
22. profile-geoa3  torch.profiler over 10 GeoA3 iterations.
23. kernels-curvenet  the grouped chain + max and chain + mean kernels against
              their plain versions at the nine LPFA shapes of one CurveNet
              forward (B=8, K=20, LeakyReLU 0.2), at a ragged G=1000, at K=7 and
              with 2-layer chains, each with its time, the plain version's and
              the bound; then each LPFA stage of the victim fused against the
              unfused plain layer, forward and forward + input backward.
24. slice-curvenet  C&W 1 x 100 on CurveNet at bench.py's cw_curvenet settings
              (B=8, published widths): exact launch counts (kNN 9, FPS 2, group
              max 1 and group mean 8 per forward, 1 + 8 per backward), ASR > 0,
              every point within the budget, s/batch.
25. parity-curvenet  C&W (B=2, 1 x 10) on the card and on the CPU, the CPU
              taking the card's discrete choices and activation signs
              (``curvenet_hooks``: the walk's starts and picks, the group-max,
              masked max-pool and head picks, the side of 0 of every
              activation's input): success, and the logits and the loss
              gradient at each of the card's iterates; how many choices lay
              near a tie, how many signs differ, and the gradient without
              the signs replayed.
26. profile-curvenet  torch.profiler over 10 CurveNet C&W iterations.
27. slice-geoa3-curvenet  GeoA3 on CurveNet (BASELINE config 4) on bench.py's
              geoa3 clouds, CE on the log-softmax of the logits, 2 rounds of 50
              of their 500 iterations: exact launch counts, ASR > 0, s/batch.
Each of phases 11-27 prints its seconds.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel record.  The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SRC = "pointcloudattack_tpu_torch/csrc/chain_maxpool.cu"
FPS_SRC = "pointcloudattack_tpu_torch/csrc/fps.cu"
GATHER_SRC = "pointcloudattack_tpu_torch/csrc/gather_chain.cu"
TPU_FWD = "pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:188"
TPU_BWD = "pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:216"
TPU_FPS = "pointcloudattack_tpu/ops/pallas/fps_kernel.py:79"
TPU_GATHER_FWD = "pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py:550"
TPU_GATHER_BWD = "pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py:641"
KNN_SRC = "pointcloudattack_tpu_torch/csrc/knn.cu"
CHAMFER_SRC = "pointcloudattack_tpu_torch/csrc/min_sqdist.cu"
TPU_KNN = "pointcloudattack_tpu/ops/pallas/knn_kernel.py:111"
TPU_CHAMFER = "pointcloudattack_tpu/ops/pallas/chamfer_kernel.py:103"
KAPPA_SRC = "pointcloudattack_tpu_torch/csrc/kappa.cu"
BOTH_SRC = "pointcloudattack_tpu_torch/csrc/min_sqdist_both.cu"
TPU_KAPPA_FWD = "pointcloudattack_tpu/ops/pallas/kappa_kernel.py:321"
TPU_KAPPA_BWD = "pointcloudattack_tpu/ops/pallas/kappa_kernel.py:358"
TPU_BOTH_FWD = "pointcloudattack_tpu/ops/pallas/chamfer_kernel.py:205"
TPU_BOTH_BWD = "pointcloudattack_tpu/ops/pallas/chamfer_kernel.py:236"
GROUP_SRC = "pointcloudattack_tpu_torch/csrc/group_chain.cu"
TPU_GROUP_FWD = "pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:439"
TPU_GROUP_MEAN_FWD = "pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:470"
TPU_GROUP_BWD = "pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:522"

B, N, NUM_CLASSES = 64, 1024, 40
SPINE = (3, 64, 128, 1024)
BINARY_STEP, NUM_ITER, KAPPA, BUDGET = 1, 200, 30.0, 0.18
Y_TOL = dict(rtol=1e-5, atol=1e-4)  # 128-term f32 sums in another order
DX_TOL = dict(rtol=1e-4, atol=1e-4)
EDGE = 1e-5  # a hidden unit this close to 0 may take either side of its ReLU
# PointNet++ card against CPU, the CPU taking the card's max-pool picks:
# log-probs, and for each step and cloud the loss gradient's relative L2
# difference.  Most pairs agree to rounding (about 7e-7), but 35-50% of an
# SSG attack's (step, cloud) pairs differ by 1e-5 to 1.3e-2 (two runs of
# this script on an H100), as a hidden unit of a winning row within rounding
# of 0, whose ReLU opens on one side only, would make them.  So every pair
# is held within GRAD_REL, which a gather backward that dropped or negated
# dctr, or dropped dsrc, exceeds 5 times over, and at least CLEAN_SHARE of an
# attack's pairs within GRAD_CLEAN, which a fault on every step cannot meet
# however small (tests/test_torch_pointnet2.py).  A pair whose two best
# non-target log-probs (or the target's and the best other's) lie within
# LOGP_ATOL may follow another class on either side: it is named, left out.
LOGP_ATOL, GRAD_REL, GRAD_CLEAN, CLEAN_SHARE = 1e-4, 5e-2, 1e-5, 0.25
PICK_ATOL = Y_TOL["atol"]  # a card pick lies at most this far below the CPU's max
PART_ATOL = 1e-5  # a cloud's card and CPU iterates further apart than this have parted
# KNN on PointNet, card against CPU: at most PART_SHARE of the points may
# part, each where one of its coordinates' gradient lay within TINY_GRAD of
# 0, relative to its cloud's largest |gradient| (1 of 8192 parted on an
# H100, at 6.8e-8 of its cloud's largest)
PART_SHARE, TINY_GRAD = 1e-3, 1e-5
GRAD_APART = 1e-3  # a coordinate's two gradients this far apart, relative, move Adam's steps PART_ATOL apart

# PointNet++: bench.py's cw_ssg / cw_msg cells (8 classes x 2 clouds)
PN2_B, PN2_ITER = 16, 100
PN2_DATA = {"PointNet++Ssg": 6, "PointNet++Msg": 12}  # make_synthetic_clouds seeds
# kernel launches per forward and per backward on each path
PN2_LAUNCHES = {
    "PointNet++Ssg": ({"fps": 2, "gather_fwd": 2, "chain_fwd": 1}, {"gather_bwd": 2, "chain_bwd": 1}),
    "PointNet++Msg": ({"fps": 2, "gather_fwd": 6, "chain_fwd": 1}, {"gather_bwd": 6, "chain_bwd": 1}),
}
# (n, npoint, radius, K, feature width, layout, chain widths) at B=16: every
# gather call of the two paths; the SSG ones make up one SSG forward
GATHER_SHAPES = {
    "ssg_sa1": (1024, 512, 0.2, 32, 0, "ssg", (64, 64, 128)),
    "ssg_sa2": (512, 128, 0.4, 64, 128, "ssg", (128, 128, 256)),
    "msg_sa1_k16": (1024, 512, 0.1, 16, 0, "msg", (32, 32, 64)),
    "msg_sa1_k32": (1024, 512, 0.2, 32, 0, "msg", (64, 64, 128)),
    "msg_sa1_k128": (1024, 512, 0.4, 128, 0, "msg", (64, 96, 128)),
    "msg_sa2_k32": (512, 128, 0.2, 32, 320, "msg", (64, 64, 128)),
    "msg_sa2_k64": (512, 128, 0.4, 64, 320, "msg", (128, 128, 256)),
    "msg_sa2_k128": (512, 128, 0.8, 128, 320, "msg", (128, 128, 256)),
}
# The KNN attack: bench.py's knn / knn_r5 cells (bench.py:412-451), the
# first 64 of make_synthetic_clouds(40, 2, 1024, seed=4), num_iter cut from
# 2500 to 500; then 100 iterations on PointNet++ SSG (the cw_ssg clouds)
KNN_DATA, KNN_ITER, KNN_LR, KNN_SSG_ITER = 4, 500, 1e-2, 100
# C&W on DGCNN: bench.py's cw_dgcnn cell (bench.py:215-269), B=16,
# make_synthetic_clouds(8, 2, 1024, seed=3), 1 x 100, k=20
DG_DATA, DG_ITER, DG_K = 3, 100, 20
# DGCNN's four EdgeConv stages at B=16, N=1024, k=20, in the same format:
# src = centers = the stage input (xyz, or seeded features of that width),
# idx its self-kNN, layout (diff, center)
DGCNN_GATHER_SHAPES = {
    "dgcnn_conv1": (1024, 1024, None, 20, 0, "dgcnn", (64,)),
    "dgcnn_conv2": (1024, 1024, None, 20, 64, "dgcnn", (64,)),
    "dgcnn_conv3": (1024, 1024, None, 20, 64, "dgcnn", (128,)),
    "dgcnn_conv4": (1024, 1024, None, 20, 128, "dgcnn", (256,)),
}
# GeoA3: bench.py's geoa3 cell (bench.py:454-496), PointNet, B=8,
# make_synthetic_clouds(8, 1, 1024, seed=5), CE loss, Chamfer + 0.1 Hausdorff
# + curvature (k=16), 10 binary rounds of 500 iterations, cut to 100
GEO_DATA, GEO_ROUNDS, GEO_ITER, GEO_K = 5, 10, 100, 16
# the kernels against their plain versions: kappa rtol 1e-6, its gradients
# atol 1e-5, the two-direction bundle's gradients atol 1e-6 (all designed to
# be bit-equal to the plain version on the CPU; the log says whether they are)
KAPPA_RTOL, KAPPA_GRAD_ATOL, BOTH_GRAD_ATOL = 1e-6, 1e-5, 1e-6
# GeoA3 card against CPU: once a point has parted, the curvature term and the
# victim's pooled features carry the difference to other points
# (``round_partings``), so a share of the points, not a few, may part; at
# least GEO_HELD_SHARE of them must never part (on the CPU against the JAX
# package 0.68 or more, tests/test_torch_geoa3.py)
GEO_HELD_SHARE = 0.5
# CurveNet: bench.py's cw_curvenet cell (bench.py:372-378), B=8,
# make_synthetic_clouds(8, 1, 1024, seed=9), C&W 1 x 100, published widths
# (k=20, the default curves, 40 classes); GeoA3 on it (BASELINE config 4) on
# bench.py's geoa3 clouds, 2 rounds of 50 iterations cut from 10 x 500
CN_DATA, CN_ITER, CN_B, CN_K, CN_SLOPE = 9, 100, 8, 20, 0.2
CN_GEO_ROUNDS, CN_GEO_ITER = 2, 50
# kernel launches per forward and per backward: kNN 9 (the initial LPFA and
# each CIC), FPS 2 (to 256 and 64 points), one group max (the initial LPFA)
# and 8 group means (the residual LPFAs)
CN_LAUNCHES = ({"knn": 9, "fps": 2, "group_max_fwd": 1, "group_mean_fwd": 8},
               {"group_max_bwd": 1, "group_mean_bwd": 8})
# the LPFAs of one CurveNet forward at B=8, K=20: (G, input width, chain widths, pool)
CURVENET_GROUP_SHAPES = {
    "lpfa": (1024, 9, (32,), "max"),
    "cic11": (1024, 16, (16,), "mean"), "cic12": (1024, 16, (16,), "mean"),
    "cic21": (1024, 32, (32,), "mean"), "cic22": (1024, 32, (32,), "mean"),
    "cic31": (256, 64, (64,), "mean"), "cic32": (256, 64, (64,), "mean"),
    "cic41": (64, 128, (128,), "mean"), "cic42": (64, 128, (128,), "mean"),
}
FPS_SHAPES = ((1024, 512), (512, 128))  # (N, npoint) of SSG's (and MSG's) two SAs
GROUP_ALL = {"ssg_sa3": (259, 256, 512, 1024), "msg_sa3": (643, 256, 512, 1024)}

# The least time the card could take: NVIDIA's H100 SXM data sheet, FP32
# outside the tensor cores (the kernels run f32 FMAs) and HBM3 bandwidth.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chain_flops(rows: int, dims) -> float:
    return 2.0 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def chain_bwd_flops(win: int, pools: int, dims) -> float:
    """The backward's least work: the sparse expansion (one row of W_L per
    pooled column), and the hidden layers' recompute (their masks) and the
    products back to the input, both only for the ``win`` rows that win a
    pooled column: every other row's cotangent is 0."""
    return 2 * chain_flops(win, dims[:-1]) + 2.0 * pools * dims[-1] * dims[-2]


def winners(am, rows: int):
    """``[..., rows]`` bool: the rows that win some pooled column, where
    ``am [..., C]`` holds each column's winning row."""
    import torch

    hit = torch.zeros(am.shape[:-1] + (rows,), dtype=torch.bool, device=am.device)
    return hit.scatter_(-1, am.long(), True)


def param_bytes(dims) -> float:
    return 4.0 * sum(a * b + 4 * b for a, b in zip(dims[:-1], dims[1:]))


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
    sources = [str(s) for s in _build._sources() if s.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", f"{tmp}/lib.so", *sources],
                       check=True, capture_output=True, timeout=900)
        log(f"[build] the same {len(sources)} sources in one nvcc call: {time.perf_counter() - t0:.2f} s")


def seeded_layers(rng, dims, device):
    import numpy as np
    import torch

    layers = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        arrs = (
            rng.randn(cin, cout) / np.sqrt(cin), rng.randn(cout) * 0.1,
            rng.randn(cout) * 0.05, rng.rand(cout) + 0.5, rng.randn(cout) * 0.1,
        )
        layers.append(tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs))
    return layers


def seeded_chain(seed, b, n, dims, device):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, n, dims[0]).astype(np.float32)).to(device)
    layers = seeded_layers(rng, dims, device)
    dy = torch.from_numpy(rng.randn(b, dims[-1]).astype(np.float32)).to(device)
    return x, layers, dy


def top2_gap(x, layers):
    import torch

    z = x
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        if i:
            z = torch.relu(z)
        z = (z @ w + b - mean) * mul + beta
    return top2_margin(z, 1)


def top2_margin(x, dim):
    """The gap between the largest and the second largest along ``dim``."""
    top = x.detach().topk(2, dim=dim).values
    return top.select(dim, 0) - top.select(dim, 1)


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


def time_pairs(fns: dict, reps=20):
    """Mean ms of each ``fns`` entry over two turns in opposite orders
    (plain, kernel, kernel, plain), within this one call."""
    t = {k: [] for k in fns}
    for order in (list(fns), list(reversed(list(fns)))):
        for k in order:
            t[k].append(time_ms(fns[k], reps=reps))
    return {k: sum(v) / len(v) for k, v in t.items()}


def check_chain(cm, b, n, seed, dims=SPINE):
    """Kernel against plain at one shape; returns (max |dy|, max |ddx|)."""
    import torch

    x, layers, dy = seeded_chain(seed, b, n, dims, "cuda")
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
    win = int(winners(idx_ref, n).sum())
    log(f"[kernels] B={b} N={n} chain {dims}: y max|err| {err_y:.3e}; idx equal except "
        f"{int((idx != idx_ref).sum())} of {int(near.sum())} near-tie columns "
        f"(top-2 gap <= {Y_TOL['atol']}); dx max|err| {err_dx:.3e}; {win} of {b * n} rows win a column")
    return err_y, err_dx, (x, layers, idx_ref, g, win)


def chain_bound(b, n, dims, win=None):
    """(bound_ms, bound_by) of the forward, or with ``win`` winning rows, of
    the backward."""
    if win is not None:
        flops = chain_bwd_flops(win, b, dims)
        nbytes = 4.0 * (2 * b * n * dims[0] + 2 * b * dims[-1]) + 2 * param_bytes(dims)
    else:
        flops = chain_flops(b * n, dims)
        nbytes = 4.0 * (b * n * dims[0] + 2 * b * dims[-1]) + param_bytes(dims)
    return bound(flops, nbytes)


def phase_kernels():
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm

    err_y, err_dx, (x, layers, idx, g, win) = check_chain(cm, B, N, seed=0)
    check_chain(cm, 8, 1000, seed=1)  # ragged tail: 1000 is no multiple of the row tile

    # W^T made once, as the autograd path takes it from the module's weight
    wts = [layer[0].t().contiguous() for layer in layers]
    ms = time_pairs({
        "fwd_plain": lambda: cm.chain_maxpool_plain(x, layers),
        "fwd": lambda: cm.chain_maxpool_fwd(x, layers),
        "bwd_plain": lambda: cm.chain_maxpool_bwd_plain(x, layers, idx, g),
        "bwd": lambda: cm.chain_maxpool_bwd(x, layers, idx, g, wts),
    })
    flops, flops_bwd = chain_flops(B * N, SPINE), chain_bwd_flops(win, B, SPINE)
    bf, bb = chain_bound(B, N, SPINE), chain_bound(B, N, SPINE, win)
    log(f"[kernels] B={B} N={N}: forward kernel {ms['fwd']:.4f} ms, plain {ms['fwd_plain']:.4f} ms "
        f"(kernel {flops / ms['fwd'] / 1e9:.2f} TFLOP/s f32; {flops / 1e9:.3f} GFLOP, bound {bf[0]:.4f} ms "
        f"by {bf[1]}); backward kernel {ms['bwd']:.4f} ms, plain {ms['bwd_plain']:.4f} ms "
        f"({flops_bwd / 1e9:.3f} GFLOP over the {win} winning rows, bound {bb[0]:.4f} ms by {bb[1]})")
    return {"err_y": err_y, "err_dx": err_dx, **ms, "rows_fwd": B * N, "rows_bwd": win,
            "bound_fwd": bf, "bound_bwd": bb}


def gather_case(seed, n, npoint, radius, k, feat, kind, widths):
    """src, centers and idx as a set abstraction makes them on the card
    (FPS, then the ball query, whose short balls repeat their first index),
    or as an EdgeConv does (``kind`` "dgcnn"), with seeded layers and
    cotangent."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
    from pointcloudattack_tpu_torch.ops.fps import farthest_point_sample
    from pointcloudattack_tpu_torch.ops.gather import index_points
    from pointcloudattack_tpu_torch.ops.gather_chain import layout_width
    from pointcloudattack_tpu_torch.ops.knn import knn

    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy((rng.randn(PN2_B, n, 3) * 0.5).astype(np.float32)).cuda()
    if kind == "dgcnn":  # an EdgeConv: centers are the source rows, idx their kNN
        src = torch.from_numpy(rng.randn(PN2_B, n, feat).astype(np.float32)).cuda() if feat else xyz
        c = src.shape[-1]
        new_xyz, idx, layout = src, knn(src, k), (("diff", 0, c, 0), ("center", 0, c))
        layers = seeded_layers(rng, (2 * c, *widths), "cuda")
        dy = torch.from_numpy(rng.randn(PN2_B, npoint, widths[-1]).astype(np.float32)).cuda()
        return src, new_xyz, idx, layers, layout, dy
    new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint)).contiguous()
    idx = query_ball_point(radius, k, xyz, new_xyz)
    if feat:
        src = torch.cat([xyz, torch.from_numpy(rng.randn(PN2_B, n, feat).astype(np.float32)).cuda()], -1)
        c = src.shape[-1]
        layout = (("diff", 0, 3, 0), ("pass", 3, c)) if kind == "ssg" else (("pass", 3, c), ("diff", 0, 3, 0))
    else:
        src, layout = xyz, (("diff", 0, 3, 0),)
    layers = seeded_layers(rng, (layout_width(layout), *widths), "cuda")
    dy = torch.from_numpy(rng.randn(PN2_B, npoint, widths[-1]).astype(np.float32)).cuda()
    return src, new_xyz, idx, layers, layout, dy


def check_gather(name, src, ctr, idx, layers, layout, dy):
    """Gather kernel against plain on one case; returns (errors, am_ref, g,
    winning rows)."""
    import torch

    from pointcloudattack_tpu_torch.ops import gather_chain as gc

    y, am = gc.gather_chain_fwd(src, ctr, idx, layers, layout)
    y_ref, am_ref = gc.gather_chain_plain(src, ctr, idx, layers, layout)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    z, _ = gc._chain(gc.gather_rows(src, ctr, idx, layout), layers)
    top = z.topk(2, dim=2).values
    near = (top[:, :, 0] - top[:, :, 1]) <= Y_TOL["atol"]
    wrong = (am != am_ref) & ~near
    if int(wrong.sum()):
        raise AssertionError(f"{name}: argmax differs in {int(wrong.sum())} columns with a clear winner")
    del z, top
    g = (dy * layers[-1][3]).contiguous()
    dsrc, dctr = gc.gather_chain_bwd(src, ctr, idx, layers, layout, am_ref, g)
    dsrc_ref, dctr_ref = gc.gather_chain_bwd_plain(src, ctr, idx, layers, layout, am_ref, g)
    torch.cuda.synchronize()
    # A winning row (the only rows with a cotangent) whose hidden
    # pre-activation lies within EDGE of 0 may fall on the other side of a
    # ReLU on either side (sums in another order): the points it gathered
    # (dsrc) and its group (dctr) are left out, and counted.
    b, n = src.shape[:2]
    win = winners(am_ref, idx.shape[2])
    edge = torch.zeros_like(win)
    h, z = gc.gather_rows(src, ctr, idx, layout), None  # one layer (DGCNN) has no hidden unit
    for w, b_, mean, mul, beta in layers[:-1]:
        z = (h @ w + b_ - mean) * mul + beta
        edge |= (z.abs() <= EDGE).any(-1)
        h = torch.relu(z)
    del h, z
    edge &= win
    pts = torch.zeros(b * n, dtype=torch.bool, device=idx.device)
    pts[(idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n)[edge]] = True
    pts, grp = pts.view(b, n), edge.any(-1)
    torch.testing.assert_close(dsrc[~pts], dsrc_ref[~pts], **DX_TOL)
    torch.testing.assert_close(dctr[~grp], dctr_ref[~grp], **DX_TOL)
    if not float(dctr_ref.abs().max()) > 0:
        raise AssertionError(f"{name}: dctr is 0 everywhere, so its check sees nothing")
    errs = {"y": float((y - y_ref).abs().max()), "dsrc": float((dsrc - dsrc_ref)[~pts].abs().max()),
            "dctr": float((dctr - dctr_ref)[~grp].abs().max())}
    off_tol = lambda a, r: int((~torch.isclose(a, r, **DX_TOL)).any(-1).sum())
    log(f"[kernels] gather {name}: src {tuple(src.shape)} G={idx.shape[1]} K={idx.shape[2]}: y max|err| "
        f"{errs['y']:.3e}, argmax equal except {int((am != am_ref).sum())} of {int(near.sum())} near-tie "
        f"columns; {int(win.sum())} of {win.numel()} rows win a column, {int(edge.sum())} of them hold a "
        f"hidden unit within {EDGE} of 0; dsrc and dctr held on the other {1 - float(pts.float().mean()):.4f} "
        f"of the points and {1 - float(grp.float().mean()):.4f} of the groups: max|err| {errs['dsrc']:.3e} "
        f"and {errs['dctr']:.3e}; beyond the tolerance, all among those left out: {off_tol(dsrc, dsrc_ref)} "
        f"points, {off_tol(dctr, dctr_ref)} groups (all-element max|err| "
        f"{float((dsrc - dsrc_ref).abs().max()):.3e} and {float((dctr - dctr_ref).abs().max()):.3e})")
    return errs, am_ref, g, int(win.sum())


def gather_fwd_flops(n, b, ng, k, layout, dims) -> float:
    """The gather forward's least work.  Its first layer is affine in the
    gathered row, and each segment of the row is a slice of one source
    point's features ("pass"), of one center's ("center"), or the
    difference of the two ("diff"), so W·row = P[j] + Q[i] with
    P = W_src·src over the n source points and Q = W_ctr·ctr over the ng
    centers: products a point, then one add a row and unit to join them.
    With one layer (DGCNN) that add leaves the max (max_j P[j] + Q[i]), and
    the row pays one compare a unit instead.  The later layers cost the
    full chain on every row."""
    src_w = sum(s[2] - s[1] for s in layout if s[0] in ("diff", "pass"))
    ctr_w = sum(s[2] - s[1] for s in layout if s[0] in ("diff", "center"))
    rows = b * ng * k
    return 2.0 * b * dims[1] * (n * src_w + ng * ctr_w) + rows * dims[1] + chain_flops(rows, dims[1:])


def time_gather(name, widths, src, ctr, idx, layers, layout, am, g, win):
    """Gather kernel and plain times at one case, and the bounds."""
    from pointcloudattack_tpu_torch.ops import gather_chain as gc

    wts = [layer[0].t().contiguous() for layer in layers]
    ms = time_pairs({
        "fwd_plain": lambda: gc.gather_chain_plain(src, ctr, idx, layers, layout),
        "fwd": lambda: gc.gather_chain_fwd(src, ctr, idx, layers, layout),
        "bwd_plain": lambda: gc.gather_chain_bwd_plain(src, ctr, idx, layers, layout, am, g),
        "bwd": lambda: gc.gather_chain_bwd(src, ctr, idx, layers, layout, am, g, wts),
    })
    b, ng, k = idx.shape
    dims = (gc.layout_width(layout), *widths)
    io = 4.0 * (src.numel() + ctr.numel() + idx.numel())
    pools = 4.0 * b * ng * dims[-1]
    b_fwd = bound(gather_fwd_flops(src.shape[1], b, ng, k, layout, dims), io + param_bytes(dims) + 2 * pools)
    b_bwd = bound(chain_bwd_flops(win, b * ng, dims),
                  io + 2 * param_bytes(dims) + 2 * pools + 4.0 * (src.numel() + ctr.numel()))
    log(f"[kernels] gather {name} chain {dims}: forward {ms['fwd']:.4f} ms (plain {ms['fwd_plain']:.4f}, "
        f"bound {b_fwd[0]:.4f} by {b_fwd[1]} over {b * ng * k} rows), backward {ms['bwd']:.4f} ms (plain "
        f"{ms['bwd_plain']:.4f}, bound {b_bwd[0]:.4f} by {b_bwd[1]} over the {win} winning rows)")
    return ms, b_fwd, b_bwd


def knn_bound(b, n, c, k):
    """(bound_ms, bound_by) of one self-kNN: 2C + 2 operations a pair for
    the distance (C products and C - 1 sums of xy, the doubling, the
    subtraction and the sum), 2C a point for the norms, one compare a pair
    for the selection (against the row's running k-th distance) and
    k log2(k) a row to order the k kept; x read once, the indices written
    once.  This kernel's own selection makes k passes over a row, which the
    bound does not charge: it is the cost of the design, not of the
    function."""
    flops = b * n * n * (2.0 * c + 3) + 2.0 * b * n * c + b * n * k * math.log2(k)
    return bound(flops, 4.0 * (b * n * c + b * n * k))


def chamfer_bound(b, n, m):
    """(bound_ms, bound_by) of one row min: 8 operations a pair (3
    subtractions, 3 products, 2 sums); x and y read once, mins and argmin
    written once."""
    return bound(8.0 * b * n * m, 4.0 * (3 * b * n + 3 * b * m + 2 * b * n))


def check_knn(tag, name, x, k):
    """The kNN kernel against plain on one input: the indices bit-equal.
    Returns the measured max |index difference|."""
    import torch

    from pointcloudattack_tpu_torch.ops import knn as knn_mod

    got = knn_mod.knn(x, k)
    want = knn_mod.knn_plain(x, k)
    torch.cuda.synchronize()
    err = float((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        bad = (got != want).any(-1)
        raise AssertionError(f"knn {name}: the kernel differs from plain in {int(bad.sum())} of {bad.numel()} rows")
    rows = torch.arange(x.shape[1], device=x.device, dtype=torch.int32)
    log(f"[{tag}] {name} {tuple(x.shape)} k={k}: indices bit-equal to the plain version (max |diff| "
        f"{err:.1f}); the point itself is neighbour 0 in {float((got[..., 0] == rows).float().mean()):.4f} "
        f"of the rows")
    return err


def check_chamfer(tag, name, x, y, w):
    """The row-min kernel against plain on one input: mins and argmin
    bit-equal, and ``dx`` of ``sum(mins * w)`` through autograd (the
    kernel's Function against autograd through the plain version's dense
    ``amin``) bit-equal on rows with one nearest point; where several tie
    (duplicated y points), ``amin`` splits the gradient among them, whose
    sum may round: atol 1e-6 there.  Returns the measured max |diff| over
    mins, argmin and dx."""
    import torch

    from pointcloudattack_tpu_torch.ops import chamfer

    xk = x.clone().requires_grad_(True)
    mins, arg = chamfer.min_sqdist_rows(xk, y)
    (dx,) = torch.autograd.grad((mins * w).sum(), xk)
    xp = x.clone().requires_grad_(True)
    mins_p, arg_p = chamfer.min_rows_plain(xp, y)
    (dx_p,) = torch.autograd.grad((mins_p * w).sum(), xp)
    torch.cuda.synchronize()
    err = max(float((mins - mins_p).detach().abs().max()), float((arg.long() - arg_p.long()).abs().max()),
              float((dx - dx_p).abs().max()))
    if not (torch.equal(mins, mins_p.detach()) and torch.equal(arg, arg_p)):
        raise AssertionError(f"min_sqdist_rows {name}: mins differ in {int((mins != mins_p).sum())} rows, "
                             f"argmin in {int((arg != arg_p).sum())}")
    with torch.no_grad():
        d = None
        for c in range(3):
            diff = x[..., :, None, c] - y[..., None, :, c]
            d = diff * diff if d is None else d + diff * diff
        tied = (d == mins[..., None]).sum(-1) > 1
        del d, diff
    if not torch.equal(dx[~tied], dx_p[~tied]):
        raise AssertionError(f"min_sqdist_rows {name}: dx differs on rows with one nearest point")
    torch.testing.assert_close(dx[tied], dx_p[tied], rtol=0.0, atol=1e-6)
    log(f"[{tag}] {name} x {tuple(x.shape)} y {tuple(y.shape)}: mins and argmin bit-equal to the plain "
        f"version, dx bit-equal on the {int((~tied).sum())} rows with one nearest point (max|diff| "
        f"{float((dx - dx_p).abs().max()):.3e} over all, {int(tied.sum())} rows tie); max |diff| over "
        f"mins, argmin and dx {err:.3e}")
    return err


def new_record(*keys):
    """Per-kernel sums of errors, times and bounds over several shapes."""
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}, "rows": 0} for k in keys}


def accumulate(r, ms, plain_ms, bnd, rows=0):
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bound_ms"] += bnd[0]
    r["bound_by"][bnd[1]] = r["bound_by"].get(bnd[1], 0.0) + bnd[0]
    r["rows"] += rows


def summed_bound(r):
    """(bound_ms, bound_by) of a summed record: the larger share names it."""
    return (r["bound_ms"], max(r["bound_by"], key=r["bound_by"].get))


def phase_kernels_pn2():
    """The PointNet++ path's kernels at its shapes; the record's numbers sum
    the shapes of one SSG forward (and backward)."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import fps as fps_mod

    rec = new_record("fps", "gather_fwd", "gather_bwd")
    for n, npoint in FPS_SHAPES:
        xyz = torch.from_numpy((np.random.RandomState(n).randn(PN2_B, n, 3) * 0.5).astype(np.float32)).cuda()
        start = torch.zeros(PN2_B, dtype=torch.int32, device="cuda")
        got = fps_mod.farthest_point_sample(xyz, npoint)
        want = fps_mod.fps_plain(xyz, npoint, start)
        dup = torch.cat([xyz[:, : n // 4]] * 4, dim=1).contiguous()  # every pick ties with its copies
        dup_got = fps_mod.farthest_point_sample(dup, npoint)
        dup_want = fps_mod.fps_plain(dup, npoint, start)
        rec["fps"]["err"] = max(rec["fps"]["err"], float((got.long() - want.long()).abs().max()),
                                float((dup_got.long() - dup_want.long()).abs().max()))
        if not (torch.equal(got, want) and torch.equal(dup_got, dup_want)):
            raise AssertionError(f"FPS kernel differs from the plain version at N={n} npoint={npoint}")
        ms = time_pairs({"plain": lambda: fps_mod.fps_plain(xyz, npoint, start),
                         "kernel": lambda: fps_mod.farthest_point_sample(xyz, npoint)}, reps=10)
        flops = 10.0 * PN2_B * (npoint - 1) * n  # 3 sub, 3 mul, 2 add, min, compare
        t, by = bound(flops, 4.0 * (xyz.numel() + PN2_B + PN2_B * npoint))
        accumulate(rec["fps"], ms["kernel"], ms["plain"], (t, by))
        log(f"[kernels] fps [{PN2_B},{n},3] -> {npoint}: bit-equal to the plain version (also with "
            f"every point 4 times); kernel {ms['kernel']:.4f} ms ({ms['kernel'] * 1e3 / npoint:.3f} us "
            f"per step), plain {ms['plain']:.4f} ms, bound {t:.5f} ms by {by}")
    for i, (name, shape) in enumerate(GATHER_SHAPES.items()):
        case = gather_case(20 + i, *shape)
        errs, am, g, win = check_gather(name, *case)
        ms, b_fwd, b_bwd = time_gather(name, shape[6], *case[:5], am, g, win)
        b, ng, k = case[2].shape
        for key, e, m, p, bb, rows in (
            ("gather_fwd", errs["y"], ms["fwd"], ms["fwd_plain"], b_fwd, b * ng * k),
            ("gather_bwd", max(errs["dsrc"], errs["dctr"]), ms["bwd"], ms["bwd_plain"], b_bwd, win),
        ):
            rec[key]["err"] = max(rec[key]["err"], e)
            if name.startswith("ssg"):  # one SSG forward / backward
                accumulate(rec[key], m, p, bb, rows)
        del case, am, g
        torch.cuda.empty_cache()
    for i, (name, dims) in enumerate(GROUP_ALL.items()):
        err_y, err_dx, (x, layers, idx, g, win) = check_chain(cm, PN2_B, 128, seed=30 + i, dims=dims)
        wts = [layer[0].t().contiguous() for layer in layers]
        ms = time_pairs({
            "fwd_plain": lambda: cm.chain_maxpool_plain(x, layers),
            "fwd": lambda: cm.chain_maxpool_fwd(x, layers),
            "bwd_plain": lambda: cm.chain_maxpool_bwd_plain(x, layers, idx, g),
            "bwd": lambda: cm.chain_maxpool_bwd(x, layers, idx, g, wts),
        })
        bf, bb = chain_bound(PN2_B, 128, dims), chain_bound(PN2_B, 128, dims, win)
        log(f"[kernels] chain {name} [{PN2_B},128,{dims[0]}] {dims}: forward {ms['fwd']:.4f} ms (plain "
            f"{ms['fwd_plain']:.4f}, bound {bf[0]:.4f} by {bf[1]}), backward {ms['bwd']:.4f} ms (plain "
            f"{ms['bwd_plain']:.4f}, bound {bb[0]:.4f} by {bb[1]} over the {win} winning rows)")
    return rec


# BatchNorm updates in one forward, by model and module name, where not 1:
# CurveNet's walk runs its agent_mlp at each of its 5 steps and its
# momentum_mlp at each step after the first (the shared weights of the
# reference's walk.py)
BN_PASSES = {"CurveNet": {"walk.agent_mlp": 5, "walk.momentum_mlp": 4}}


def bn_passes(model_name, module_name):
    """How many times one forward of ``model_name`` updates the BatchNorm
    at ``module_name`` in train mode."""
    for part, n in BN_PASSES.get(model_name, {}).items():
        if part in module_name:
            return n
    return 1


def make_victim(name, device, clouds, drops):
    """``name`` with seeded random weights and the BatchNorm statistics of
    ``clouds`` (one train-mode pass at momentum 1): ``(model_fn, state)``.

    At its initial BatchNorm statistics a random victim gives every cloud
    nearly the same logits, and the attack moves none of them; with the
    statistics of the data its logits follow the input.  A BatchNorm that
    one forward updates several times (``bn_passes``) keeps the statistics
    of its last update.
    """
    import torch
    from torch import nn

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    model = models.make_model(name, NUM_CLASSES, generator=torch.Generator().manual_seed(0))
    model.to(device).train()
    for d in drops:
        getattr(model, d).eval()
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm1d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model(clouds)
    missed = [(n, int(m.num_batches_tracked)) for n, m in model.named_modules()
              if isinstance(m, nn.BatchNorm1d) and int(m.num_batches_tracked) != bn_passes(name, n)]
    if missed:
        raise AssertionError(f"{name}: the pass over the clouds missed the BatchNorms {missed} (name, updates)")
    log(f"[victim] {name}: all {len(bns)} BatchNorms took the statistics of the {len(clouds)} clouds")
    for m in bns:
        m.momentum = 0.1
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return make_model_fn(model, None, device), state


def synthetic_data(num_classes, per_class, seed, device):
    """``make_synthetic_clouds(num_classes, per_class, 1024, seed)`` and its
    labels, on ``device``."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.data.synthetic import make_synthetic_clouds

    clouds, labels = make_synthetic_clouds(num_classes, per_class, N, seed=seed)
    return torch.from_numpy(clouds).to(device), torch.from_numpy(labels.astype(np.int64)).to(device)


def victim_labels(model_fn, data, labels, tag="slice"):
    """The victim's clean predictions, the labels the attack must flip.
    With random weights the dataset labels say nothing: the victim misses
    nearly all of them, so against them the attack succeeds at step 0."""
    import torch

    with torch.no_grad():
        pred = model_fn(data).argmax(dim=-1)
    log(f"[{tag}] the victim agrees with the dataset labels on {int((pred == labels).sum())}"
        f"/{len(pred)} clouds; the attack is held to its clean predictions "
        f"({len(torch.unique(pred))} distinct classes)")
    return pred


def _counters():
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import chamfer
    from pointcloudattack_tpu_torch.ops import fps as fps_mod
    from pointcloudattack_tpu_torch.ops import gather_chain as gc
    from pointcloudattack_tpu_torch.ops import group_chain as gch
    from pointcloudattack_tpu_torch.ops import kappa
    from pointcloudattack_tpu_torch.ops import knn as knn_mod

    return {"fps": (fps_mod, "fps"), "gather_fwd": (gc, "fwd"), "gather_bwd": (gc, "bwd"),
            "chain_fwd": (cm, "fwd"), "chain_bwd": (cm, "bwd"), "knn": (knn_mod, "knn"),
            "min_rows": (chamfer, "min_rows"), "both_fwd": (chamfer, "both_fwd"), "both_bwd": (chamfer, "both_bwd"),
            "kappa_fwd": (kappa, "kappa_fwd"), "kappa_bwd": (kappa, "kappa_bwd"),
            **{k: (gch, k) for k in ("group_max_fwd", "group_max_bwd", "group_mean_fwd", "group_mean_bwd")}}


def reset_all():
    for mod, _ in _counters().values():
        mod.reset_launches()


def read_all():
    return {k: mod.LAUNCHES[key] for k, (mod, key) in _counters().items()}


def check_adv(tag, adv, data, succ, budget=BUDGET):
    """A finite adversarial batch of the input's shape, every point within
    ``budget`` (None: no budget), ASR > 0; returns (ASR, max per-point
    move)."""
    import torch

    if tuple(adv.shape) != tuple(data.shape) or not bool(torch.isfinite(adv).all()):
        raise AssertionError(f"{tag}: the adversarial clouds are not a finite tensor of the input's shape")
    moved = float((adv - data).norm(dim=-1).max())
    if budget is not None and moved > budget * (1 + 1e-5):
        raise AssertionError(f"{tag}: a point moved {moved} > budget {budget}")
    asr = float(succ.float().mean())
    if asr <= 0:
        raise AssertionError(f"{tag}: ASR is 0")
    return asr, moved


def per_path(iters, per_fwd, per_step):
    """Launches of an attack of ``iters`` steps: ``per_fwd`` per forward
    (``iters`` + 1: one per step, one final) and ``per_step`` per step."""
    return {k: per_fwd.get(k, 0) * (iters + 1) + per_step.get(k, 0) * iters for k in {*per_fwd, *per_step}}


def counted_and_timed(tag, what, attack, data, target, expect, check):
    """The counted main-path run (also the warm-up), whose launches must be
    ``expect`` (0 for a kernel it does not name), then ``check(result)``,
    then three fenced timed reps; returns the launch counts."""
    import torch

    gen = torch.Generator(device="cuda")
    b = data.shape[0]

    def run(seed):
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = attack(data, target, generator=gen)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    reset_all()
    res, t_warm = run(1)
    launches = read_all()
    want = {k: expect.get(k, 0) for k in launches}
    log(f"[{tag}] kernel launches during the attack: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != expected {want}")
    check(res)
    times = [run(2 + i)[1] for i in range(3)]
    tmin, tmean = min(times), sum(times) / len(times)
    log(f"[{tag}] {what} B={b} N={data.shape[1]}: warm-up {t_warm:.4f} s; "
        f"timed {[round(t, 6) for t in times]} s/batch; min {tmin:.6f} s "
        f"({b / tmin:.3f} clouds/s), mean {tmean:.6f} s ({b / tmean:.3f} clouds/s)")
    return launches


def run_attack(tag, model_fn, data, target, num_iter, per_fwd, per_bwd):
    """C&W 1 x ``num_iter``, counted and timed; returns the launch counts."""
    import torch

    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack

    cfg = CWPerturbConfig(binary_step=BINARY_STEP, num_iter=num_iter, kappa=KAPPA, budget=BUDGET)

    def check(res):
        succ = res.success
        asr, moved = check_adv(tag, res.best_attack, data, succ)
        if not bool(torch.isfinite(res.best_dist[succ]).all()):
            raise AssertionError("non-finite best_dist on a successful example")
        log(f"[{tag}] ASR {asr:.3f} ({int(succ.sum())}/{len(succ)}); max per-point move {moved:.4f}; "
            f"mean best L2 of successes {float(res.best_dist[succ].mean()):.5f}")

    return counted_and_timed(tag, f"CW {BINARY_STEP}x{num_iter}", build_cw_attack(model_fn, cfg), data, target,
                             per_path(BINARY_STEP * num_iter, per_fwd, per_bwd), check)


def run_knn(tag, model_fn, data, target, num_iter, nn_refresh, per_fwd, per_step):
    """The KNN attack (kappa 30, budget 0.18, lr 1e-2), counted and timed;
    returns the launch counts."""
    import torch

    from pointcloudattack_tpu_torch.attacks.knn import KNNAttackConfig, build_knn_attack
    from pointcloudattack_tpu_torch.losses.distance import chamfer_dist

    cfg = KNNAttackConfig(attack_lr=KNN_LR, num_iter=num_iter, kappa=KAPPA, budget=BUDGET, nn_refresh=nn_refresh)

    def check(res):
        adv, succ = res
        asr, moved = check_adv(tag, adv, data, succ)
        with torch.no_grad():
            cham = chamfer_dist(adv, data)
        log(f"[{tag}] ASR {asr:.3f} ({int(succ.sum())}/{len(succ)}); max per-point move {moved:.4f}; "
            f"mean adv->ori Chamfer {float(cham.mean()):.3e}")

    return counted_and_timed(tag, f"KNN {num_iter} iterations, nn_refresh {nn_refresh},",
                             build_knn_attack(model_fn, cfg), data, target, per_path(num_iter, per_fwd, per_step),
                             check)


def phase_slice(model_fn, data, target):
    launches = run_attack("slice", model_fn, data, target, NUM_ITER,
                          {"chain_fwd": 2}, {"chain_bwd": 2})
    return {"fwd": launches["chain_fwd"], "bwd": launches["chain_bwd"]}


TIE_GAP = 1e-5  # a choice whose two best candidates lie this close is counted as near a tie


@contextlib.contextmanager
def replay(hooks, take=None):
    """While open, the functions that ``hooks`` names (kind -> (module,
    attribute, on_card, on_cpu)) make their discrete choices on the card and
    take them on the CPU.  A call whose first argument lies on the card runs
    ``on_card(orig, *args) -> (result, choice)``, and the choice joins its
    kind's queue.  A call on the CPU takes the oldest queued choice of its
    kind (or ``take(kind)``, when given) and runs ``on_cpu(orig, choice,
    *args) -> (result, gap, off)``, where per choice (cloud first) ``gap``
    is how close the CPU's own choice came to a tie (None where none
    applies) and ``off`` how far the taken choice lies from the CPU's own
    (0 where they agree).  Yields ``stats``: kind -> {"calls", "choices",
    "near" (gap <= TIE_GAP), "exact" (gap 0), "min_gap" (the smallest
    nonzero), "other" (for each call, per cloud, the taken choices off the
    CPU's own), "off" (the largest)}.  A choice the card made and the CPU
    never took raises."""
    queues = {k: [] for k in hooks}
    stats = {k: {"calls": 0, "choices": 0, "near": 0, "exact": 0, "min_gap": float("inf"), "other": [],
                 "off": 0.0} for k in hooks}
    orig = {k: getattr(mod, name) for k, (mod, name, _, _) in hooks.items()}

    def note(st, gap, off):
        st["calls"] += 1
        st["choices"] += off.numel()
        st["other"].append((off > 0).reshape(off.shape[0], -1).sum(1))
        st["off"] = max(st["off"], float(off.max()) if off.numel() else 0.0)
        if gap is not None:
            st["near"] += int((gap <= TIE_GAP).sum())
            st["exact"] += int((gap == 0).sum())
            pos = gap[gap > 0]
            st["min_gap"] = min(st["min_gap"], float(pos.min()) if pos.numel() else float("inf"))

    def patched(kind, on_card, on_cpu):
        def fn(*args, **kw):
            if args[0].is_cuda:
                out, choice = on_card(orig[kind], *args, **kw)
                queues[kind].append(choice.cpu())
                return out
            choice = take(kind) if take else queues[kind].pop(0)
            out, gap, off = on_cpu(orig[kind], choice, *args, **kw)
            note(stats[kind], None if gap is None else gap.detach(), off.detach())
            return out
        return fn

    for k, (mod, name, on_card, on_cpu) in hooks.items():
        setattr(mod, name, patched(k, on_card, on_cpu))
    try:
        yield stats
    finally:
        for k, (mod, name, _, _) in hooks.items():
            setattr(mod, name, orig[k])
    left = {k: len(v) for k, v in queues.items() if v}
    if left:
        raise AssertionError(f"choices the card made and the CPU never took: {left}")


def pool_at(z, pick, axis):
    """A max pool of ``z`` over ``axis`` that takes the rows ``pick``, as
    ``replay``'s ``on_cpu`` returns it: ``((values, pick), gap, off)``."""
    y = z.gather(axis, pick.long().unsqueeze(axis)).squeeze(axis)
    return (y, pick), top2_margin(z, axis), z.detach().amax(axis) - y.detach()


def pick_hooks():
    """``replay`` hooks for the max pools of PointNet, PointNet++ and DGCNN:
    the chain + max ("chain") and the gather + chain + max ("gather")
    forwards, each choice every pooled column's winning row.  A column whose
    two best rows lie within f32 rounding otherwise may send its cotangent
    to another point on each side."""
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import gather_chain as gc

    def card(orig, *args):
        y, am = orig(*args)
        return (y, am), am

    def chain(orig, pick, x, layers):
        return pool_at(gc._chain(x.float(), layers)[0], pick, 1)

    def gather(orig, pick, src, centers, idx, layers, layout):
        return pool_at(gc._chain(gc.gather_rows(src, centers, idx, layout), layers)[0], pick, 2)

    return {"chain": (cm, "chain_maxpool_fwd", card, chain), "gather": (gc, "gather_chain_fwd", card, gather)}


def kernel_rows(x, layers, slope):
    """The group kernels' own pre-activations ``z [B, G, K, C]`` of a
    one-layer chain over ``x [B, G, K, C0]``: the max kernel over groups of
    one row, whose pass over a row is the mean kernel's."""
    import torch

    from pointcloudattack_tpu_torch.ops import group_chain as gch

    if len(layers) != 1:
        raise ValueError(f"kernel_rows reads one layer's pre-activations, got {len(layers)} layers")
    b, g, k, c0 = x.shape
    with torch.no_grad():
        z, _ = gch._fwd_kernel(x.detach().reshape(b, g * k, 1, c0).contiguous(),
                               [tuple(t.detach() for t in layer) for layer in layers], slope, mean=False)
    return z.reshape(b, g, k, -1)


def curvenet_hooks(signs=True):
    """``replay`` hooks for CurveNet's discrete choices: the walk's picks
    ("pick", ``hard_pick``: [B, curves] indices), the curve starts
    ("starts"), the masked max pools' and the head's max ("max",
    ``max_pool``: a bool mask of the winning rows, the CPU taking their max
    with its gradient split evenly among them, as ``amax``'s is among ties)
    and the initial LPFA's group max ("group": the argmax rows).  A walk
    pick, start or max-pool pick whose two best candidates lie within f32
    rounding may otherwise go another way on each side, and a walk that
    steps elsewhere changes every later feature.  With ``signs``, also the
    slope each activation takes: the signs of every LeakyReLU's and ReLU's
    input ("sign", ``leaky_relu``) and of the residual LPFAs' in-kernel
    activation's ("mean", ``mlp_chain_groupmean``, read on the card from the
    kernel's own pre-activations, ``kernel_rows``, which must give the
    kernel's mean bit for bit).  A unit within rounding of 0 otherwise takes
    slope 1 on one side and the other slope on the other."""
    import torch

    from pointcloudattack_tpu_torch.models import curvenet as cn
    from pointcloudattack_tpu_torch.ops import group_chain as gch
    from pointcloudattack_tpu_torch.ops.chain_maxpool import act
    from pointcloudattack_tpu_torch.ops.pairwise import sum_neighbours

    def same(orig, *args):
        out = orig(*args)
        return out, out

    def pick(orig, p, y):
        p, y = p.long(), y.detach()
        return p, top2_margin(y, -1), y.amax(-1) - y.gather(-1, p[..., None])[..., 0]

    def starts(orig, s, att, curve_num):
        s, top = s.long(), att.detach().sort(dim=-1, descending=True).values
        return s, top[:, curve_num - 1] - top[:, curve_num], top[:, curve_num - 1] - att.detach().gather(-1, s).amin(-1)

    def max_card(orig, x, dim):
        y = orig(x, dim)
        return y, x.detach() == y.detach().unsqueeze(dim)

    def max_cpu(orig, m, x, dim):
        top = torch.where(m, x, float("-inf")).amax(dim).detach()
        mean = torch.where(m, x, 0.0).sum(dim) / m.sum(dim)
        # the winners' max, its gradient split evenly among them
        return top + (mean - mean.detach()), top2_margin(x, dim), x.detach().amax(dim) - top

    def group_card(orig, x, layers, slope=0.0):
        y, am = orig(x, layers, slope)
        return (y, am), am

    def group_cpu(orig, am, x, layers, slope=0.0):
        return pool_at(gch._chain(x, layers, slope)[0], am.to(torch.int32), 2)

    def signed(pos, z, slope):
        """z through the activation on the sides ``pos`` gives, with gap and off."""
        zd = z.detach()
        return torch.where(pos, z, slope * z), zd.abs(), torch.where(pos != (zd > 0), zd.abs(), 0.0)

    def sign_card(orig, x, *slope):
        return orig(x, *slope), x.detach() > 0

    def sign_cpu(orig, pos, x, slope=cn.SLOPE):
        return signed(pos, x, slope)

    def mean_card(orig, x, layers, slope=0.0):
        y = orig(x, layers, slope)
        z, yd = kernel_rows(x, layers, slope), y.detach()
        mine = sum_neighbours(act(z, slope))
        mine = mine / torch.full_like(mine, x.shape[2])  # a true division, as the kernel's (not by a reciprocal)
        if not torch.equal(mine, yd):
            raise AssertionError(f"the group kernel's pre-activations miss its mean in {int((mine != yd).sum())} "
                                 f"of {yd.numel()} outputs, by up to {float((mine - yd).abs().max()):.3e}")
        return y, z > 0

    def mean_cpu(orig, pos, x, layers, slope=0.0):
        h, gap, off = signed(pos, gch._chain(x, layers, slope)[0], slope)
        return sum_neighbours(h) / x.shape[2], gap, off

    hooks = {"pick": (cn, "hard_pick", same, pick), "starts": (cn, "curve_starts", same, starts),
             "max": (cn, "max_pool", max_card, max_cpu), "group": (gch, "chain_groupmax_fwd", group_card, group_cpu)}
    if signs:
        hooks.update({"sign": (cn, "leaky_relu", sign_card, sign_cpu),
                      "mean": (cn, "mlp_chain_groupmean", mean_card, mean_cpu)})
    return hooks


def knn_hooks():
    """``replay`` hooks for DGCNN's kNN ("knn": each point's neighbour
    indices): the deeper stages' features differ by rounding between the
    two sides, and a neighbour near the k-th may differ.  ``off`` is 1 for
    each index set the CPU's own would change."""
    from pointcloudattack_tpu_torch.models import dgcnn as dgcnn_mod

    def card(orig, x, k):
        idx = orig(x, k)
        return idx, idx

    def cpu(orig, idx, x, k):
        return idx, None, (orig(x, k).sort(-1).values != idx.sort(-1).values).any(-1).float()

    return {"knn": (dgcnn_mod, "knn", card, cpu)}


def normal_hooks():
    """``replay`` hooks for GeoA3's normal estimates ("normals"): a normal
    of a nearly collinear 3-point neighbourhood is ill-conditioned, and the
    card's and the CPU's eigensolvers (their acos and cos) may give it
    differently.  ``off`` is, per cloud, the largest difference of the
    CPU's own normals from the card's."""
    from pointcloudattack_tpu_torch.attacks import geoa3 as geo_mod

    def card(orig, pc, k=3):
        nrm = orig(pc, k)
        return nrm, nrm

    def cpu(orig, nrm, pc, k=3):
        return nrm, None, (orig(pc, k) - nrm).abs().flatten(1).amax(1)

    return {"normals": (geo_mod, "estimate_normal", card, cpu)}


def choice_line(stats):
    """``replay``'s stats as one log line."""
    return "; ".join(f"{k}: {st['choices']} choices in {st['calls']} calls, {st['near']} within {TIE_GAP} of a tie "
                     f"({st['exact']} exact), smallest nonzero gap {st['min_gap']:.3e}, "
                     f"{sum(int(n.sum()) for n in st['other'])} taken off the CPU's own, at most "
                     f"{st['off']:.3e} from it" for k, st in stats.items() if st["calls"])


def logp_ties(logp, target):
    """Per cloud, the smaller of two gaps: between the two best non-target
    log-probs (the untargeted loss follows the first) and between the
    target's and the best other's (success)."""
    import torch

    other = logp.scatter(1, target[:, None], float("-inf"))
    top = other.topk(2, dim=1).values
    real = logp.gather(1, target[:, None])[:, 0]
    return torch.minimum(top[:, 0] - top[:, 1], (real - top[:, 0]).abs())


def cw_loss(logp, a, o, t):
    """The CW loss as the attack's first round weighs it: the adversarial
    loss plus 10 x the L2 distance."""
    from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
    from pointcloudattack_tpu_torch.losses.distance import l2_dist

    return untargeted_logits_adv_loss(logp, t, KAPPA) + l2_dist(a, o) * 10.0


def knn_loss(logp, a, o, t):
    """The KNN attack's loss: the adversarial loss plus N x the Chamfer
    distance."""
    from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
    from pointcloudattack_tpu_torch.losses.distance import chamfer_dist

    return untargeted_logits_adv_loss(logp, t, KAPPA) + chamfer_dist(a, o) * a.shape[1]


def grad_parity(model_fn, cpu_fn, adv, ori, target, loss_fn=cw_loss, choices=None, signs=True):
    """Log-probs and the input gradient of ``loss_fn`` at ``adv``, on the
    card and on the CPU, the CPU taking the card's max-pool picks
    (``pick_hooks``) and CurveNet's discrete choices, with ``signs`` its
    activation signs too (``curvenet_hooks``), through ``replay``, whose
    stats go to the list ``choices`` when given.  Per cloud: log-probs
    max|diff|, the gradient's relative L2 difference, the log-prob tie gap
    (``logp_ties``, on the card) and how far the taken choices lie from the
    CPU's own, at most."""
    import torch

    outs = []
    with replay({**pick_hooks(), **curvenet_hooks(signs)}) as stats:
        for fn, a0, o, t in ((model_fn, adv, ori, target), (cpu_fn, adv.cpu(), ori.cpu(), target.cpu())):
            a = a0.detach().clone().requires_grad_(True)
            logp = fn(a)
            loss = loss_fn(logp, a, o, t).sum()
            (grad,) = torch.autograd.grad(loss, a)
            outs.append((logp.detach().cpu(), grad.cpu()))
    (lp_gpu, g_gpu), (lp_cpu, g_cpu) = outs
    g_rel = (g_gpu - g_cpu).flatten(1).norm(dim=1) / g_cpu.flatten(1).norm(dim=1)
    if choices is not None:
        choices.append(stats)
    off = max((st["off"] for st in stats.values() if st["calls"]), default=0.0)
    return {"lp": (lp_gpu - lp_cpu).abs().amax(1), "grad": g_rel, "tie": logp_ties(lp_gpu, target.cpu()),
            "pick": torch.full_like(g_rel, off)}


def hold_grad_parity(tag, steps, clean=True):
    """Holds ``grad_parity`` results (one per step): the taken choices
    within PICK_ATOL of the CPU's own and log-probs within LOGP_ATOL
    everywhere; the gradient within GRAD_REL at every (step, cloud) whose
    log-probs do not tie, and with ``clean``, within GRAD_CLEAN at
    CLEAN_SHARE of them at least."""
    import torch

    lp, g, tie, pick = (torch.stack([s[k] for s in steps]) for k in ("lp", "grad", "tie", "pick"))
    ties = tie <= LOGP_ATOL
    held = g[~ties]
    share = float((held <= GRAD_CLEAN).float().mean()) if held.numel() else 0.0
    log(f"[{tag}] at {len(steps)} input(s) x {g.shape[1]} clouds, card vs CPU (the CPU taking the card's "
        f"choices, which lie at most {float(pick.max()):.3e} from its own): log-probs max|diff| "
        f"{float(lp.max()):.3e}; loss gradient relative L2 difference per step and cloud "
        f"{[[float(f'{v:.3g}') for v in row] for row in g]}; log-prob tie gaps "
        f"{[[round(float(v), 6) for v in row] for row in tie]}; left out as ties (step, cloud): "
        f"{[tuple(ix) for ix in ties.nonzero().tolist()]}; of the other {held.numel()}, max "
        f"{float(held.max()) if held.numel() else float('nan'):.3e} (bound {GRAD_REL}), a share of "
        f"{share:.3f} within {GRAD_CLEAN}")
    if float(pick.max()) > PICK_ATOL or float(lp.max()) > LOGP_ATOL:
        raise AssertionError(f"{tag}: card choices {float(pick.max()):.3e} from the CPU's own (> {PICK_ATOL}) "
                             f"or log-probs {float(lp.max()):.3e} apart (> {LOGP_ATOL})")
    if not held.numel() or float(held.max()) > GRAD_REL:
        raise AssertionError(f"{tag}: loss gradients differ by more than {GRAD_REL} (or every step tied)")
    if clean and share < CLEAN_SHARE:
        raise AssertionError(f"{tag}: only {share:.3f} of the gradients agree within {GRAD_CLEAN}")


def recording_fn(fn, its, grads):
    """``fn`` that appends each step's input to ``its`` and, once the step
    differentiates, its gradient to ``grads`` (an attack's final forward
    takes no gradient and is not recorded)."""
    def run(a):
        if a.requires_grad:
            its.append(a.detach().cpu())
            a.register_hook(lambda g: grads.append(g.detach().cpu()))
        return fn(a)
    return run


def attack_parity(tag, name, model_fn, state, data, target, b, may_part=False):
    """A short attack (1 x 10) on the card and on the CPU from the same
    weights and noise: success, best distance and adversarial clouds.

    With ``may_part`` (PointNet++), the two attacks may part: where a
    column's two best rows, or a hidden unit and 0, lie within f32 rounding,
    the two sides' gradients differ by more than a small coordinate's size,
    its sign differs, and Adam's step, about +-lr whatever the gradient's
    size, moves the coordinate 2*lr apart.  A cloud is then held point by
    point only if its card and CPU iterates agree within PART_ATOL up to the
    card's best step; a parted cloud is named with the step and with both
    sides' gradients of the coordinates that parted.  At each of the card's
    iterates, log-probs and the loss gradient are held cloud by cloud
    (``hold_grad_parity``), which no parting touches.
    """
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    cfg = CWPerturbConfig(binary_step=1, num_iter=10, kappa=KAPPA, budget=BUDGET)
    noise = torch.from_numpy(np.random.RandomState(5).randn(1, b, N, 3).astype(np.float32))
    cpu_fn = make_model_fn(models.make_model(name, NUM_CLASSES), state, "cpu")
    its, grads = {"card": [], "cpu": []}, {"card": [], "cpu": []}

    recording = lambda fn, side: recording_fn(fn, its[side], grads[side])  # noqa: E731
    res_gpu = build_cw_attack(recording(model_fn, "card"), cfg)(data[:b], target[:b], init_noise=noise.cuda())
    res_cpu = build_cw_attack(recording(cpu_fn, "cpu"), cfg)(data[:b].cpu(), target[:b].cpu(), init_noise=noise)
    if not all(len(v) == cfg.num_iter for v in (*its.values(), *grads.values())):
        raise AssertionError(f"recorded {[len(v) for v in its.values()]} iterates and "
                             f"{[len(v) for v in grads.values()]} gradients, expected {cfg.num_iter} each")
    card_it, cpu_it = torch.stack(its["card"]), torch.stack(its["cpu"])  # [S, b, N, 3]
    steps = cfg.num_iter
    # the card's best step: the iterate its best_attack is (the last one if it never succeeded)
    at_best = (card_it == res_gpu.best_attack.cpu()[None]).flatten(2).all(-1)
    best_step = torch.where(at_best.any(0), at_best.int().argmax(0), steps - 1)
    apart = (card_it - cpu_it).abs() > PART_ATOL
    parted = apart.flatten(2).any(-1)  # [S, b]
    part_step = torch.where(parted.any(0), parted.int().argmax(0), steps)
    held = part_step > best_step
    why = []
    for c in (~held).nonzero().flatten().tolist():
        s = int(part_step[c])
        at = apart[s, c]
        gc_, gp = grads["card"][s - 1][c][at], grads["cpu"][s - 1][c][at]
        why.append(f"cloud {c} parted at step {s} in {int(at.sum())} coordinates, whose gradients at step "
                   f"{s - 1} were card {[float(v) for v in gc_[:6]]} cpu {[float(v) for v in gp[:6]]} "
                   f"(opposite signs or 0 in {int((gc_ * gp <= 0).sum())}; the cloud's largest |gradient| "
                   f"{float(grads['card'][s - 1][c].abs().max()):.3e})")
    succ_gpu = res_gpu.success.cpu()
    # every cloud starts as the victim's clean prediction, so what follows
    # depends on the Adam steps, i.e. on the backward kernels' gradients
    diff = (res_gpu.best_attack.cpu() - res_cpu.best_attack).abs()
    rel = (res_gpu.best_dist.cpu() - res_cpu.best_dist).abs() / res_cpu.best_dist
    log(f"[{tag}] card vs CPU, {name} B={b} 1x10: success card {succ_gpu.tolist()} cpu "
        f"{res_cpu.success.tolist()}; best_dist card {res_gpu.best_dist.cpu().tolist()} cpu "
        f"{res_cpu.best_dist.tolist()}, rel diff {[float(v) for v in rel]}; best_attack max |diff| per "
        f"cloud {[float(v) for v in diff.amax(dim=(1, 2))]}; the card's best step per cloud "
        f"{best_step.tolist()}, iterates parted (> {PART_ATOL}) at step {part_step.tolist()} "
        f"({steps}: never); clouds held {held.tolist()}" + "".join(f"; {w}" for w in why))
    if not may_part and not bool(held.all()):
        raise AssertionError("the card's and the CPU's attacks parted")
    if not torch.equal(succ_gpu[held], res_cpu.success[held]):
        raise AssertionError("success differs between the card and the CPU")
    if not bool(res_cpu.success[held].any()):
        raise AssertionError("the short attack flipped no held cloud: it tests no gradient")
    torch.testing.assert_close(res_gpu.best_dist.cpu()[held], res_cpu.best_dist[held], rtol=1e-3, atol=0.0)
    torch.testing.assert_close(res_gpu.best_attack.cpu()[held], res_cpu.best_attack[held], rtol=0.0, atol=1e-5)
    if may_part:
        hold_grad_parity(tag, [grad_parity(model_fn, cpu_fn, a.cuda(), data[:b], target[:b])
                               for a in its["card"]])


def phase_parity(model_fn, state, data, target):
    attack_parity("parity", "PointNet", model_fn, state, data, target, 8)


def phase_parity_msg(model_fn, state, data, target):
    """MSG at B=2, card against CPU: log-probs and the CW-loss input
    gradient (the CPU runs MSG's plain versions slowly, so no attack)."""
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    name, b = "PointNet++Msg", 2
    cpu_fn = make_model_fn(models.make_model(name, NUM_CLASSES), state, "cpu")
    ori = data[:b]
    adv = ori + 0.01 * torch.randn(ori.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                                   device="cuda")
    # two pairs are too few for the share within GRAD_CLEAN (SSG's attack holds it)
    hold_grad_parity("parity-msg", [grad_parity(model_fn, cpu_fn, adv, ori, target[:b])], clean=False)


def phase_profile(tag, model_fn, data, target, attack=None, what="CW 1x10"):
    """torch.profiler over one run of ``attack(data, target)`` (C&W 1 x 10
    when absent) after a warm-up: kernel time by name and the device's idle
    share of the kernel window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack

    if attack is None:
        attack = build_cw_attack(model_fn, CWPerturbConfig(binary_step=1, num_iter=10, kappa=KAPPA, budget=BUDGET))
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
    log(f"[{tag}] {what} B={data.shape[0]} under the profiler: wall {wall * 1e3:.3f} ms; "
        f"{len(kernels)} kernels, {total / 1e3:.3f} ms of kernel time; device busy "
        f"{busy / 1e3:.3f} ms of the {window / 1e3:.3f} ms kernel window "
        f"(idle share {1 - busy / window if window else float('nan'):.3f})")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[{tag}]   {t / 1e3:9.3f} ms  {t / total:6.3f}  x{n:<5d} {name[:90]}")


@contextlib.contextmanager
def phase_clock(tag):
    t0 = time.perf_counter()
    yield
    log(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def knn_inputs():
    """While open, records the input and k of every kNN that DGCNN runs."""
    from pointcloudattack_tpu_torch.models import dgcnn as dgcnn_mod

    orig, seen = dgcnn_mod.knn, []

    def rec(x, k):
        seen.append((x.detach().clone(), k))
        return orig(x, k)

    dgcnn_mod.knn = rec
    try:
        yield seen
    finally:
        dgcnn_mod.knn = orig


def edgeconv_fused_vs_unfused(model, inputs):
    """One EdgeConv stage each way at the path's shapes: the fused gather
    kernel + LeakyReLU against the unfused plain layer (gather, matmul, BN,
    LeakyReLU, max), forward and forward + input backward, the same kNN."""
    import torch
    import torch.nn.functional as F

    from pointcloudattack_tpu_torch.ops.gather_chain import gather_chain_groupmax
    from pointcloudattack_tpu_torch.ops.knn import knn

    out = []
    for i, ((x, k), edge) in enumerate(zip(inputs, model.edges)):
        idx = knn(x, k)
        c = x.shape[-1]
        layout = (("diff", 0, c, 0), ("center", 0, c))
        fused = lambda a: F.leaky_relu(gather_chain_groupmax(a, a, idx, [edge.fused_layer()], layout), 0.2)  # noqa: E731
        unfused = lambda a: edge.unfused(a, idx)  # noqa: E731
        xr = x.clone().requires_grad_(True)
        torch.testing.assert_close(fused(x), unfused(x), rtol=1e-5, atol=1e-4)
        ms = time_pairs({
            "unfused": lambda: unfused(x), "fused": lambda: fused(x),
            "fused_fb": lambda: torch.autograd.grad(fused(xr).sum(), xr),
            "unfused_fb": lambda: torch.autograd.grad(unfused(xr).sum(), xr),
        }, reps=10)
        log(f"[kernels-gather-dgcnn] EdgeConv conv{i + 1} {tuple(x.shape)} k={k} -> {edge.bn.num_features}: "
            f"fused forward {ms['fused']:.4f} ms, unfused plain {ms['unfused']:.4f} ms; forward + input "
            f"backward fused {ms['fused_fb']:.4f} ms, unfused {ms['unfused_fb']:.4f} ms")
        out.append(ms)
        del xr
        torch.cuda.empty_cache()
    return out


def phase_kernels_dgcnn(model, model_fn, data):
    """The kNN kernel at the four EdgeConv inputs of one forward of the
    DGCNN victim (and ragged, and all ties), the gather kernel at the four
    EdgeConv shapes, and the fused EdgeConv against the unfused one; the
    record's numbers sum the four stages of one forward (and backward)."""
    import torch

    from pointcloudattack_tpu_torch.ops import knn as knn_mod

    rec = new_record("knn", "gather_fwd", "gather_bwd")
    with knn_inputs() as inputs, torch.no_grad():
        model_fn(data)
    if [tuple(x.shape[1:]) + (k,) for x, k in inputs] != [(N, c, DG_K) for c in (3, 64, 64, 128)]:
        raise AssertionError(f"DGCNN ran kNN on {[tuple(x.shape) for x, _ in inputs]}")
    with phase_clock("kernels-knn"):
        for i, (x, k) in enumerate(inputs):
            rec["knn"]["err"] = max(rec["knn"]["err"], check_knn("kernels-knn", f"conv{i + 1} input", x, k))
            ms = time_pairs({"plain": lambda: knn_mod.knn_plain(x, k), "kernel": lambda: knn_mod.knn(x, k)}, reps=5)
            bnd = knn_bound(*x.shape, k)
            accumulate(rec["knn"], ms["kernel"], ms["plain"], bnd)
            log(f"[kernels-knn] conv{i + 1} {tuple(x.shape)} k={k}: kernel {ms['kernel']:.4f} ms, plain "
                f"{ms['plain']:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}")
        errs = [check_knn("kernels-knn", "conv2 input, first 1000 points (ragged)",
                          inputs[1][0][:, :1000].contiguous(), DG_K)]
        for i in (0, 3):  # every point 4 times: each row's first 4 neighbours tie at distance 0
            x = inputs[i][0]
            errs.append(check_knn("kernels-knn", f"conv{i + 1} input, its first 256 points 4 times (ties)",
                                  torch.cat([x[:, :256]] * 4, dim=1).contiguous(), DG_K))
        rec["knn"]["err"] = max(rec["knn"]["err"], *errs)
    with phase_clock("kernels-gather-dgcnn"):
        for i, (name, shape) in enumerate(DGCNN_GATHER_SHAPES.items()):
            case = gather_case(40 + i, *shape)
            errs, am, g, win = check_gather(name, *case)
            ms, b_fwd, b_bwd = time_gather(name, shape[6], *case[:5], am, g, win)
            b, ng, k = case[2].shape
            for key, e, m, p, bb, rows in (
                ("gather_fwd", errs["y"], ms["fwd"], ms["fwd_plain"], b_fwd, b * ng * k),
                ("gather_bwd", max(errs["dsrc"], errs["dctr"]), ms["bwd"], ms["bwd_plain"], b_bwd, win),
            ):
                rec[key]["err"] = max(rec[key]["err"], e)
                accumulate(rec[key], m, p, bb, rows)
            del case, am, g
            torch.cuda.empty_cache()
        rec["edgeconv"] = edgeconv_fused_vs_unfused(model, inputs)
    return rec


def phase_kernels_chamfer(data):
    """The row-min kernel at the KNN attack's shape, against an iterate a
    few steps in (clean clouds plus noise of 0.01), and at a ragged
    N = M = 1000 against a cloud whose points each appear 4 times."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops import chamfer

    rng = np.random.RandomState(8)
    adv = (data + torch.from_numpy(rng.randn(*data.shape).astype(np.float32) * 0.01).cuda()).contiguous()
    w = torch.from_numpy(rng.rand(*data.shape[:2]).astype(np.float32)).cuda()
    err = check_chamfer("kernels-chamfer", f"B={data.shape[0]} N=M={data.shape[1]}", adv, data, w)
    dup = torch.cat([data[:, :250]] * 4, dim=1).contiguous()
    err = max(err, check_chamfer("kernels-chamfer", "ragged N=M=1000, every y point 4 times",
                                 adv[:, :1000].contiguous(), dup, w[:, :1000].contiguous()))
    ms = time_pairs({"plain": lambda: chamfer.min_rows_plain(adv, data), "kernel": lambda: chamfer.min_rows_fwd(adv, data)})
    b, n, _ = data.shape
    bnd = chamfer_bound(b, n, n)
    log(f"[kernels-chamfer] [{b},{n},3] x [{b},{n},3]: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms, "
        f"bound {bnd[0]:.5f} ms by {bnd[1]} ({8.0 * b * n * n / 1e9:.3f} G operations)")
    return {"ms": ms["kernel"], "plain_ms": ms["plain"], "bound": bnd, "err": err}


def parted_points(card_it, cpu_it, g_card, g_cpu):
    """Where two runs of an attack part: ``card_it`` and ``cpu_it``
    ``[S + 1, b, N, 3]`` (each step's input, then the end), ``g_card`` and
    ``g_cpu`` each step's input gradient ``[b, N, 3]``.  Returns
    (``parted [b, N]``: some iterate further apart than PART_ATOL; a line
    naming each parted point; the parted points none of whose first-parted
    coordinates had a card gradient within TINY_GRAD of 0, relative to its
    cloud's largest, at some step before)."""
    import torch

    apart = (card_it - cpu_it).abs() > PART_ATOL
    parted = apart.any(-1).any(0)
    why, unexplained = [], []
    for c, p in parted.nonzero().tolist():
        s_ = int(apart[:, c, p].any(-1).int().argmax())
        coords = apart[s_, c, p]  # the coordinates that parted first
        if not s_:
            unexplained.append((c, p))
            why.append(f"cloud {c} point {p} apart from the start")
            continue
        rel = torch.stack([g[c, p].abs() / g[c].abs().max() for g in g_card[:s_]])[:, coords]
        if not bool((rel <= TINY_GRAD).any()):
            unexplained.append((c, p))
        why.append(f"cloud {c} point {p} parted at step {s_} in coordinates {coords.nonzero().flatten().tolist()}, "
                   f"whose least gradient relative to the cloud's largest before then was {float(rel.min()):.3e}; "
                   f"its gradient at step {s_ - 1} card {[float(v) for v in g_card[s_ - 1][c, p]]} cpu "
                   f"{[float(v) for v in g_cpu[s_ - 1][c, p]]} (the cloud's largest |gradient| "
                   f"{float(g_card[s_ - 1][c].abs().max()):.3e})")
    return parted, why, unexplained


def round_partings(card_it, cpu_it, g_card, iters, choices=None, g_cpu=None):
    """Where two runs of an attack whose rounds each restart from the same
    start (GeoA3) part.  ``card_it`` and ``cpu_it`` ``[S, b, N, 3]`` hold each
    step's input (S = rounds x ``iters``), ``g_card`` each step's input
    gradient ``[b, N, 3]``.  Returns (``parted [b, N]``: some iterate further
    apart than PART_ATOL; a line for each round and cloud that parts, naming
    the step at which it first does and what explains it; whether the run's
    first parting is explained).  A parting is explained when each of its
    points had, at an earlier step of the round, a parting coordinate's
    gradient within TINY_GRAD of 0 relative to the cloud's largest (Adam's
    step is about lr whatever the gradient's size) or, with the other side's
    gradients ``g_cpu``, one that differed between the sides by more than
    GRAD_APART of itself (Adam turns a relative gradient difference d into a
    step difference of about lr * d, and lr * GRAD_APART = PART_ATOL at
    lr 1e-2), or when at an earlier
    step of the round the two sides' iterates of the cloud make another
    discrete choice (``choices(c, a)``: a dict of the choices a cloud ``c``
    iterate ``a [1, N, 3]`` makes, such as its neighbour sets and max-pool
    picks), so that their gradients differ by more than rounding.  After a
    point has parted, the curvature term (its neighbours' kappa) and the
    victim's pooled features carry the difference to other points, so only
    the first parting is held to the rule."""
    import torch

    apart = (card_it - cpu_it).abs() > PART_ATOL
    lines, onsets = [], []
    for r in range(apart.shape[0] // iters):
        for c in range(apart.shape[1]):
            steps = apart[r * iters:(r + 1) * iters, c].flatten(1).any(-1)
            if not bool(steps.any()):
                continue
            s_ = r * iters + int(steps.int().argmax())
            pts = apart[s_, c].any(-1).nonzero().flatten().tolist()
            def explained(q, p):
                g = g_card[q][c, p][apart[s_, c, p]]
                if bool((g.abs() <= TINY_GRAD * g_card[q][c].abs().max()).any()):
                    return True
                return g_cpu is not None and bool(
                    ((g - g_cpu[q][c, p][apart[s_, c, p]]).abs() > GRAD_APART * g.abs()).any())

            tiny = [p for p in pts if any(explained(q, p) for q in range(r * iters, s_))]
            rel = max((float(((g_card[q][c, p] - g_cpu[q][c, p]).abs() / g_card[q][c, p].abs()).max())
                       for q in range(r * iters, s_) for p in pts), default=float("nan")) if g_cpu is not None else None
            other = []
            if choices is not None and len(tiny) < len(pts):
                for q in range(r * iters, s_):
                    mine, theirs = choices(c, card_it[q, c:c + 1]), choices(c, cpu_it[q, c:c + 1])
                    other += [(q, k) for k in mine if not torch.equal(mine[k], theirs[k])]
            onsets.append((s_, len(tiny) == len(pts) or bool(other)))
            lines.append(f"round {r} cloud {c}: {len(pts)} points part first at step {s_} ({pts[:8]}...), "
                         f"{len(tiny)} of them after a gradient within {TINY_GRAD} of 0 (or {GRAD_APART} apart "
                         f"between the sides; the largest relative difference {rel}); the two sides' iterates "
                         f"chose otherwise at (step, choice) {other}")
    first = min(onsets)[0] if onsets else None
    return apart.any(-1).any(0), lines, all(ok for s_, ok in onsets if s_ == first)


def geoa3_choices(cpu_fn, ori):
    """``choices`` for ``round_partings`` on GeoA3, on the CPU: the victim's
    max-pool picks, the curvature's neighbour sets (k = GEO_K), each point's
    nearest point in the other cloud either way and the Hausdorff point of
    a cloud ``c`` iterate ``a [1, N, 3]`` against ``ori[c]``."""
    import torch

    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops.chamfer import both_plain
    from pointcloudattack_tpu_torch.ops.kappa import kappa_plain

    def choices(c, a):
        orig, picks = cm.chain_maxpool_fwd, []

        def chain_fwd(x, layers):
            y, idx = orig(x, layers)
            picks.append(idx)
            return y, idx

        cm.chain_maxpool_fwd = chain_fwd
        try:
            with torch.no_grad():
                cpu_fn(a)
        finally:
            cm.chain_maxpool_fwd = orig
        rmin, rarg, _, carg = both_plain(a, ori[c:c + 1])
        return {**{f"max-pool {i}": p for i, p in enumerate(picks)},
                "curvature neighbours": kappa_plain(a, a, GEO_K)[1].sort(-1).values,
                "nearest clean point": rarg, "nearest adversarial point": carg, "Hausdorff point": rmin.argmax(-1)}

    return choices


def phase_parity_knn(model_fn, state, data, target):
    """The KNN attack (B=8, 10 iterations) on the card and on the CPU from
    the same weights and noise.  Held: ``success`` identical; the final
    clouds within 1e-5 at every point whose card and CPU iterates never
    parted (by more than PART_ATOL); and at each of the card's iterates the
    loss gradient, the CPU taking the card's picks (``hold_grad_parity``).
    A point parts where a coordinate's gradient lies within rounding of 0
    next to the cloud's largest (the Chamfer term pulls a point that is back
    on its clean position to 0): Adam's step is about lr whatever the
    gradient's size, so a few per cent between the two sides' tiny gradients
    become a difference of the step.  So at most PART_SHARE of the points
    may part, and each only if a coordinate that parted had, at some step
    before, a gradient within TINY_GRAD of 0 on the card (relative to its
    cloud's largest); each is named with the step and both sides'
    gradients there."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.knn import KNNAttackConfig, build_knn_attack
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b, steps = 8, 10
    cfg = KNNAttackConfig(attack_lr=KNN_LR, num_iter=steps, kappa=KAPPA, budget=BUDGET)
    noise = torch.from_numpy(np.random.RandomState(5).randn(b, N, 3).astype(np.float32))
    cpu_fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state, "cpu")
    its, grads = {"card": [], "cpu": []}, {"card": [], "cpu": []}

    recording = lambda fn, side: recording_fn(fn, its[side], grads[side])  # noqa: E731
    adv_g, succ_g = build_knn_attack(recording(model_fn, "card"), cfg)(data[:b], target[:b], init_noise=noise.cuda())
    adv_c, succ_c = build_knn_attack(recording(cpu_fn, "cpu"), cfg)(data[:b].cpu(), target[:b].cpu(), init_noise=noise)
    if not all(len(v) == steps for v in (*its.values(), *grads.values())):
        raise AssertionError(f"parity-knn: recorded {[len(v) for v in its.values()]} iterates and "
                             f"{[len(v) for v in grads.values()]} gradients, expected {steps} each")
    card_it = torch.stack(its["card"] + [adv_g.cpu()])  # [steps + 1, b, N, 3]: each step's input, then the end
    cpu_it = torch.stack(its["cpu"] + [adv_c])
    parted, why, unexplained = parted_points(card_it, cpu_it, grads["card"], grads["cpu"])
    diff = (adv_g.cpu() - adv_c).abs()
    share = float(parted.float().mean())
    log(f"[parity-knn] card vs CPU, PointNet B={b}, {steps} iterations: success card {succ_g.tolist()} cpu "
        f"{succ_c.tolist()}; final clouds max |diff| per cloud {[float(v) for v in diff.amax(dim=(1, 2))]}; "
        f"{int(parted.sum())} of {parted.numel()} points parted (> {PART_ATOL}), a share of {share:.2e} "
        f"(at most {PART_SHARE}); the others max |diff| {float(diff[~parted].max()):.3e}"
        + "".join(f"; {w}" for w in why))
    if not torch.equal(succ_g.cpu(), succ_c):
        raise AssertionError("parity-knn: success differs between the card and the CPU")
    if share > PART_SHARE:
        raise AssertionError(f"parity-knn: {int(parted.sum())} points parted, more than {PART_SHARE} of them")
    if unexplained:
        raise AssertionError(f"parity-knn: points {unexplained} parted with no coordinate's gradient within "
                             f"{TINY_GRAD} of 0 (relative) before then")
    torch.testing.assert_close(adv_g.cpu()[~parted], adv_c[~parted], rtol=0.0, atol=1e-5)
    hold_grad_parity("parity-knn", [grad_parity(model_fn, cpu_fn, a.cuda(), data[:b], target[:b], knn_loss)
                                    for a in its["card"]])


def phase_parity_dgcnn(model_fn, state, data, target):
    """DGCNN at B=2, card against CPU, the CPU taking the card's kNN indices
    and max-pool picks: log-probs and the CW-loss input gradient."""
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b = 2
    cpu_fn = make_model_fn(models.make_model("DGCNN", NUM_CLASSES), state, "cpu")
    ori = data[:b]
    adv = ori + 0.01 * torch.randn(ori.shape, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    with replay(knn_hooks()) as stats:
        res = grad_parity(model_fn, cpu_fn, adv, ori, target[:b])
    diffs = [int(n.sum()) for n in stats["knn"]["other"]]
    log(f"[parity-dgcnn] the CPU took the card's kNN indices at its {len(diffs)} EdgeConv stages; its own "
        f"would differ in {diffs} of the {b * N} index sets of each")
    if len(diffs) != 4:
        raise AssertionError(f"parity-dgcnn: the CPU ran {len(diffs)} kNNs, expected 4")
    hold_grad_parity("parity-dgcnn", [res], clean=False)


def kappa_bound(b, n, k):
    """(bound_ms, bound_by) of one curvature forward: 8 operations a pair
    for the exact distance and one compare a pair for the selection, (k+1)
    log2(k+1) a row to order the picks, 11 a kept edge (the projection's 5,
    a subtraction, the square root, the 1e-12, the division, the absolute
    value and the mean's sum) and 5 a row for n_i . a_i; adv and the normals
    read once, kappa written once."""
    flops = 9.0 * b * n * n + b * n * (k + 1) * math.log2(k + 1) + 11.0 * b * n * k + 5.0 * b * n
    return bound(flops, 4.0 * (2 * 3 * b * n + b * n))


def kappa_bwd_bound(b, n, k):
    """(bound_ms, bound_by) of one curvature backward: about 43 operations a
    kept edge (its distance 8, projection 6, square root and 1e-12, sign,
    w s, alpha and beta 6, the edge term alpha n + beta v 9, the row's two
    sums 6 and alpha v 3) and 3 adds to put it on its neighbour; adv, the
    normals, dkappa and the k picks read once, dadv and dnormal written
    once."""
    return bound(46.0 * b * n * k, 4.0 * (2 * 3 * b * n + b * n + b * n * k + 2 * 3 * b * n))


def both_bound(b, n, m):
    """(bound_ms, bound_by) of one two-direction forward: 8 operations a
    pair for the distance and a compare each for the row and the column
    min; x and y read once, both mins and argmins written once."""
    return bound(10.0 * b * n * m, 4.0 * (3 * b * n + 3 * b * m + 2 * b * n + 2 * b * m))


def both_bwd_bound(b, n, m):
    """(bound_ms, bound_by) of one two-direction backward: each point's own
    term (3 subtractions, 4 products) and its pull onto the matched point (3
    sums); x, y, the argmins and the cotangents read once, dx and dy written
    once."""
    return bound(10.0 * b * (n + m), 4.0 * (3 * b * n + 3 * b * m + 2 * b * n + 2 * b * m + 3 * b * n + 3 * b * m))


def _same(tag, what, got, want, **tol):
    """``got`` (on the card) against ``want`` (on the CPU): within ``tol``
    when given, else equal; returns (max |diff|, bit-equal)."""
    import torch

    got = got.cpu()
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if tol:
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{tag} {what}: {m}")
    elif not torch.equal(got, want):
        raise AssertionError(f"{tag} {what}: the kernel differs from the plain version (max |diff| {err})")
    return err, torch.equal(got, want)


def check_kappa(tag, name, a, nrm, dk):
    """The curvature kernels against the plain versions on the CPU (whose
    sums run in a fixed order) on one input: the picks equal, kappa within
    KAPPA_RTOL, dadv and dnormal within KAPPA_GRAD_ATOL.  Returns the max
    |diff| over all of them."""
    from pointcloudattack_tpu_torch.ops import chamfer, kappa

    kap, picks = kappa.kappa_fwd(a, nrm, GEO_K)
    dadv, dnrm = kappa.kappa_bwd(a, nrm, picks, dk, GEO_K)
    kap_p, picks_p = kappa.kappa_plain(a.cpu(), nrm.cpu(), GEO_K)
    dadv_p, dnrm_p = kappa.kappa_bwd_plain(a.cpu(), nrm.cpu(), picks_p, dk.cpu(), GEO_K)
    res = {"picks": _same(tag, "picks", picks, picks_p),
           "kappa": _same(tag, "kappa", kap, kap_p, rtol=KAPPA_RTOL, atol=0.0),
           "dadv": _same(tag, "dadv", dadv, dadv_p, rtol=0.0, atol=KAPPA_GRAD_ATOL),
           "dnormal": _same(tag, "dnormal", dnrm, dnrm_p, rtol=0.0, atol=KAPPA_GRAD_ATOL)}
    zero = int((chamfer.exact_sqdist(a, a).gather(-1, picks.long()) == 0).sum())
    log(f"[{tag}] kappa {name} {tuple(a.shape)} k={GEO_K}: picks equal to the plain version's; max |diff| "
        + ", ".join(f"{k} {e:.3e} ({'bit-equal' if eq else 'not bit-equal'})" for k, (e, eq) in res.items())
        + f"; {zero} picks at distance 0, all finite")
    return max(e for e, _ in res.values())


def check_both(tag, name, x, y, gr, gc):
    """The two-direction kernels against the plain versions on the CPU on
    one input: both mins and argmins bit for bit, dx and dy within
    BOTH_GRAD_ATOL.  Returns the max |diff| over all of them."""
    from pointcloudattack_tpu_torch.ops import chamfer

    fwd = chamfer.both_fwd(x, y)
    dx, dy = chamfer.both_bwd(x, y, fwd[1], fwd[3], gr, gc)
    fwd_p = chamfer.both_plain(x.cpu(), y.cpu())
    dx_p, dy_p = chamfer.both_bwd_plain(x.cpu(), y.cpu(), fwd_p[1], fwd_p[3], gr.cpu(), gc.cpu())
    res = {k: _same(tag, k, g, w) for k, g, w in zip(("row_min", "row_arg", "col_min", "col_arg"), fwd, fwd_p)}
    res["dx"] = _same(tag, "dx", dx, dx_p, rtol=0.0, atol=BOTH_GRAD_ATOL)
    res["dy"] = _same(tag, "dy", dy, dy_p, rtol=0.0, atol=BOTH_GRAD_ATOL)
    log(f"[{tag}] min_sqdist_both {name} x {tuple(x.shape)} y {tuple(y.shape)}: mins and argmins bit-equal to the "
        "plain version; max |diff| " + ", ".join(f"{k} {e:.3e} ({'bit-equal' if eq else 'not bit-equal'})"
                                                for k, (e, eq) in res.items() if k in ("dx", "dy")))
    return max(e for e, _ in res.values())


def phase_kernels_geoa3(data):
    """The curvature and the two-direction kernels at GeoA3's shapes, on an
    iterate a few steps in (clean clouds plus 1e-3 noise) with the normals
    of each point's nearest clean point, at a ragged N=1000, and with every
    point twice (kappa) or 4 times (the bundle's y); times beside the
    plain versions' (on the card) and the bounds."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.geometry.normals import estimate_normal
    from pointcloudattack_tpu_torch.losses.geometry import nn1_idx
    from pointcloudattack_tpu_torch.ops import chamfer, kappa
    from pointcloudattack_tpu_torch.ops.gather import index_points

    rng = np.random.RandomState(11)
    b, n, _ = data.shape
    dev = lambda arr: torch.from_numpy(arr.astype(np.float32)).cuda()  # noqa: E731
    adv = (data + dev(rng.randn(b, n, 3) * 1e-3)).contiguous()
    nrm = index_points(estimate_normal(data), nn1_idx(adv, data)).contiguous()
    dk = dev(rng.randn(b, n) * 1e-3)
    gr, gc = dev(rng.rand(b, n)), dev(rng.rand(b, n))
    half = lambda t: torch.cat([t[:, : n // 2]] * 2, dim=1).contiguous()  # noqa: E731
    rec = new_record("kappa_fwd", "kappa_bwd", "both_fwd", "both_bwd")
    err_k = max(check_kappa("kernels-geoa3", f"B={b} N={n}", adv, nrm, dk),
                check_kappa("kernels-geoa3", "ragged N=1000", adv[:, :1000].contiguous(), nrm[:, :1000].contiguous(),
                            dk[:, :1000].contiguous()),
                check_kappa("kernels-geoa3", "every point twice", half(adv), half(nrm), dk))
    dup = torch.cat([data[:, :250]] * 4, dim=1).contiguous()
    err_b = max(check_both("kernels-geoa3", f"B={b} N=M={n}", adv, data, gr, gc),
                check_both("kernels-geoa3", "ragged N=M=1000, every y point 4 times", adv[:, :1000].contiguous(), dup,
                           gr[:, :1000].contiguous(), gc[:, :1000].contiguous()))
    for key in ("kappa_fwd", "kappa_bwd"):
        rec[key]["err"] = err_k
    for key in ("both_fwd", "both_bwd"):
        rec[key]["err"] = err_b
    _, picks = kappa.kappa_fwd(adv, nrm, GEO_K)
    fwd = chamfer.both_fwd(adv, data)
    ms = time_pairs({
        "kappa_fwd_plain": lambda: kappa.kappa_plain(adv, nrm, GEO_K),
        "kappa_fwd": lambda: kappa.kappa_fwd(adv, nrm, GEO_K),
        "kappa_bwd_plain": lambda: kappa.kappa_bwd_plain(adv, nrm, picks, dk, GEO_K),
        "kappa_bwd": lambda: kappa.kappa_bwd(adv, nrm, picks, dk, GEO_K),
        "both_fwd_plain": lambda: chamfer.both_plain(adv, data),
        "both_fwd": lambda: chamfer.both_fwd(adv, data),
        "both_bwd_plain": lambda: chamfer.both_bwd_plain(adv, data, fwd[1], fwd[3], gr, gc),
        "both_bwd": lambda: chamfer.both_bwd(adv, data, fwd[1], fwd[3], gr, gc),
    }, reps=10)
    for key, bnd in (("kappa_fwd", kappa_bound(b, n, GEO_K)), ("kappa_bwd", kappa_bwd_bound(b, n, GEO_K)),
                     ("both_fwd", both_bound(b, n, n)), ("both_bwd", both_bwd_bound(b, n, n))):
        accumulate(rec[key], ms[key], ms[f"{key}_plain"], bnd)
        log(f"[kernels-geoa3] {key} [{b},{n},3] k={GEO_K}: kernel {ms[key]:.4f} ms, plain {ms[f'{key}_plain']:.4f} ms, "
            f"bound {bnd[0]:.5f} ms by {bnd[1]}")
    return rec


def run_geoa3(tag, model_fn, data, target, per_fwd, per_bwd, rounds=GEO_ROUNDS, iters=GEO_ITER):
    """GeoA3 (bench.py's geoa3 settings, ``rounds`` x ``iters``), counted
    and timed: per iteration one model forward and backward (launching
    ``per_fwd`` and ``per_bwd``), the curvature forward and backward and the
    bundle's forward and backward; per round one more forward; once the
    normals' kNN, the clean cloud's curvature and the final forward."""
    import torch

    from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack

    steps = rounds * iters
    expect = {k: per_fwd.get(k, 0) * (steps + rounds + 1) + per_bwd.get(k, 0) * steps for k in {*per_fwd, *per_bwd}}
    expect.update(knn=expect.get("knn", 0) + 1, kappa_fwd=1 + steps, kappa_bwd=steps, both_fwd=steps,
                  both_bwd=steps)

    def check(res):
        adv, best_loss, succ = res
        asr, moved = check_adv(tag, adv, data, succ, budget=None)
        if not bool(torch.isfinite(best_loss[succ]).all()):
            raise AssertionError(f"{tag}: non-finite best_loss on a successful example")
        log(f"[{tag}] ASR {asr:.3f} ({int(succ.sum())}/{len(succ)}); max per-point move {moved:.4f}; "
            f"best constraint of the successes {[round(float(v), 8) for v in best_loss[succ]]}")

    attack = build_geoa3_attack(model_fn, GeoA3Config(binary_max_steps=rounds, iter_max_steps=iters))
    return counted_and_timed(tag, f"GeoA3 {rounds}x{iters}", attack, data, target, expect, check)


def geoa3_loss(normals, k_oris):
    """GeoA3's first-round loss (CE plus 10 x the constraint) as a
    ``grad_parity`` loss, each side on its own normals and clean curvature
    (``normals`` / ``k_oris``: device type -> tensor)."""
    from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, _constraint_loss, _make_cls_fn

    cfg = GeoA3Config()
    cls = _make_cls_fn(cfg)

    def loss(logp, a, o, t):
        dev = a.device.type
        return cls(logp, t) + cfg.initial_const * _constraint_loss(a, o, normals[dev], k_oris[dev], cfg)

    return loss


def phase_parity_geoa3(model_fn, state, data, target):
    """GeoA3 (B=4, 2 rounds x 10 iterations) on the card and on the CPU from
    the same weights and start offsets, the CPU taking the card's normals
    (``normal_hooks``).  Held: ``success`` identical; the step whose
    iterate each side keeps, and where it is the same, ``best_loss`` within
    rtol 1e-4 and ``best_attack`` within 1e-5 at every point whose iterates
    never parted (by more than PART_ATOL); the run's first parting explained
    (``round_partings``: after a gradient within TINY_GRAD of 0, or after
    the two sides' iterates chose other neighbours, nearest points or
    max-pool picks, ``geoa3_choices``), and at least
    GEO_HELD_SHARE of the points never parted; and at each of the card's
    iterates the loss gradient, the CPU taking the card's picks
    (``hold_grad_parity``)."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack
    from pointcloudattack_tpu_torch.geometry.normals import estimate_normal
    from pointcloudattack_tpu_torch.losses.geometry import kappa_ori
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b, rounds, iters = 4, 2, 10
    cfg = GeoA3Config(binary_max_steps=rounds, iter_max_steps=iters)
    offsets = torch.from_numpy((np.random.RandomState(6).randn(rounds, b, N, 3) * 1e-3).astype(np.float32))
    cpu_fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state, "cpu")
    its, grads = {"card": [], "cpu": []}, {"card": [], "cpu": []}
    recording = lambda fn, side: recording_fn(fn, its[side], grads[side])  # noqa: E731
    with replay(normal_hooks()) as normals:
        adv_g, loss_g, succ_g = build_geoa3_attack(recording(model_fn, "card"), cfg)(
            data[:b], target[:b], init_offsets=offsets.cuda())
        adv_c, loss_c, succ_c = build_geoa3_attack(recording(cpu_fn, "cpu"), cfg)(
            data[:b].cpu(), target[:b].cpu(), init_offsets=offsets)
    steps = rounds * iters
    if not all(len(v) == steps for v in (*its.values(), *grads.values())):
        raise AssertionError(f"parity-geoa3: recorded {[len(v) for v in its.values()]} iterates and "
                             f"{[len(v) for v in grads.values()]} gradients, expected {steps} each")
    card_it, cpu_it = torch.stack(its["card"]), torch.stack(its["cpu"])
    kept = []
    for it_, adv in ((card_it, adv_g.cpu()), (cpu_it, adv_c)):
        eq = (it_ == adv[None]).flatten(2).all(-1)
        kept.append(torch.where(eq.any(0), eq.int().argmax(0), -1))
    same = kept[0] == kept[1]
    parted, lines, first_ok = round_partings(card_it, cpu_it, grads["card"], iters,
                                             geoa3_choices(cpu_fn, data[:b].cpu()), grads["cpu"])
    held_share = 1.0 - float(parted.float().mean())
    diff = (adv_g.cpu() - adv_c).abs()
    log(f"[parity-geoa3] card vs CPU, PointNet B={b}, {rounds}x{iters}: the CPU's own normals would differ from the "
        f"card's by at most {normals['normals']['off']:.3e} over its {normals['normals']['calls']} estimates; success card {succ_g.tolist()} cpu {succ_c.tolist()}; best_loss card "
        f"{loss_g.cpu().tolist()} cpu {loss_c.tolist()}; kept step card {kept[0].tolist()} cpu {kept[1].tolist()} "
        f"({int((~same).sum())} clouds differ); {int(parted.sum())} of {parted.numel()} points parted (> {PART_ATOL}), "
        f"{held_share:.3f} never did (at least {GEO_HELD_SHARE}); the others max |diff| "
        f"{float(diff[~parted].max()):.3e}" + "".join(f"; {w}" for w in lines))
    if not torch.equal(succ_g.cpu(), succ_c):
        raise AssertionError("parity-geoa3: success differs between the card and the CPU")
    if not bool(succ_c.any()):
        raise AssertionError("parity-geoa3: the short attack flipped no cloud: it tests no best tracking")
    if not first_ok or held_share < GEO_HELD_SHARE:
        raise AssertionError(f"parity-geoa3: nothing explains the first parting, or only {held_share:.3f} of "
                             "the points never parted")
    torch.testing.assert_close(loss_g.cpu()[same], loss_c[same], rtol=1e-4, atol=0.0)
    held = same[:, None] & ~parted
    torch.testing.assert_close(adv_g.cpu()[held], adv_c[held], rtol=0.0, atol=1e-5)
    card_nrm = estimate_normal(data[:b])
    nrm = {"cuda": card_nrm, "cpu": card_nrm.cpu()}  # the CPU on the card's normals, as in the attack
    k_oris = {dev: kappa_ori(x, nrm[dev], GEO_K) for dev, x in (("cuda", data[:b]), ("cpu", data[:b].cpu()))}
    loss = geoa3_loss(nrm, k_oris)
    hold_grad_parity("parity-geoa3", [grad_parity(model_fn, cpu_fn, a.cuda(), data[:b], target[:b], loss)
                                      for a in its["card"]])


def group_case(seed, b, g, k, dims, device="cuda"):
    """Seeded grouped rows ``x [b, g, k, dims[0]]``, layers and cotangent."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, g, k, dims[0]).astype(np.float32)).to(device)
    layers = seeded_layers(rng, dims, device)
    dy = torch.from_numpy(rng.randn(b, g, dims[-1]).astype(np.float32)).to(device)
    return x, layers, dy


def check_group(name, pool, x, layers, dy, slope=CN_SLOPE):
    """The group chain kernel (``pool`` "max" or "mean") against its plain
    version on one case, both on the card: y within Y_TOL; for the max the
    argmax equal except at near ties and every card pick at most PICK_ATOL
    below the plain max; dx within DX_TOL on the rows that carry a
    cotangent (the max's winning rows, every row for the mean), except rows
    with an activated pre-activation within EDGE of 0, which may take the
    other slope on either side (counted).  Returns (errors, am_ref or None,
    g, rows that carry a cotangent)."""
    import torch

    from pointcloudattack_tpu_torch.ops import group_chain as gch

    b, ng, k, _ = x.shape
    mul = layers[-1][3]
    z, zs = gch._chain(x, layers, slope)
    if pool == "max":
        y, am = gch.chain_groupmax_fwd(x, layers, slope)
        y_ref, am_ref = gch.chain_groupmax_plain(x, layers, slope)
        near = top2_margin(z, 2) <= Y_TOL["atol"]
        if int(((am != am_ref) & ~near).sum()):
            raise AssertionError(f"{name}: argmax differs in {int(((am != am_ref) & ~near).sum())} columns "
                                 "with a clear winner")
        below = float((y_ref - z.gather(2, am.long().unsqueeze(2)).squeeze(2)).max())
        if below > PICK_ATOL:
            raise AssertionError(f"{name}: a card pick lies {below:.3e} below the plain max")
        g = (dy * mul).contiguous()
        dx = gch.chain_groupmax_bwd(x, layers, am_ref, g, slope)
        dx_ref = gch.chain_groupmax_bwd_plain(x, layers, am_ref, g, slope)
        carry = winners(am_ref, k)  # [B, G, K]
        extra = (f"argmax equal except {int((am != am_ref).sum())} of {int(near.sum())} near-tie columns, "
                 f"card picks at most {below:.3e} below the plain max; ")
    else:
        y, y_ref, am_ref = gch.chain_groupmean_fwd(x, layers, slope), gch.chain_groupmean_plain(x, layers, slope), None
        g = (dy * mul / k).contiguous()
        dx = gch.chain_groupmean_bwd(x, layers, g, slope)
        dx_ref = gch.chain_groupmean_bwd_plain(x, layers, g, slope)
        carry = torch.ones(x.shape[:3], dtype=torch.bool, device=x.device)
        extra = ""
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    edge = torch.zeros_like(carry)
    for zl in zs + ([z] if pool == "mean" else []):  # the activated pre-activations
        edge |= (zl.abs() <= EDGE).any(-1)
    edge &= carry
    torch.testing.assert_close(dx[~edge], dx_ref[~edge], **DX_TOL)
    errs = {"y": float((y - y_ref).abs().max()), "dx": float((dx - dx_ref)[~edge].abs().max())}
    log(f"[kernels-curvenet] {pool} {name} x {tuple(x.shape)} chain {[x.shape[-1]] + [l[0].shape[1] for l in layers]} "
        f"slope {slope}: y max|err| {errs['y']:.3e}; {extra}{int(carry.sum())} of {carry.numel()} rows carry a "
        f"cotangent, {int(edge.sum())} of them an activated unit within {EDGE} of 0 (left out); dx max|err| "
        f"{errs['dx']:.3e} (all rows {float((dx - dx_ref).abs().max()):.3e})")
    return errs, am_ref, g, int(carry.sum())


def group_bound(b, g, k, dims, pool, carry=None):
    """(bound_ms, bound_by) of a group chain forward or, with ``carry``
    rows carrying a cotangent, of its backward, counted as ``chain_bound``
    counts them: the forward's chain over every row; the max's backward
    over the winning rows (``chain_bwd_flops``), the mean's over every row,
    recomputed and run back; the pooled output (and the argmax) written or
    read once, dx written once, and the rows read once where a pass needs
    them: the max's one-layer backward (dx = g on the argmax rows times
    W^T) needs none."""
    rows = b * g * k
    out = 4.0 * b * g * dims[-1] * (2 if pool == "max" else 1)
    x_bytes = 4.0 * rows * dims[0]
    if carry is None:
        return bound(chain_flops(rows, dims), x_bytes + out + param_bytes(dims))
    flops = chain_bwd_flops(carry, b * g, dims) if pool == "max" else 2 * chain_flops(rows, dims)
    reads_x = pool == "mean" or len(dims) > 2
    return bound(flops, (2 if reads_x else 1) * x_bytes + out + 2 * param_bytes(dims))


def time_group(name, pool, x, layers, am, g, carry, slope=CN_SLOPE):
    """Group kernel and plain times at one case, and the bounds."""
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    wts = [layer[0].t().contiguous() for layer in layers]
    if pool == "max":
        fns = {"fwd_plain": lambda: gch.chain_groupmax_plain(x, layers, slope),
               "fwd": lambda: gch.chain_groupmax_fwd(x, layers, slope),
               "bwd_plain": lambda: gch.chain_groupmax_bwd_plain(x, layers, am, g, slope),
               "bwd": lambda: gch.chain_groupmax_bwd(x, layers, am, g, slope, wts)}
    else:
        fns = {"fwd_plain": lambda: gch.chain_groupmean_plain(x, layers, slope),
               "fwd": lambda: gch.chain_groupmean_fwd(x, layers, slope),
               "bwd_plain": lambda: gch.chain_groupmean_bwd_plain(x, layers, g, slope),
               "bwd": lambda: gch.chain_groupmean_bwd(x, layers, g, slope, wts)}
    ms = time_pairs(fns)
    b, ng, k, _ = x.shape
    dims = [x.shape[-1]] + [layer[0].shape[1] for layer in layers]
    b_fwd, b_bwd = group_bound(b, ng, k, dims, pool), group_bound(b, ng, k, dims, pool, carry)
    log(f"[kernels-curvenet] {pool} {name} chain {dims}: forward {ms['fwd']:.4f} ms (plain {ms['fwd_plain']:.4f}, "
        f"bound {b_fwd[0]:.5f} by {b_fwd[1]} over {b * ng * k} rows), backward {ms['bwd']:.4f} ms (plain "
        f"{ms['bwd_plain']:.4f}, bound {b_bwd[0]:.5f} by {b_bwd[1]} over the {carry} rows with a cotangent)")
    return ms, b_fwd, b_bwd


def phase_kernels_curvenet():
    """The group chain kernels at the nine LPFA shapes of one CurveNet
    forward (B=8, K=20), then at a ragged G=1000, at K=7 and with a 2-layer
    chain; the record's numbers sum the nine LPFAs of one forward (and
    backward)."""
    import torch

    rec = new_record("group_max_fwd", "group_max_bwd", "group_mean_fwd", "group_mean_bwd")
    for i, (name, (ng, c0, widths, pool)) in enumerate(CURVENET_GROUP_SHAPES.items()):
        x, layers, dy = group_case(60 + i, CN_B, ng, CN_K, (c0, *widths))
        errs, am, g, carry = check_group(name, pool, x, layers, dy)
        ms, b_fwd, b_bwd = time_group(name, pool, x, layers, am, g, carry)
        for key, e, m, p, bb, rows in ((f"group_{pool}_fwd", errs["y"], ms["fwd"], ms["fwd_plain"], b_fwd,
                                        x.shape[0] * ng * CN_K),
                                       (f"group_{pool}_bwd", errs["dx"], ms["bwd"], ms["bwd_plain"], b_bwd, carry)):
            rec[key]["err"] = max(rec[key]["err"], e)
            accumulate(rec[key], m, p, bb, rows)
    for j, (name, b, ng, k, dims) in enumerate((("ragged G=1000", CN_B, 1000, CN_K, (9, 32)),
                                                 ("ragged G=1000", CN_B, 1000, CN_K, (16, 16)),
                                                 ("K=7", 4, 333, 7, (16, 24)),
                                                 ("2 layers", 4, 256, CN_K, (9, 32, 32)),
                                                 ("2 layers", 4, 256, CN_K, (32, 64, 32)))):
        for pool in ("max", "mean"):
            errs, *_ = check_group(name, pool, *group_case(80 + 2 * j + (pool == "mean"), b, ng, k, dims))
            rec[f"group_{pool}_fwd"]["err"] = max(rec[f"group_{pool}_fwd"]["err"], errs["y"])
            rec[f"group_{pool}_bwd"]["err"] = max(rec[f"group_{pool}_bwd"]["err"], errs["dx"])
    torch.cuda.empty_cache()
    return rec


def lpfa_inputs(model, model_fn, data):
    """The (LPFA, x, xyz, idx) of the nine LPFAs of one forward of ``model``
    (the victim behind ``model_fn``), each LPFA's neighbour indices
    computed as it computes them."""
    import torch

    from pointcloudattack_tpu_torch.models.curvenet import LPFA
    from pointcloudattack_tpu_torch.ops.knn import knn

    seen, hooks = [], []
    for m in model.modules():
        if isinstance(m, LPFA):
            hooks.append(m.register_forward_pre_hook(lambda mod, args: seen.append((mod, *args))))
    try:
        with torch.no_grad():
            model_fn(data)
    finally:
        for h in hooks:
            h.remove()
    out = []
    for lpfa, x, xyz, *rest in seen:
        idx = rest[0] if rest and rest[0] is not None else knn(xyz, lpfa.k + 1)[:, :, : lpfa.k]
        out.append((lpfa, x, xyz, idx))
    return out


def lpfa_fused_vs_unfused(inputs):
    """Each LPFA stage both ways at the path's shapes: the neighbour rows,
    then the fused group kernel (and LeakyReLU after the initial block's
    max), against the unfused plain layer (the same rows, matmul, BN,
    LeakyReLU, pool), forward and forward + input backward."""
    import torch

    for i, (lpfa, x, xyz, idx) in enumerate(inputs):
        fused = lambda a, p: lpfa(a, p, idx)  # noqa: E731
        unfused = lambda a, p: lpfa.unfused(lpfa.rows(a, p, idx))  # noqa: E731
        torch.testing.assert_close(fused(x, xyz), unfused(x, xyz), **Y_TOL)
        leaves = [t.clone().requires_grad_(True) if t is not None else None for t in (x, xyz)]
        wrt = [t for t in leaves if t is not None]
        ms = time_pairs({
            "unfused": lambda: unfused(x, xyz), "fused": lambda: fused(x, xyz),
            "fused_fb": lambda: torch.autograd.grad(fused(*leaves).sum(), wrt),
            "unfused_fb": lambda: torch.autograd.grad(unfused(*leaves).sum(), wrt),
        }, reps=10)
        kind = "initial (max)" if lpfa.initial else "residual (mean)"
        log(f"[kernels-curvenet] LPFA {i} {kind} xyz {tuple(xyz.shape)} k={lpfa.k} -> "
            f"{lpfa.mlp[-1][1].num_features}: fused forward {ms['fused']:.4f} ms, unfused plain "
            f"{ms['unfused']:.4f} ms; forward + input backward fused {ms['fused_fb']:.4f} ms, unfused "
            f"{ms['unfused_fb']:.4f} ms")
    torch.cuda.empty_cache()


def phase_parity_curvenet(model_fn, state, data, target):
    """C&W (B=2, 1 x 10) on CurveNet on the card and on the CPU from the
    same weights and noise, the CPU taking the card's discrete choices and
    activation signs (``curvenet_hooks``: the walk's starts and picks, the
    group-max, masked max-pool and head picks, and which side of 0 each
    activation's input lies on) in the attack and at each of the card's
    iterates.  Held: ``success`` identical; at each of the card's iterates
    the logits within LOGP_ATOL and the loss gradient under PointNet++'s
    rule (``hold_grad_parity``).  Logged beside it: per (iterate, cloud),
    how many activation inputs lie on the other side of 0 on the CPU than
    on the card, and the gradient's difference with every choice but those
    signs replayed.  The attacks' iterates are logged, not held: a relative
    gradient difference d moves Adam's steps about lr * d apart."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b = 2
    cfg = CWPerturbConfig(binary_step=1, num_iter=10, kappa=KAPPA, budget=BUDGET)
    noise = torch.from_numpy(np.random.RandomState(5).randn(1, b, N, 3).astype(np.float32))
    cpu_fn = make_model_fn(models.make_model("CurveNet", NUM_CLASSES), state, "cpu")
    its, grads = {"card": [], "cpu": []}, {"card": [], "cpu": []}
    recording = lambda fn, side: recording_fn(fn, its[side], grads[side])  # noqa: E731
    with replay(curvenet_hooks()) as stats:
        res_gpu = build_cw_attack(recording(model_fn, "card"), cfg)(data[:b], target[:b], init_noise=noise.cuda())
        res_cpu = build_cw_attack(recording(cpu_fn, "cpu"), cfg)(data[:b].cpu(), target[:b].cpu(), init_noise=noise)
    if not all(len(v) == cfg.num_iter for v in (*its.values(), *grads.values())):
        raise AssertionError(f"parity-curvenet: recorded {[len(v) for v in its.values()]} iterates and "
                             f"{[len(v) for v in grads.values()]} gradients, expected {cfg.num_iter} each")
    apart = (torch.stack(its["card"]) - torch.stack(its["cpu"])).abs().flatten(2).amax(-1)  # [S, b]
    log(f"[parity-curvenet] card vs CPU, CurveNet B={b} 1x10: success card {res_gpu.success.tolist()} cpu "
        f"{res_cpu.success.tolist()}; best_dist card {res_gpu.best_dist.tolist()} cpu {res_cpu.best_dist.tolist()}; "
        f"iterates max |diff| per step and cloud {[[float(f'{v:.3g}') for v in row] for row in apart]}; in the "
        f"attacks the CPU took the card's choices: {choice_line(stats)}")
    if not torch.equal(res_gpu.success.cpu(), res_cpu.success):
        raise AssertionError("parity-curvenet: success differs between the card and the CPU")
    if not bool(res_cpu.success.any()):
        raise AssertionError("parity-curvenet: the short attack flipped no cloud")
    at, steps, unsigned = [], [], []
    for a in its["card"]:
        steps.append(grad_parity(model_fn, cpu_fn, a.cuda(), data[:b], target[:b], choices=at))
        unsigned.append(grad_parity(model_fn, cpu_fn, a.cuda(), data[:b], target[:b], signs=False)["grad"])
    log(f"[parity-curvenet] at the card's first iterate the CPU took the card's choices: {choice_line(at[0])}")
    flips = torch.stack([sum(n for k in ("sign", "mean") for n in st[k]["other"]) for st in at])  # [S, b]
    unsigned = torch.stack(unsigned)
    near = sum(st[k]["near"] for st in at for k in st)
    log(f"[parity-curvenet] over the {len(at)} iterates, {near} of "
        f"{sum(st[k]['choices'] for st in at for k in st)} choices and activation inputs lay within {TIE_GAP} of a "
        f"tie or of 0 on the CPU ({sum(st[k]['exact'] for st in at for k in st)} exact); activation inputs on the "
        f"other side of 0 than on the card, per iterate and cloud, {flips.tolist()} (each at most "
        f"{max(st[k]['off'] for st in at for k in ('sign', 'mean')):.3e} from 0); with every choice but these signs "
        f"replayed, the loss gradient's relative L2 difference {[[float(f'{v:.3g}') for v in row] for row in unsigned]}"
        f", {float((unsigned <= GRAD_CLEAN).float().mean()):.3f} of the pairs within {GRAD_CLEAN} (of those with no "
        f"input on the other side, {float((unsigned[flips == 0] <= GRAD_CLEAN).float().mean()):.3f})")
    hold_grad_parity("parity-curvenet", steps)


def curvenet_path(name="CurveNet"):
    """The CurveNet victim on bench.py's cw_curvenet clouds, its LPFA stages
    both ways, its counted C&W and GeoA3 attacks, card against CPU and the
    profile; returns the launch counts of C&W and of GeoA3."""
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    data, labels = synthetic_data(8, 1, CN_DATA, "cuda")
    fn, state = make_victim(name, "cuda", data, ("dp1",))
    target = victim_labels(fn, data, labels, "slice-curvenet")
    model = models.make_model(name, NUM_CLASSES)
    model_fn = make_model_fn(model, state, "cuda")  # the victim again, its LPFAs to be timed alone
    with phase_clock("kernels-curvenet (LPFA stages)"):
        lpfa_fused_vs_unfused(lpfa_inputs(model, model_fn, data))
    per_fwd, per_bwd = CN_LAUNCHES
    with phase_clock("slice-curvenet"):
        cw = run_attack("slice-curvenet", fn, data, target, CN_ITER, per_fwd, per_bwd)
    with phase_clock("parity-curvenet"):
        phase_parity_curvenet(fn, state, data, target)
    with phase_clock("profile-curvenet"):
        phase_profile("profile-curvenet", fn, data, target)
    # GeoA3 on CurveNet (BASELINE config 4): bench.py's geoa3 clouds, CE on the log-softmax of the logits
    geo_data, geo_labels = synthetic_data(8, 1, GEO_DATA, "cuda")
    geo_fn, _ = make_victim(name, "cuda", geo_data, ("dp1",))
    logp_fn = lambda x: torch.log_softmax(geo_fn(x), dim=-1)  # noqa: E731
    geo_target = victim_labels(logp_fn, geo_data, geo_labels, "slice-geoa3-curvenet")
    with phase_clock("slice-geoa3-curvenet"):
        geo = run_geoa3("slice-geoa3-curvenet", logp_fn, geo_data, geo_target, per_fwd, per_bwd,
                        CN_GEO_ROUNDS, CN_GEO_ITER)
    return cw, geo


def pn2_path(name):
    """Victim, clean-prediction targets and the counted attack of one
    PointNet++ path; returns (model_fn, state, data, target, launches)."""
    tag = "slice-ssg" if name == "PointNet++Ssg" else "slice-msg"
    data, labels = synthetic_data(8, 2, PN2_DATA[name], "cuda")
    model_fn, state = make_victim(name, "cuda", data, ("drop1", "drop2"))
    target = victim_labels(model_fn, data, labels, tag)
    per_fwd, per_bwd = PN2_LAUNCHES[name]
    launches = run_attack(tag, model_fn, data, target, PN2_ITER, per_fwd, per_bwd)
    return model_fn, state, data, target, launches


def main():
    if not (ROOT / KERNEL_SRC).is_file():
        raise SystemExit(f"chip_smoke: {KERNEL_SRC} not found beside this script; run it from a checkout")
    sys.path.insert(0, str(ROOT))

    t_start = time.perf_counter()
    smi = phase_device()
    import torch

    import pointcloudattack_tpu_torch  # noqa: F401  (TF32 off)
    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    phase_build()
    k = phase_kernels()
    pn2 = phase_kernels_pn2()
    clouds, labels = synthetic_data(NUM_CLASSES, 2, 0, "cuda")
    model_fn, state = make_victim("PointNet", "cuda", clouds, ("dropout",))
    data = clouds[:B]
    target = victim_labels(model_fn, data, labels[:B])
    launches = phase_slice(model_fn, data, target)
    phase_parity(model_fn, state, data, target)
    phase_profile("profile", model_fn, data, target)

    ssg = pn2_path("PointNet++Ssg")
    msg = pn2_path("PointNet++Msg")
    attack_parity("parity-ssg", "PointNet++Ssg", ssg[0], ssg[1], ssg[2], ssg[3], 4, may_part=True)
    phase_parity_msg(*msg[:4])
    phase_profile("profile-ssg", ssg[0], ssg[2], ssg[3])

    # DGCNN: the victim, then its kernels at the path's shapes
    dg_data, dg_labels = synthetic_data(8, 2, DG_DATA, "cuda")
    dg_fn, dg_state = make_victim("DGCNN", "cuda", dg_data, ("dp1", "dp2"))
    dg_target = victim_labels(dg_fn, dg_data, dg_labels, "slice-dgcnn")
    dg_model = models.make_model("DGCNN", NUM_CLASSES)
    make_model_fn(dg_model, dg_state, "cuda")  # loads, moves and freezes it: its EdgeConvs are timed alone
    dg = phase_kernels_dgcnn(dg_model, dg_fn, dg_data)
    # the KNN attack on PointNet (bench.py's knn and knn_r5), then on SSG
    knn_clouds, knn_labels = synthetic_data(NUM_CLASSES, 2, KNN_DATA, "cuda")
    with phase_clock("kernels-chamfer"):
        cham = phase_kernels_chamfer(knn_clouds[:B])
    knn_fn, knn_state = make_victim("PointNet", "cuda", knn_clouds, ("dropout",))
    knn_data = knn_clouds[:B]
    knn_target = victim_labels(knn_fn, knn_data, knn_labels[:B], "slice-knn")
    with phase_clock("slice-knn"):
        knn1 = run_knn("slice-knn", knn_fn, knn_data, knn_target, KNN_ITER, 1,
                       {"chain_fwd": 2}, {"chain_bwd": 2, "min_rows": 1})
        knn5 = run_knn("slice-knn-r5", knn_fn, knn_data, knn_target, KNN_ITER, 5,
                       {"chain_fwd": 2}, {"chain_bwd": 2})
        fwd, step = PN2_LAUNCHES["PointNet++Ssg"]
        knn_ssg = run_knn("slice-knn-ssg", ssg[0], ssg[2], ssg[3], KNN_SSG_ITER, 1,
                          fwd, {**step, "min_rows": 1})
    with phase_clock("parity-knn"):
        phase_parity_knn(knn_fn, knn_state, knn_data, knn_target)
    with phase_clock("slice-dgcnn"):
        dg_launches = run_attack("slice-dgcnn", dg_fn, dg_data, dg_target, DG_ITER,
                                 {"knn": 4, "gather_fwd": 4}, {"gather_bwd": 4})
    with phase_clock("parity-dgcnn"):
        phase_parity_dgcnn(dg_fn, dg_state, dg_data, dg_target)
    with phase_clock("profile-dgcnn"):
        phase_profile("profile-dgcnn", dg_fn, dg_data, dg_target)
    # GeoA3 on PointNet (bench.py's geoa3): its kernels, the counted attack, card against CPU, the profile
    geo_data, geo_labels = synthetic_data(8, 1, GEO_DATA, "cuda")
    with phase_clock("kernels-geoa3"):
        geo = phase_kernels_geoa3(geo_data)
    geo_fn, geo_state = make_victim("PointNet", "cuda", geo_data, ("dropout",))
    geo_target = victim_labels(geo_fn, geo_data, geo_labels, "slice-geoa3")
    with phase_clock("slice-geoa3"):
        geo_launches = run_geoa3("slice-geoa3", geo_fn, geo_data, geo_target, {"chain_fwd": 2}, {"chain_bwd": 2})
    with phase_clock("parity-geoa3"):
        phase_parity_geoa3(geo_fn, geo_state, geo_data, geo_target)
    with phase_clock("profile-geoa3"):
        from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack

        phase_profile("profile-geoa3", geo_fn, geo_data, geo_target,
                      build_geoa3_attack(geo_fn, GeoA3Config(binary_max_steps=1, iter_max_steps=10)), "GeoA3 1x10")
    # CurveNet (bench.py's cw_curvenet; GeoA3 on it, BASELINE config 4): its kernels, then its paths
    with phase_clock("kernels-curvenet"):
        cnk = phase_kernels_curvenet()
    cn_cw, cn_geo = curvenet_path()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pointcloudattack_tpu"))
    if loaded:
        raise AssertionError(f"the JAX side was imported: {loaded}")

    by_path = {"pointnet": {"chain_fwd": launches["fwd"], "chain_bwd": launches["bwd"]},
               "ssg": ssg[4], "msg": msg[4], "dgcnn": dg_launches, "knn": knn1, "knn_r5": knn5,
               "knn_ssg": knn_ssg, "geoa3": geo_launches, "curvenet": cn_cw, "geoa3_curvenet": cn_geo}

    def entry(name, key, source, replaces, launches_, err, ms, plain_ms, bnd, at, rows=None, **extra):
        """``rows``: the chain rows the bound charges (every row forward, the
        winning rows backward); None for the others."""
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "bound_rows": rows, "library_ms": None, "at": at,
                "launches_by_path": {p: c[key] for p, c in by_path.items() if c.get(key)}, **extra}

    ssg_at = "sum over the shapes of one PointNet++ SSG forward (B=16, N=1024)"
    dg_at = "sum over the four EdgeConv stages of one DGCNN forward (B=16, N=1024, k=20)"
    geo_at = f"one GeoA3 iteration's call on PointNet (B=8, N=1024, k={GEO_K})"
    cn_at = {"max": f"the initial LPFA of one CurveNet forward (B={CN_B}, N=1024, K={CN_K}, 9 -> 32)",
             "mean": f"sum over the eight residual LPFAs of one CurveNet forward (B={CN_B}, K={CN_K})"}

    def at_dgcnn(key):
        r = dg[key]
        return {"at_dgcnn": {"at": dg_at, "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                             "bound_by": summed_bound(r)[1], "bound_rows": r["rows"], "max_abs_err": r["err"]}}

    record = {"kernels": [
        entry("chain_maxpool_fwd", "chain_fwd", KERNEL_SRC, TPU_FWD, launches["fwd"], k["err_y"],
              k["fwd"], k["fwd_plain"], k["bound_fwd"], "PointNet spine B=64 N=1024 3-64-128-1024",
              k["rows_fwd"]),
        entry("chain_maxpool_bwd", "chain_bwd", KERNEL_SRC, TPU_BWD, launches["bwd"], k["err_dx"],
              k["bwd"], k["bwd_plain"], k["bound_bwd"], "PointNet spine B=64 N=1024 3-64-128-1024",
              k["rows_bwd"]),
        entry("fps", "fps", FPS_SRC, TPU_FPS, ssg[4]["fps"], pn2["fps"]["err"], pn2["fps"]["ms"],
              pn2["fps"]["plain_ms"], summed_bound(pn2["fps"]), ssg_at),
        entry("gather_chain_fwd", "gather_fwd", GATHER_SRC, TPU_GATHER_FWD, ssg[4]["gather_fwd"],
              pn2["gather_fwd"]["err"], pn2["gather_fwd"]["ms"], pn2["gather_fwd"]["plain_ms"],
              summed_bound(pn2["gather_fwd"]), ssg_at, pn2["gather_fwd"]["rows"], **at_dgcnn("gather_fwd")),
        entry("gather_chain_bwd", "gather_bwd", GATHER_SRC, TPU_GATHER_BWD, ssg[4]["gather_bwd"],
              pn2["gather_bwd"]["err"], pn2["gather_bwd"]["ms"], pn2["gather_bwd"]["plain_ms"],
              summed_bound(pn2["gather_bwd"]), ssg_at, pn2["gather_bwd"]["rows"], **at_dgcnn("gather_bwd")),
        entry("knn", "knn", KNN_SRC, TPU_KNN, dg_launches["knn"], dg["knn"]["err"], dg["knn"]["ms"],
              dg["knn"]["plain_ms"], summed_bound(dg["knn"]), dg_at),
        entry("min_sqdist_rows", "min_rows", CHAMFER_SRC, TPU_CHAMFER, knn1["min_rows"], cham["err"], cham["ms"],
              cham["plain_ms"], cham["bound"], f"B={B} N=M={N}, one KNN iteration's Chamfer on PointNet"),
        *(entry(name, key, src, tpu, geo_launches[key], geo[key]["err"], geo[key]["ms"], geo[key]["plain_ms"],
                summed_bound(geo[key]), geo_at)
          for name, key, src, tpu in (("kappa_knn_mean_fwd", "kappa_fwd", KAPPA_SRC, TPU_KAPPA_FWD),
                                      ("kappa_knn_mean_bwd", "kappa_bwd", KAPPA_SRC, TPU_KAPPA_BWD),
                                      ("min_sqdist_both_fwd", "both_fwd", BOTH_SRC, TPU_BOTH_FWD),
                                      ("min_sqdist_both_bwd", "both_bwd", BOTH_SRC, TPU_BOTH_BWD))),
        *(entry(name, key, GROUP_SRC, tpu, cn_cw[key], cnk[key]["err"], cnk[key]["ms"], cnk[key]["plain_ms"],
                summed_bound(cnk[key]), cn_at[pool], cnk[key]["rows"])
          for name, key, tpu, pool in (("chain_groupmax_fwd", "group_max_fwd", TPU_GROUP_FWD, "max"),
                                       ("chain_groupmax_bwd", "group_max_bwd", TPU_GROUP_BWD, "max"),
                                       ("chain_groupmean_fwd", "group_mean_fwd", TPU_GROUP_MEAN_FWD, "mean"),
                                       ("chain_groupmean_bwd", "group_mean_bwd", TPU_GROUP_BWD, "mean"))),
    ]}
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
