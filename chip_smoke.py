"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

It takes about two minutes, the kernel build included.

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
              the card's picks (``card_picks``): an SSG attack (B=4, 1 x 10)
              from the same weights and noise (success, best distance and
              adversarial clouds; then log-probs and the loss gradient cloud
              by cloud at each of the card's iterates); MSG log-probs and the
              CW-loss input gradient at B=2.
10. profile-ssg  torch.profiler over 10 SSG CW iterations.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel record.  The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
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
    with seeded layers and cotangent."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
    from pointcloudattack_tpu_torch.ops.fps import farthest_point_sample
    from pointcloudattack_tpu_torch.ops.gather import index_points
    from pointcloudattack_tpu_torch.ops.gather_chain import layout_width

    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy((rng.randn(PN2_B, n, 3) * 0.5).astype(np.float32)).cuda()
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
    h = gc.gather_rows(src, ctr, idx, layout)
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
    b_fwd = bound(chain_flops(b * ng * k, dims), io + param_bytes(dims) + 2 * pools)
    b_bwd = bound(chain_bwd_flops(win, b * ng, dims),
                  io + 2 * param_bytes(dims) + 2 * pools + 4.0 * (src.numel() + ctr.numel()))
    log(f"[kernels] gather {name} chain {dims}: forward {ms['fwd']:.4f} ms (plain {ms['fwd_plain']:.4f}, "
        f"bound {b_fwd[0]:.4f} by {b_fwd[1]} over {b * ng * k} rows), backward {ms['bwd']:.4f} ms (plain "
        f"{ms['bwd_plain']:.4f}, bound {b_bwd[0]:.4f} by {b_bwd[1]} over the {win} winning rows)")
    return ms, b_fwd, b_bwd


def phase_kernels_pn2():
    """The PointNet++ path's kernels at its shapes; the record's numbers sum
    the shapes of one SSG forward (and backward)."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import fps as fps_mod

    rec = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}, "rows": 0}
           for k in ("fps", "gather_fwd", "gather_bwd")}

    def add(r, ms, plain_ms, bnd, rows=0):
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bnd[0]
        r["bound_by"][bnd[1]] = r["bound_by"].get(bnd[1], 0.0) + bnd[0]
        r["rows"] += rows

    for n, npoint in FPS_SHAPES:
        xyz = torch.from_numpy((np.random.RandomState(n).randn(PN2_B, n, 3) * 0.5).astype(np.float32)).cuda()
        start = torch.zeros(PN2_B, dtype=torch.int32, device="cuda")
        got = fps_mod.farthest_point_sample(xyz, npoint)
        want = fps_mod.fps_plain(xyz, npoint, start)
        dup = torch.cat([xyz[:, : n // 4]] * 4, dim=1).contiguous()  # every pick ties with its copies
        dup_got = fps_mod.farthest_point_sample(dup, npoint)
        dup_want = fps_mod.fps_plain(dup, npoint, start)
        if not (torch.equal(got, want) and torch.equal(dup_got, dup_want)):
            raise AssertionError(f"FPS kernel differs from the plain version at N={n} npoint={npoint}")
        ms = time_pairs({"plain": lambda: fps_mod.fps_plain(xyz, npoint, start),
                         "kernel": lambda: fps_mod.farthest_point_sample(xyz, npoint)}, reps=10)
        flops = 10.0 * PN2_B * (npoint - 1) * n  # 3 sub, 3 mul, 2 add, min, compare
        t, by = bound(flops, 4.0 * (xyz.numel() + PN2_B + PN2_B * npoint))
        add(rec["fps"], ms["kernel"], ms["plain"], (t, by))
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
                add(rec[key], m, p, bb, rows)
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


def make_victim(name, device, clouds, drops):
    """``name`` with seeded random weights and the BatchNorm statistics of
    ``clouds`` (one train-mode pass at momentum 1): ``(model_fn, state)``.

    At its initial BatchNorm statistics a random victim gives every cloud
    nearly the same logits, and the attack moves none of them; with the
    statistics of the data its logits follow the input.
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


def reset_all():
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import fps as fps_mod
    from pointcloudattack_tpu_torch.ops import gather_chain as gc

    cm.reset_launches()
    fps_mod.reset_launches()
    gc.reset_launches()


def read_all():
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import fps as fps_mod
    from pointcloudattack_tpu_torch.ops import gather_chain as gc

    return {"fps": fps_mod.LAUNCHES["fps"], "gather_fwd": gc.LAUNCHES["fwd"], "gather_bwd": gc.LAUNCHES["bwd"],
            "chain_fwd": cm.LAUNCHES["fwd"], "chain_bwd": cm.LAUNCHES["bwd"]}


def run_attack(tag, model_fn, data, target, num_iter, per_fwd, per_bwd):
    """The counted main-path run (also the warm-up), the checks, then three
    fenced timed reps; returns the launch counts."""
    import torch

    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack

    cfg = CWPerturbConfig(binary_step=BINARY_STEP, num_iter=num_iter, kappa=KAPPA, budget=BUDGET)
    attack = build_cw_attack(model_fn, cfg)
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
    forwards = BINARY_STEP * num_iter + 1  # one per Adam step, one final
    want = {k: 0 for k in launches}
    for k, v in per_fwd.items():
        want[k] = v * forwards
    for k, v in per_bwd.items():
        want[k] = v * BINARY_STEP * num_iter
    log(f"[{tag}] kernel launches during the attack: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")

    adv = res.best_attack
    if tuple(adv.shape) != tuple(data.shape) or not bool(torch.isfinite(adv).all()):
        raise AssertionError("best_attack is not a finite tensor of the input's shape")
    moved = (adv - data).norm(dim=-1).max()
    if float(moved) > BUDGET * (1 + 1e-5):
        raise AssertionError(f"a point moved {float(moved)} > budget {BUDGET}")
    succ = res.success
    if not bool(torch.isfinite(res.best_dist[succ]).all()):
        raise AssertionError("non-finite best_dist on a successful example")
    asr = float(succ.float().mean())
    log(f"[{tag}] ASR {asr:.3f} ({int(succ.sum())}/{b}); max per-point move {float(moved):.4f}; "
        f"mean best L2 of successes {float(res.best_dist[succ].mean()) if asr else float('nan'):.5f}")
    if asr <= 0:
        raise AssertionError("ASR is 0")

    times = [run(2 + i)[1] for i in range(3)]
    tmin, tmean = min(times), sum(times) / len(times)
    log(f"[{tag}] CW {BINARY_STEP}x{num_iter} B={b} N={data.shape[1]}: warm-up {t_warm:.4f} s; "
        f"timed {[round(t, 6) for t in times]} s/batch; min {tmin:.6f} s "
        f"({b / tmin:.3f} clouds/s), mean {tmean:.6f} s ({b / tmean:.3f} clouds/s)")
    return launches


def phase_slice(model_fn, data, target):
    launches = run_attack("slice", model_fn, data, target, NUM_ITER,
                          {"chain_fwd": 2}, {"chain_bwd": 2})
    return {"fwd": launches["chain_fwd"], "bwd": launches["chain_bwd"]}


@contextlib.contextmanager
def card_picks():
    """While open, each max pool run on the card records its picks (every
    pooled column's winning row), and each max pool run on the CPU takes the
    oldest recorded picks in place of its own first argmax, so that card and
    CPU send every column's cotangent to the same row: a column whose two
    best rows lie within f32 rounding otherwise may send it to another point
    on each side.  Yields ``gaps``, a list that gets, for each pool the CPU
    ran, how far below the CPU's own max the taken picks lie, per cloud."""
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import gather_chain as gc

    orig_chain, orig_gather = cm.chain_maxpool_fwd, gc.gather_chain_fwd
    picks, gaps = [], []

    def take(z, axis):  # z: the CPU's pre-pool values, pooled over ``axis``
        pick = picks.pop(0)
        y = z.gather(axis, pick.long().unsqueeze(axis)).squeeze(axis)
        gaps.append((z.amax(axis) - y).flatten(1).amax(1))
        return y, pick

    def chain_fwd(x, layers):
        if x.is_cuda:
            y, idx = orig_chain(x, layers)
            picks.append(idx.cpu())
            return y, idx
        return take(gc._chain(x.float(), layers)[0], 1)

    def gather_fwd(src, centers, idx, layers, layout):
        if src.is_cuda:
            y, am = orig_gather(src, centers, idx, layers, layout)
            picks.append(am.cpu())
            return y, am
        return take(gc._chain(gc.gather_rows(src, centers, idx, layout), layers)[0], 2)

    cm.chain_maxpool_fwd, gc.gather_chain_fwd = chain_fwd, gather_fwd
    try:
        yield gaps
    finally:
        cm.chain_maxpool_fwd, gc.gather_chain_fwd = orig_chain, orig_gather
    if picks:
        raise AssertionError(f"{len(picks)} of the card's max pools found no CPU counterpart")


def logp_ties(logp, target):
    """Per cloud, the smaller of two gaps: between the two best non-target
    log-probs (the untargeted loss follows the first) and between the
    target's and the best other's (success)."""
    import torch

    other = logp.scatter(1, target[:, None], float("-inf"))
    top = other.topk(2, dim=1).values
    real = logp.gather(1, target[:, None])[:, 0]
    return torch.minimum(top[:, 0] - top[:, 1], (real - top[:, 0]).abs())


def grad_parity(model_fn, cpu_fn, adv, ori, target):
    """Log-probs and the CW-loss input gradient (adversarial loss plus 10 x
    the L2 distance, as the attack's first round weighs it) at ``adv``, on
    the card and on the CPU, the CPU taking the card's picks.  Per cloud:
    log-probs max|diff|, the gradient's relative L2 difference, the
    log-prob tie gap (``logp_ties``, on the card) and how far below the
    CPU's max the card's picks lie."""
    import torch

    from pointcloudattack_tpu_torch.losses.adv import untargeted_logits_adv_loss
    from pointcloudattack_tpu_torch.losses.distance import l2_dist

    outs = []
    with card_picks() as gaps:
        for fn, a0, o, t in ((model_fn, adv, ori, target), (cpu_fn, adv.cpu(), ori.cpu(), target.cpu())):
            a = a0.detach().clone().requires_grad_(True)
            logp = fn(a)
            loss = (untargeted_logits_adv_loss(logp, t, KAPPA) + l2_dist(a, o) * 10.0).sum()
            (grad,) = torch.autograd.grad(loss, a)
            outs.append((logp.detach().cpu(), grad.cpu()))
    (lp_gpu, g_gpu), (lp_cpu, g_cpu) = outs
    g_rel = (g_gpu - g_cpu).flatten(1).norm(dim=1) / g_cpu.flatten(1).norm(dim=1)
    return {"lp": (lp_gpu - lp_cpu).abs().amax(1), "grad": g_rel, "tie": logp_ties(lp_gpu, target.cpu()),
            "pick": torch.stack(gaps).amax(0)}


def hold_grad_parity(tag, steps, clean=True):
    """Holds ``grad_parity`` results (one per step): picks within PICK_ATOL
    of the CPU's max and log-probs within LOGP_ATOL everywhere; the gradient
    within GRAD_REL at every (step, cloud) whose log-probs do not tie, and
    with ``clean``, within GRAD_CLEAN at CLEAN_SHARE of them at least."""
    import torch

    lp, g, tie, pick = (torch.stack([s[k] for s in steps]) for k in ("lp", "grad", "tie", "pick"))
    ties = tie <= LOGP_ATOL
    held = g[~ties]
    share = float((held <= GRAD_CLEAN).float().mean()) if held.numel() else 0.0
    log(f"[{tag}] at {len(steps)} input(s) x {g.shape[1]} clouds, card vs CPU (the CPU taking the card's "
        f"picks, which lie at most {float(pick.max()):.3e} below its max): log-probs max|diff| "
        f"{float(lp.max()):.3e}; loss gradient relative L2 difference per step and cloud "
        f"{[[float(f'{v:.3g}') for v in row] for row in g]}; log-prob tie gaps "
        f"{[[round(float(v), 6) for v in row] for row in tie]}; left out as ties (step, cloud): "
        f"{[tuple(ix) for ix in ties.nonzero().tolist()]}; of the other {held.numel()}, max "
        f"{float(held.max()) if held.numel() else float('nan'):.3e} (bound {GRAD_REL}), a share of "
        f"{share:.3f} within {GRAD_CLEAN}")
    if float(pick.max()) > PICK_ATOL or float(lp.max()) > LOGP_ATOL:
        raise AssertionError(f"{tag}: card picks {float(pick.max()):.3e} below the CPU's max (> {PICK_ATOL}) "
                             f"or log-probs {float(lp.max()):.3e} apart (> {LOGP_ATOL})")
    if not held.numel() or float(held.max()) > GRAD_REL:
        raise AssertionError(f"{tag}: loss gradients differ by more than {GRAD_REL} (or every step tied)")
    if clean and share < CLEAN_SHARE:
        raise AssertionError(f"{tag}: only {share:.3f} of the gradients agree within {GRAD_CLEAN}")


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

    def recording(fn, side):
        def run(a):
            if a.requires_grad:  # an Adam step's input (the final re-check is not)
                its[side].append(a.detach().cpu())
                a.register_hook(lambda g: grads[side].append(g.detach().cpu()))
            return fn(a)
        return run

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


def phase_profile(tag, model_fn, data, target):
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
    log(f"[{tag}] CW 1x{iters} B={data.shape[0]} under the profiler: wall {wall * 1e3:.3f} ms; "
        f"{len(kernels)} kernels, {total / 1e3:.3f} ms of kernel time; device busy "
        f"{busy / 1e3:.3f} ms of the {window / 1e3:.3f} ms kernel window "
        f"(idle share {1 - busy / window if window else float('nan'):.3f})")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[{tag}]   {t / 1e3:9.3f} ms  {t / total:6.3f}  x{n:<5d} {name[:90]}")


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

    smi = phase_device()
    import torch

    import pointcloudattack_tpu_torch  # noqa: F401  (TF32 off)

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
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pointcloudattack_tpu"))
    if loaded:
        raise AssertionError(f"the JAX side was imported: {loaded}")

    by_path = {"pointnet": {"chain_fwd": launches["fwd"], "chain_bwd": launches["bwd"]},
               "ssg": ssg[4], "msg": msg[4]}

    def entry(name, key, source, replaces, launches_, err, ms, plain_ms, bnd, at, rows=None):
        """``rows``: the chain rows the bound charges (every row forward, the
        winning rows backward); None for FPS."""
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "bound_rows": rows, "library_ms": None, "at": at,
                "launches_by_path": {p: c[key] for p, c in by_path.items() if key in c}}

    ssg_at = "sum over the shapes of one PointNet++ SSG forward (B=16, N=1024)"

    def pn2_bound(key):
        by = pn2[key]["bound_by"]
        return (pn2[key]["bound_ms"], max(by, key=by.get))

    record = {"kernels": [
        entry("chain_maxpool_fwd", "chain_fwd", KERNEL_SRC, TPU_FWD, launches["fwd"], k["err_y"],
              k["fwd"], k["fwd_plain"], k["bound_fwd"], "PointNet spine B=64 N=1024 3-64-128-1024",
              k["rows_fwd"]),
        entry("chain_maxpool_bwd", "chain_bwd", KERNEL_SRC, TPU_BWD, launches["bwd"], k["err_dx"],
              k["bwd"], k["bwd_plain"], k["bound_bwd"], "PointNet spine B=64 N=1024 3-64-128-1024",
              k["rows_bwd"]),
        entry("fps", "fps", FPS_SRC, TPU_FPS, ssg[4]["fps"], 0.0, pn2["fps"]["ms"],
              pn2["fps"]["plain_ms"], pn2_bound("fps"), ssg_at),
        entry("gather_chain_fwd", "gather_fwd", GATHER_SRC, TPU_GATHER_FWD, ssg[4]["gather_fwd"],
              pn2["gather_fwd"]["err"], pn2["gather_fwd"]["ms"], pn2["gather_fwd"]["plain_ms"],
              pn2_bound("gather_fwd"), ssg_at, pn2["gather_fwd"]["rows"]),
        entry("gather_chain_bwd", "gather_bwd", GATHER_SRC, TPU_GATHER_BWD, ssg[4]["gather_bwd"],
              pn2["gather_bwd"]["err"], pn2["gather_bwd"]["ms"], pn2["gather_bwd"]["plain_ms"],
              pn2_bound("gather_bwd"), ssg_at, pn2["gather_bwd"]["rows"]),
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
