"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

Run from the root of a checkout, on a machine with one H100:

    python3 chip_smoke.py

It takes about sixteen minutes, the kernel build included; SI-query through
DUP-Net (phase 38) takes about two of them.

Phases, each raising on failure (nothing is caught; any failure exits
non-zero and prints no result):

1. device     CUDA present, capability (9, 0); the card's name and power limit.
2. build      nvcc builds the kernels from this checkout's csrc/, one process
              per source, all started together.
3. kernels    the chain + max-pool kernels against their plain PyTorch versions
              at every shape PointNet's paths give them (3 -> 64 -> 128 -> 1024:
              B=64 and B=8 at N=1024, a ragged N=1000, N=512): the forward y
              and picks, the backward's lists stage bit for bit, its rows stage
              and the whole backward, dx 0 on the rows that win no column, two
              backwards bit-equal; then a hub, every row winning and ties.
              Times beside the plain version's, the FP32 and the 3xTF32
              bounds, and each kernel's device time under the profiler.  Then
              the PointNet++ kernels at every shape the SSG and MSG paths give
              them (B=16, N=1024): FPS bit for bit (its device time under the
              profiler beside the wrapper's) and the chain at the group-all
              widths (259 and 643 inputs, N=128), checked and timed as above.
3a. kernels-ballq  the ball route (ops/ball_hoist.py: slots, product, stack
              forward; winners, stack backward, lists, pull, product) at every
              set abstraction of SSG and MSG (B=16, N=1024), at a ragged
              N=1000, at N=100 < K=128, with empty and overfull balls and on a
              cloud snapped to a 1/16 grid: the slots equal query_ball_point's
              bit for bit; the route held to gather_chain.py's plain versions
              under check_gather's rules; each kernel held to its own plain
              version (the winners, reverse lists and pull bit for bit, two
              backwards bit-equal); per launch the route's times beside the
              plain version's and the row kernel's on the same slots, each
              kernel's device time under the profiler beside its plain
              version and the bounds.
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
              a victim made as in phase 4; launch counts of FPS, ball and
              chain kernels, ASR > 0, s/batch over 3 reps after a warm-up; the
              first step's gradient twice on the card, bit-equal.
8. slice-msg  the same on PointNet++ MSG (bench.py's cw_msg clouds).
9. parity-ssg / parity-msg  card against CPU, the CPU's max pools taking
              the card's picks and the sides of 0 of the chains' hidden units
              and of the ReLUs after the pools and in the head (``pick_hooks``,
              ``relu_hooks``): an SSG attack (B=4, 1 x 10)
              from the same weights and noise (success, best distance and
              adversarial clouds; then log-probs and the loss gradient cloud
              by cloud at each of the card's iterates); MSG log-probs and the
              CW-loss input gradient at B=2.
10. profile-ssg, profile-msg  torch.profiler over 10 SSG and 10 MSG CW
              iterations.
11. kernels-knn  the self-kNN kernel bit for bit against its plain version
              at the four EdgeConv inputs of one forward of the DGCNN victim
              (B=16, N=1024, k=20, C=3/64/64/128), at a ragged N=1000, with
              every point 4 times (ties) and at KNN_EDGE_CASES (N=4096; k = 1,
              32, 33, 64, 65 and N; C=1); times beside plain's, the bound and
              each kernel's device time.  Phase 19 adds GeoA3's cached set
              ([8, 1024, 3], k=17) and the CurveNet path its nine kNN inputs
              of one forward (B=8, N=1024/256/64, k=21), checked and timed
              alike.
12. kernels-gather-dgcnn  the one-layer gather max (ops/gather_hoist.py) at the
              four EdgeConv shapes (K=20, the center segment) under
              check_gather's rules, each of its five kernels against its plain
              version (the products within tolerance, the max, the reverse
              lists and the pull bit for bit, two backwards bit-equal), then at
              a ragged N=1000, every point 4 times, a hub point and a negative
              BatchNorm scale; times beside the plain versions', torch.matmul's
              for the products, the bounds and the row kernel the route
              replaced; and each EdgeConv stage fused against the unfused
              plain layer.
13. kernels-chamfer  the row-min kernel bit for bit (mins, argmin, dx) at
              [64,1024,3] x [64,1024,3], at B = 16 and 8, on GeoA3's clouds,
              at a ragged 1000 x 1000 with every y point 4 times and at
              ROWMIN_EDGE_CASES (one cloud, all points equal, rows that
              overflow to +inf, N=300 against M=1000, N=1 against M=4096);
              its device time under the profiler at B = 64, 16 and 8 beside
              the bound and the floor at one operation an issued instruction.
14. slice-knn  the KNN attack on PointNet at bench.py's knn settings (B=64,
              kappa 30, budget 0.18, lr 1e-2, 500 of its 2500 iterations),
              nn_refresh 1 and 5 (knn_r5), then 100 iterations on PointNet++
              SSG (the cw_ssg clouds): exact launch counts, ASR > 0, every point
              within the budget, s/batch over 3 reps after a warm-up; then, as
              a reading, the first step's KNN loss gradient on PointNet twice
              (how many coordinates differ, the first of the chain's and the
              row min's traced ops that parts).
15. parity-knn  KNN on PointNet (B=8, 10 iterations) on the card and on the
              CPU from the same weights and noise: success identical,
              adversarial clouds within 1e-5 but at a few points (at most
              PART_SHARE) that parted where a coordinate's gradient lay
              within rounding of 0.
16. slice-dgcnn  C&W 1 x 100 on DGCNN at bench.py's cw_dgcnn settings (B=16):
              exact launch counts (per forward kNN 4 and the one-layer route's
              product and max 4 each, per backward its lists, pull and product
              4 each), ASR > 0, s/batch; the first step's gradient twice, bit
              for bit or the first traced op that parts.
16a. slice-dgcnn-routes  the same attack through each EdgeConv route in turns,
              3 times each: the one-layer route's kernels, EdgeConv.unfused and
              graph_feature then the group kernel; the route fastest in every
              turn, if one is.
17. parity-dgcnn  DGCNN at B=2, card against CPU, the CPU taking the card's kNN
              indices and max-pool picks (the one-layer route's argmax): log-probs
              and the CW-loss gradient.
18. profile-dgcnn  torch.profiler over 10 DGCNN CW iterations.
19. kernels-geoa3  the curvature (kappa) kernels and the two-direction Chamfer
              kernels against their plain versions on the CPU at GeoA3's shape
              (B=8, N=1024, k=16), at a ragged N=1000 and with exact duplicates,
              the forward's picks and kappa bit for bit, two backwards
              bit-equal; the forward also at the selection's edges
              (KAPPA_EDGE_CASES: k = 1, 63 and 64, N=4096 with every point 4
              times, a hub of 300 copies of one point); the backward alone at
              a hub point and on indices outside the cloud (check_kappa_bwd);
              times beside the plain versions' and the bounds, and each
              kernel's device time under the profiler (both forwards, the
              backwards' stages, the bundle both ways); the given-set forward
              also at KAPPA_IDX_CASES (k = 1, 16, 33, 64 and N = 4096 with
              repeated slots and indices outside the cloud, kappa bit for
              bit) and beside a
              one-element zero_() in one profiler window, the launch floor.
20. slice-geoa3  GeoA3 on PointNet at bench.py's geoa3 settings (B=8, CE, 10
              rounds, 100 of their 500 iterations): exact launch counts, ASR > 0,
              finite clouds, s/batch over 3 reps after a warm-up; then, as a
              reading, the first step's loss gradient twice (how many
              coordinates differ, the first traced op that parts).
21. parity-geoa3  GeoA3 (B=4, 2 x 10) on the card and on the CPU from the same
              weights and start offsets, the CPU on the card's normals: success,
              the kept step and best_loss, the clouds at points that never parted,
              and the loss gradient at each of the card's iterates.
22. profile-geoa3  torch.profiler over 10 GeoA3 iterations.
23. kernels-curvenet  the grouped chain + max and chain + mean kernels against
              their plain versions at the nine LPFA shapes of one CurveNet
              forward (B=8, K=20, LeakyReLU 0.2), at a ragged G=1000, at K=7,
              K=64, widths 3 -> 300 and with 2-layer chains, two backwards
              bit-equal, and for the one-layer mean (its backward's own kernel)
              no unit whose backward mask differs from the forward's sign
              (``mask_flips``), each with its time, the backward's device time,
              the plain version's and the bound; then each LPFA stage of the
              victim on the grouped route and on the gather route against the
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
Phases 28-36 run last, after phases 23-27; after phase 22 come
22a. slice-geoa3-r4  GeoA3 as in phase 20 with the curvature's neighbour set
              cached for 4 iterations (curv_knn_refresh 4): exact launch counts
              (the given-set curvature kernels once an iteration, the selecting
              one once a run, a kNN at each refresh), ASR > 0, s/batch; then,
              as a reading, the first step's gradient on the iterate's own
              set twice (the chain, bundle, kNN and given-set kernels traced).
22b. slice-geoa3-partial  GeoA3's partial mode on the same cell (2 x 100, a
              patch of 16 points every 50 iterations, curv_knn_refresh 4, an
              FPS subsample of 512 for the evaluation): exact launch counts (FPS
              included), ASR > 0, s/batch.
22c. parity-geoa3-refresh  phase 21 at curv_knn_refresh 4, and again with the
              jitter, the CPU also taking the card's cached sets and jitter.
22d. profile-geoa3-r4  torch.profiler over 10 GeoA3 iterations at
              curv_knn_refresh 4.
Phase 19 also holds the curvature kernels on a given neighbour set (a stale
set from the kNN kernel, exact collisions, a ragged N=1000).  CurveNet's
gather route (``fused_gather=True``) adds:
23a. kernels-gather-curvenet  the gather mean (rows activated, LeakyReLU 0.2)
              at the eight residual LPFA shapes of one CurveNet forward (B=8,
              K=20) and the slope-0.2 gather max at the initial LPFA (the
              one-layer route, its kernels checked as in phase 12), then a
              ragged N=1000 and 2-layer chains, under check_group's rules; the LPFA
              stages of phase 23 also run on the gather route.
24a. slice-curvenet-gather  C&W 1 x 100 on CurveNet's gather route: exact launch
              counts (the one-layer route's kernels once and the gather mean 8
              times per forward, likewise per backward, the group kernels 0),
              ASR > 0, then both routes in turns.
25a. parity-curvenet-gather  phase 25 on the gather route, the CPU also taking
              the gather means' signs.
28. spectral  the AOF basis at bench.py's aof shape (B=8, N=1024, m=100, k=30): the
              Chebyshev solve and a dense eigh timed, each one's projector error
              against a float64 dense eigh of the same Laplacian, the CPU's
              Chebyshev basis beside them; held: the card's basis orthonormal,
              its error at most twice the CPU's.  Row 9 at the new kNN inputs:
              AOF's graph ([8,1024,3], k=30) and SIadv's normals ([64,1024,3] and
              [32,1024,3], k=21), bit for bit and timed as in phase 11.
29. slice-aof, slice-taof  AOF and TAOF (targets truth + 1) on PointNet at bench.py's
              aof settings (B=8, seed-1 clouds, 2 x 100, kappa 0, budget 0.45,
              low_pass 100): exact launch counts (405 forwards: row 1's forward
              810, its backward 800, one kNN), ASR > 0, every point within the
              budget, s/batch.
30. parity-aof, parity-taof  each (B=4, 2 x 10) on the card and on the CPU, the CPU
              taking the card's basis (``basis_hooks``): every parting explained
              by a gradient of opposite signs or a switched pick before it
              (``step_partings``), some cloud never parting, and on those success
              identical, best_dist rtol 1e-4, the clouds within 1e-5.
31. profile-aof  torch.profiler over AOF 1 x 10, the basis included.
32. slice-si-ifgm, -r5  SI iFGM at bench.py's si_ifgm settings (B=64, seed-2 clouds, eps
              0.18, step 0.007, 50 steps), normal_refresh 1 and 5: exact launch
              counts (row 1's forward 102, backward 100, kNN 50 or 10), ASR > 0,
              every point within eps, s/batch.
33. parity-si-ifgm  B=4, 10 steps, the CPU taking the card's normals; held as phase 30,
              pred too.
34. profile-si-ifgm  torch.profiler over 10 iFGM steps.
35. slice-si-query, slice-simba, slice-simbapp  SI-query at bench.py's si_query
              settings (B=32, seed-14 clouds, eps 0.18, step 0.32), SimBA and SimBA++
              on its first 8 clouds at the same step: the loop iterations each ran,
              the launches held to them, ASR > 0, the queries per cloud, s/batch.
36. parity-si-query, parity-simba, parity-simbapp  card against CPU, the CPU taking the
              card's normals, ranking, order and draws (``siadv_hooks``): queries,
              pred and success identical, the clouds within 1e-5.
37. kernels-punet  row 2's multi-layer chain + max (3 layers, K=32, ReLU) at PU-Net's four set
              abstractions on the rows of one DUP-Net forward over the si_query clouds (B=32:
              [32,1024,32,3] -> 32,32,64 ... [32,128,32,259] -> 256,256,512), held as phase 23 holds
              it, timed beside plain, its device time and bound, the tile ``_pick_tm`` takes; FPS at
              its four samplings (1024 -> 1024, 512, 256, 128) bit for bit; SOR's kNN (k=3); the
              peak memory of one forward.
38. slice-dupnet  SI-query on PointNet behind DUP-Net (SOR k=2, alpha 1.1, then PU-Net at its
              published widths, seeded weights) at bench.py's si_query settings: exact launch counts
              (a forward: SOR's kNN 1, FPS 4, group max 4, chain 2; the white-box backward: group max
              4, chain 2; SI-query's own kNN), ASR > 0, s/batch of one timed run after the counted
              one (cut from 3); profile-dupnet the idle share of a whole SI-query run through DUP-Net at
              B=32 on the clouds the counted run flipped within one stop-flag chunk.
39. slice-cw-dupnet  C&W through DUP-Net (B=16, 1 x 20, cut from 1 x 200): exact launch counts,
              ASR > 0, s/batch.
40. slice-sor, slice-srs  C&W on PointNet behind SOR and SRS (B=64, 1 x 100, cut from 1 x 200).
41. parity-dupnet  card against CPU through the defenses, the CPU taking the card's choices
              (``dupnet_hooks``: SOR's mask, SRS's draw, PU-Net's FPS picks, ball slots, group-chain
              picks and hidden signs, 3-NN picks, ReLU signs): the upsampled clouds within 1e-4;
              SI-query through DUP-Net (queries, pred, success identical, clouds 1e-5); C&W's
              first-step gradient through DUP-Net, SOR and SRS (1e-5 relative L2 where no tie).
42. cli-defense  the CLI on the card: si-query --defense dupnet on a saved PU-Net state dict,
              cw --defense sor, cw --defense srs, cw --transfer_test --trans_model PointNet,DGCNN,
              and dupnet without --defense_checkpoint refused with the JAX CLI's message.
Each of phases 11-42 prints its seconds.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel record.  The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SRC = "pointcloudattack_tpu_torch/csrc/chain_maxpool.cu"
FPS_SRC = "pointcloudattack_tpu_torch/csrc/fps.cu"
GATHER_SRC = "pointcloudattack_tpu_torch/csrc/gather_chain.cu"
HOIST_SRC = "pointcloudattack_tpu_torch/csrc/gather_hoist.cu"
BALL_SRC = "pointcloudattack_tpu_torch/csrc/ball_hoist.cu"
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
TPU_KAPPA_IDX_FWD = "pointcloudattack_tpu/ops/pallas/kappa_kernel.py:500"
TPU_KAPPA_IDX_BWD = "pointcloudattack_tpu/ops/pallas/kappa_kernel.py:525"
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
# Card against CPU, the CPU taking the card's discrete choices: log-probs,
# and for each step and cloud the loss gradient's relative L2 difference.
# With the max-pool picks alone, 35-50% of an SSG attack's (step, cloud)
# pairs differed by 1e-5 to 1.3e-2 and one by 0.198 (runs of this script on
# an H100): a hidden unit of a winning row, a pooled feature or a head unit
# within rounding of 0 opens on one side only.  The CPU now takes those
# sides from the card too (``pick_hooks``, ``relu_hooks``,
# ``curvenet_hooks``), and every pair of every parity phase agreed within
# 1.3e-6.  Every pair is held within GRAD_CLEAN, which a gather backward
# that dropped, negated or scaled by 1.001 either of its two input
# gradients exceeds on every pair (tests/test_torch_pointnet2.py).  A pair
# whose two best non-target log-probs (or the target's and the best
# other's) lie within LOGP_ATOL may follow another class on either side:
# it is named, left out.
LOGP_ATOL, GRAD_CLEAN = 1e-4, 1e-5
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
# kernel launches per forward and per backward on each path: the ball
# route's three forward and five backward kernels at each neighbourhood set
# abstraction (MSG: each radius)
PN2_LAUNCHES = {
    name: ({"fps": 2, "chain_fwd": 1, **{f"ball_{k}": sas for k in ("slots_fwd", "product_fwd", "stack_fwd")}},
           {"chain_bwd": 1, **{f"ball_{k}": sas for k in ("winners_bwd", "stack_bwd", "lists_bwd", "pull_bwd",
                                                          "product_bwd")}})
    for name, sas in (("PointNet++Ssg", 2), ("PointNet++Msg", 6))
}
# (n, npoint, radius, K, feature width, layout, chain widths) at B=16: every
# ball kernel call of the two paths; the SSG ones make up one SSG forward
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
# The one-layer gather max (ops/gather_hoist.py, DGCNN's EdgeConvs and
# CurveNet's initial LPFA): its kernels' LAUNCHES keys, and cases beyond the
# path's shapes, (seed, B, N, C, C_out, how): "repeat" every point 4 times
# (exact ties between the copies, where am takes the lowest k), "hub" point
# 7 in the first 5 slots of every 4th group (a reverse list of 1,280 entries,
# ties inside the groups), "negative" a BatchNorm scale below 0 in every
# other unit (the compare runs after the affine)
HOIST_KEYS = ("product_fwd", "max_fwd", "lists_bwd", "pull_bwd", "product_bwd")
HOIST_EDGE_CASES = {
    "ragged N=1000": (50, 2, 1000, 64, 64, None),
    "every point 4 times": (51, 2, 1024, 64, 128, "repeat"),
    "hub": (52, 2, 1024, 64, 64, "hub"),
    "negative BN scale": (53, 2, 1024, 128, 256, "negative"),
}
# launches per forward and per backward on slice-dgcnn: 4 kNN, and at each
# EdgeConv the one-layer route's 2 forward and 3 backward kernels
DG_LAUNCHES = ({"knn": 4, "hoist_product_fwd": 4, "hoist_max_fwd": 4},
               {"hoist_lists_bwd": 4, "hoist_pull_bwd": 4, "hoist_product_bwd": 4})
DG_TURNS = 3  # timed runs of each EdgeConv route, in turns
# GeoA3: bench.py's geoa3 cell (bench.py:454-496), PointNet, B=8,
# make_synthetic_clouds(8, 1, 1024, seed=5), CE loss, Chamfer + 0.1 Hausdorff
# + curvature (k=16), 10 binary rounds of 500 iterations, cut to 100
GEO_DATA, GEO_ROUNDS, GEO_ITER, GEO_K = 5, 10, 100, 16
# the same cell with the curvature's neighbour set cached for GEO_REFRESH
# iterations (curv_knn_refresh); and GeoA3's partial mode on it: 2 rounds of
# 100 iterations, a new patch of PARTIAL_RANGE points every PARTIAL_REFRESH
# iterations, evaluated on a farthest-point subsample of PARTIAL_NPOINT
GEO_REFRESH = 4
PARTIAL_ROUNDS, PARTIAL_ITER, PARTIAL_REFRESH, PARTIAL_RANGE, PARTIAL_NPOINT = 2, 100, 50, 16, 512
# the kernels against their plain versions: kappa bit for bit, its
# gradients atol 1e-5 (designed to be bit-equal to the plain version on the
# CPU; the log says whether they are); the two-direction bundle bit for bit
KAPPA_GRAD_ATOL = 1e-5
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
# the max backward at an argmax made to order (max_bwd_case): (name, B, G, K, widths, kind)
MAX_BWD_EDGE_CASES = (("a hub: every column's winner one row", CN_B, 1024, CN_K, (9, 32), "hub"),
                      ("no row wins twice", 2, 50, 64, (9, 32), "distinct"),
                      ("a hub at 3 -> 300, K=33", 1, 7, 33, (3, 300), "hub"))
# The ball kernel at every GATHER_SHAPES set abstraction, then at these
# cases in the same format with a last field for what is done to the cloud: "far" moves
# every fourth center 10 away (an empty ball) with a radius that overfills
# the others, "grid" snaps the cloud to a 1/16 grid, so that many squared
# distances equal the squared radius exactly
BALL_EDGE_SHAPES = {
    "ragged N=1000": (1000, 256, 0.2, 32, 0, "ssg", (32, 64), None),
    "N=100 < K=128": (100, 32, 0.4, 128, 0, "msg", (32, 64), None),
    "empty and overfull": (1024, 128, 1.0, 32, 0, "ssg", (32, 64), "far"),
    "grid 1/16, radius 0.25": (1024, 256, 0.25, 32, 0, "ssg", (32, 64), "grid"),
}
# CurveNet's gather route (fused_gather=True): the initial LPFA's gather max
# (the one-layer route's kernels) and the eight residual LPFAs' gather
# means, per forward and per backward
CN_GATHER_LAUNCHES = ({"knn": 9, "fps": 2, "hoist_product_fwd": 1, "hoist_max_fwd": 1, "gather_mean_fwd": 8},
                      {"hoist_lists_bwd": 1, "hoist_pull_bwd": 1, "hoist_product_bwd": 1, "gather_mean_bwd": 8})
# the residual LPFAs of one CurveNet forward at B=8, K=20: (N, C), one layer C -> C
CURVENET_GATHER_SHAPES = {
    "cic11": (1024, 16), "cic12": (1024, 16), "cic21": (1024, 32), "cic22": (1024, 32),
    "cic31": (256, 64), "cic32": (256, 64), "cic41": (64, 128), "cic42": (64, 128),
}
CN_INITIAL_LAYOUT = (("center", 0, 3), ("pass", 0, 3), ("diff", 0, 3, 0))
TURNS = 2  # timed runs of each arm of a route comparison, in turns (A, B, A, B)
FPS_SHAPES = ((1024, 512), (512, 128))  # (N, npoint) of SSG's (and MSG's) two SAs
CN_FPS_SHAPES = ((1024, 256), (256, 64))  # CurveNet's two samplings (B=8)
# FPS at the kernel's edges, (B, N, npoint, kind): the largest N (16 points
# a lane on 16 warps), npoint = N (every running distance reaches 0), a
# ragged N = 33 (a second warp of one point), a cloud of one repeated point
# (every step ties at 0), one cloud and 64, a given start
FPS_EDGE_CASES = {
    "N=8192": (2, 8192, 512, "random"), "npoint=N": (2, 1024, 1024, "random"), "N=33": (4, 33, 33, "random"),
    "one repeated point": (3, 500, 200, "repeated"), "B=1": (1, 1024, 512, "random"),
    "B=64": (64, 1024, 512, "random"), "given start": (16, 1024, 512, "start"),
}
# the two-direction bundle at its edges, (B, N, M, kind): a hub (every y
# point's nearest is x's point 0, whose backward sums all M terms), and one
# x point against 4096
BOTH_EDGE_CASES = {"hub": (8, 1024, 1024, "hub"), "N=1, M=4096": (2, 1, 4096, "random")}
# the row min (row 6) at its edges, (B, N, M, kind): one cloud; every point
# of x and y one point (every distance 0: argmin 0); rows whose distances
# overflow to +inf (x's odd rows at 1e20, y's first quarter at -1e20: those
# rows' mins +inf and argmin 0, the others' first chunks all +inf); a ragged
# N = 300 against M = 1000 (no multiple of a split's chunks); one x point
# against 4096 y points (four staged tiles)
ROWMIN_EDGE_CASES = {"B=1": (1, 1024, 1024, "random"), "all points equal": (2, 1024, 1024, "equal"),
                     "rows that overflow to +inf": (4, 1024, 1024, "overflow"),
                     "N=300, M=1000": (3, 300, 1000, "random"), "N=1, M=4096": (2, 1, 4096, "random")}
# row 6's batch sizes at N = M = 1024: KNN on PointNet (64), KNN on SSG (16), and 8
ROWMIN_BATCHES = (64, 16, 8)
# row 8b's forward at the widths of the set it is given, (B, N, k): k = 1,
# GeoA3's 16, 33 (a second pass of 32 lanes) and the largest, and the
# largest cloud (its staged points past 48 KB of shared memory), each with
# repeated slots, a row's own index and indices outside the cloud
KAPPA_IDX_CASES = {"k=1": (2, 1000, 1), "k=16": (8, 1024, 16), "k=33": (2, 1000, 33), "k=64": (2, 1024, 64),
                   "N=4096": (2, 4096, 16)}
GROUP_ALL = {"ssg_sa3": (259, 256, 512, 1024), "msg_sa3": (643, 256, 512, 1024)}

# The least time the card could take: NVIDIA's H100 SXM data sheet, FP32
# outside the tensor cores (the kernels run f32 FMAs), dense TF32 on the
# tensor cores (the chain's product stage: three TF32 products a 3xTF32
# multiply-add) and HBM3 bandwidth.
PEAK_FLOPS, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12
# Row 1 (the chain + max pool, ops/chain_maxpool.py) at every shape its
# paths give it, (B, N, dims): PointNet's spine at C&W's and KNN's B=64,
# GeoA3's B=8 (all three paths), a ragged N=1000, GeoA3's partial mode's
# 512-point subsample, DUP-Net's upsampled clouds (SI-query's B=32, N=4 x
# 1024) and SRS's survivors (C&W's B=64, N=1024 - 500); PointNet++'s last
# set abstraction is GROUP_ALL's
CHAIN_SHAPES = {
    "spine B=64": (64, 1024, SPINE), "spine B=8": (8, 1024, SPINE),
    "spine B=8 N=1000": (8, 1000, SPINE), "spine B=8 N=512": (8, 512, SPINE),
    "spine B=32 N=4096": (32, 4096, SPINE), "spine B=64 N=524": (64, 524, SPINE),
}
# edge cases of the backward, (B, N, dims, case): a hub (row 17 wins every
# column of cloud 0), every row winning (N=128 < C_L=1024), ties (each point
# 4 times: the forward picks the lowest copy)
CHAIN_EDGE_CASES = {
    "hub": (4, 1024, SPINE, "hub"), "every row wins": (4, 128, (259, 256, 512, 1024), "every"),
    "ties": (4, 1024, SPINE, "ties"),
}
# the backward's stages, launched once each by every chain_bwd call
CHAIN_BWD_STAGES = ("chain_bwd_lists", "chain_bwd_rows")
# row 9 beyond the paths' shapes, (B, N, C, k): the largest N; k = 1, either
# side of 32 (the bound from the first or second half of the sorted share
# minima) and of 64 (past it, k passes); k = N; one channel
# check_kappa's edge cases of the forward's selection: (B, N, k, copies of each point, copies of point 0)
KAPPA_EDGE_CASES = {"k=1": (2, 1000, 1, 1, 0), "k=63": (2, 1000, 63, 1, 0), "k=64": (2, 1000, 64, 1, 0),
                    "N=4096, every point 4 times": (2, 4096, 16, 4, 0), "a hub of 300 copies": (2, 1024, 16, 1, 300)}
KNN_EDGE_CASES = {"N=4096": (2, 4096, 3, 16), "k=1": (2, 1000, 64, 1), "k=32": (2, 1024, 64, 32),
                  "k=33": (2, 1024, 64, 33), "k=64": (2, 1024, 64, 64), "k=65": (2, 1024, 64, 65),
                  "k=N": (3, 37, 128, 37), "C=1": (2, 777, 1, 20)}


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
    # each w as a PointMLP hands it over: the transposed view of an [out, in] weight
    layers = [(w.t().contiguous().t(), *rest) for w, *rest in seeded_layers(rng, dims, device)]
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
    """The gap between the largest and the second largest along ``dim``;
    infinite where there is one value (no tie is possible)."""
    if x.shape[dim] < 2:
        return x.detach().select(dim, 0).abs() + float("inf")
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


def check_chain(cm, b, n, seed, dims=SPINE, case=None):
    """Kernels against plain at one shape: y within Y_TOL and the same pick
    in every clear column; the backward's lists bit for bit, its rows and
    the whole backward within DX_TOL, exactly 0 on the rows that win no
    column, two backwards bit-equal.  ``case`` edits the input or the
    picks (CHAIN_EDGE_CASES).  Returns (max |dy|, max |ddx|, (x, layers,
    idx_ref, g, winning rows))."""
    import torch

    x, layers, dy = seeded_chain(seed, b, n, dims, "cuda")
    if case == "ties":
        x = torch.cat([x[:, : n // 4]] * 4, dim=1).contiguous()
    y, idx = cm.chain_maxpool_fwd(x, layers)
    y_ref, idx_ref = cm.chain_maxpool_plain(x, layers)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    near = top2_gap(x, layers) <= Y_TOL["atol"]
    wrong = (idx != idx_ref) & ~near
    if int(wrong.sum()):
        raise AssertionError(f"idx differs in {int(wrong.sum())} columns with a clear winner")
    if case == "ties" and int(idx.max()) >= n // 4:
        raise AssertionError("a tie between copies did not take the lowest row")
    if case == "hub":
        idx_ref[0] = 17
    elif case == "every":
        idx_ref = (torch.arange(dims[-1], device="cuda", dtype=torch.int32) % n).repeat(b, 1).contiguous()
    g = (dy * layers[-1][3]).contiguous()
    lists = cm.winner_lists(idx_ref, n)
    for name, got, want in zip(cm.Winners._fields, lists, cm.winner_lists_plain(idx_ref, n)):
        if not torch.equal(got, want):
            raise AssertionError(f"the lists stage's {name} differs from winner_lists_plain")
    dx_rows = cm.winners_bwd(x, layers, lists, g)
    dx = cm.chain_maxpool_bwd(x, layers, idx_ref, g)
    dx2 = cm.chain_maxpool_bwd(x, layers, idx_ref, g)
    dx_ref = cm.chain_maxpool_bwd_plain(x, layers, idx_ref, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx_rows, cm.winners_bwd_plain(x, layers, lists, g), **DX_TOL)
    torch.testing.assert_close(dx, dx_ref, **DX_TOL)
    if not (torch.equal(dx, dx2) and torch.equal(dx, dx_rows)):
        raise AssertionError("two backwards differ")
    win_rows = winners(idx_ref, n)
    if bool(dx[~win_rows].any()):
        raise AssertionError("dx is not 0 on a row that wins no column")
    err_y = float((y - y_ref).abs().max())
    err_dx = float((dx - dx_ref).abs().max())
    win = int(win_rows.sum())
    log(f"[kernels] B={b} N={n} chain {dims}{f' ({case})' if case else ''}: y max|err| {err_y:.3e}; idx equal "
        f"except {int((idx != cm.chain_maxpool_plain(x, layers)[1]).sum())} of {int(near.sum())} near-tie columns "
        f"(top-2 gap <= {Y_TOL['atol']}); lists bit-equal; dx max|err| {err_dx:.3e}, 0 on the losing rows, two "
        f"backwards bit-equal; {win} of {b * n} rows win a column")
    return err_y, err_dx, (x, layers, idx_ref, g, win)


def chain_bound(b, n, dims, win=None):
    """(bound_ms, bound_by) of the forward in FP32, or with ``win`` winning
    rows, of the backward (FP32 FMAs)."""
    if win is not None:
        flops = chain_bwd_flops(win, b, dims)
        nbytes = 4.0 * (2 * b * n * dims[0] + 2 * b * dims[-1]) + 2 * param_bytes(dims)
    else:
        flops = chain_flops(b * n, dims)
        nbytes = 4.0 * (b * n * dims[0] + 2 * b * dims[-1]) + param_bytes(dims)
    return bound(flops, nbytes)


def tc_bound(tc_flops: float, fp32_flops: float, nbytes: float):
    """(bound_ms, bound_by) of work whose ``tc_flops`` run as 3xTF32
    products on the tensor cores (three TF32 products over PEAK_TF32) and
    whose ``fp32_flops`` run on the CUDA cores (over PEAK_FLOPS), or of its
    bytes over the memory rate if they take longer."""
    t_ops = (3 * tc_flops / PEAK_TF32 + fp32_flops / PEAK_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chain_tc_bound(b, n, dims):
    """(bound_ms, bound_by) of the forward as the kernels compute it: the
    last layer's three TF32 products over the tensor cores' rate plus the
    hidden layers' FP32 FMAs, or the bytes if they take longer."""
    return tc_bound(chain_flops(b * n, dims[-2:]), chain_flops(b * n, dims[:-1]),
                    4.0 * (b * n * dims[0] + 2 * b * dims[-1]) + param_bytes(dims))


def device_ms(fn, reps=10):
    """Device time of each kernel ``fn`` launches (once a call), under
    torch.profiler: {kernel name: mean ms a launch}.  At these sizes a
    CUDA-event time of back-to-back calls is the wrappers' host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    sums: dict = {}
    for _ in range(3):  # a profiler run now and then returns no device events: {} only if three do
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
                t, c = sums.get(name, (0.0, 0))
                sums[name] = (t + (e.time_range.end - e.time_range.start) / 1e3, c + 1)
        if sums:
            break
    return {name: t / c for name, (t, c) in sums.items()}


def time_chain(cm, label, x, layers, idx, g, win):
    """Row 1 at one shape: the wrappers' times beside the plain versions'
    (time_pairs), both bounds of the forward and the backward's, and each
    kernel's device time; logs them and returns them."""
    b, n, _ = x.shape
    dims = (x.shape[2], *(layer[0].shape[1] for layer in layers))
    ms = time_pairs({
        "fwd_plain": lambda: cm.chain_maxpool_plain(x, layers),
        "fwd": lambda: cm.chain_maxpool_fwd(x, layers),
        "bwd_plain": lambda: cm.chain_maxpool_bwd_plain(x, layers, idx, g),
        "bwd": lambda: cm.chain_maxpool_bwd(x, layers, idx, g),
    })
    dev_f = device_ms(lambda: cm.chain_maxpool_fwd(x, layers))
    dev_b = device_ms(lambda: cm.chain_maxpool_bwd(x, layers, idx, g))
    bf, bt, bb = chain_bound(b, n, dims), chain_tc_bound(b, n, dims), chain_bound(b, n, dims, win)
    flops = chain_flops(b * n, dims)
    log(f"[kernels] chain {label} [{b},{n},{dims[0]}] {dims}: forward {ms['fwd']:.4f} ms (plain "
        f"{ms['fwd_plain']:.4f}; {flops / ms['fwd'] / 1e9:.2f} TFLOP/s of f32 work; bound {bt[0]:.4f} ms by "
        f"{bt[1]} on the tensor cores' 3xTF32, {bf[0]:.4f} in FP32), device "
        + ", ".join(f"{k} {v:.4f}" for k, v in dev_f.items())
        + f"; backward {ms['bwd']:.4f} ms (plain {ms['bwd_plain']:.4f}, bound {bb[0]:.4f} by {bb[1]} over the "
        f"{win} winning rows), device " + ", ".join(f"{k} {v:.4f}" for k, v in dev_b.items()))
    return {"fwd": ms["fwd"], "fwd_plain": ms["fwd_plain"], "bwd": ms["bwd"], "bwd_plain": ms["bwd_plain"],
            "bound_fwd": bt, "bound_fwd_fp32": bf, "bound_bwd": bb, "device_fwd": dev_f, "device_bwd": dev_b,
            "rows_fwd": b * n, "rows_bwd": win}


def phase_kernels():
    """Row 1 at PointNet's shapes (CHAIN_SHAPES) and its edge cases; times
    at the spine (B=64, B=8) and the ragged N=1000."""
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm

    out = {}
    for i, (label, (b, n, dims)) in enumerate(CHAIN_SHAPES.items()):
        err_y, err_dx, (x, layers, idx, g, win) = check_chain(cm, b, n, seed=i, dims=dims)
        if label != "spine B=8 N=512":
            out[label] = {"err_y": err_y, "err_dx": err_dx, **time_chain(cm, label, x, layers, idx, g, win)}
    for i, (label, (b, n, dims, case)) in enumerate(CHAIN_EDGE_CASES.items()):
        check_chain(cm, b, n, seed=40 + i, dims=dims, case=case)
    return out


def gather_case(seed, n, npoint, radius, k, feat, kind, widths, how=None):
    """src, centers and idx as a set abstraction makes them on the card
    (FPS, then the ball query, whose short balls repeat their first index),
    or as an EdgeConv does (``kind`` "dgcnn"), with seeded layers and
    cotangent; ``how`` as in BALL_EDGE_SHAPES."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point
    from pointcloudattack_tpu_torch.ops.fps import farthest_point_sample
    from pointcloudattack_tpu_torch.ops.gather import index_points
    from pointcloudattack_tpu_torch.ops.gather_chain import layout_width
    from pointcloudattack_tpu_torch.ops.knn import knn

    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy((rng.randn(PN2_B, n, 3) * 0.5).astype(np.float32)).cuda()
    if how == "grid":
        xyz = torch.round(xyz * 16) / 16
    if kind == "dgcnn":  # an EdgeConv: centers are the source rows, idx their kNN
        src = torch.from_numpy(rng.randn(PN2_B, n, feat).astype(np.float32)).cuda() if feat else xyz
        c = src.shape[-1]
        new_xyz, idx, layout = src, knn(src, k), (("diff", 0, c, 0), ("center", 0, c))
        layers = seeded_layers(rng, (2 * c, *widths), "cuda")
        dy = torch.from_numpy(rng.randn(PN2_B, npoint, widths[-1]).astype(np.float32)).cuda()
        return src, new_xyz, idx, layers, layout, dy
    new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint)).contiguous()
    if how == "far":
        new_xyz[:, ::4] += 10.0
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


def check_gather(name, src, ctr, idx, layers, layout, dy, slope=0.0, got=None, bwd=None):
    """Gather kernel (the max) against plain on one case; returns (errors,
    am_ref, g, winning rows).  ``got``, another route's ``(y, am)`` on these
    slots, and ``bwd(am, g)``, its ``(dsrc, dctr)``, hold that route to the
    same rules in place of the index route's kernels."""
    import torch

    from pointcloudattack_tpu_torch.ops import gather_chain as gc
    from pointcloudattack_tpu_torch.ops.chain_maxpool import act

    y, am = got if got is not None else gc.gather_chain_fwd(src, ctr, idx, layers, layout, slope)
    y_ref, am_ref = gc.gather_chain_plain(src, ctr, idx, layers, layout, slope)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    z, _ = gc._chain(gc.gather_rows(src, ctr, idx, layout), layers, slope)
    top = z.topk(2, dim=2).values
    near = (top[:, :, 0] - top[:, :, 1]) <= Y_TOL["atol"]
    wrong = (am != am_ref) & ~near
    if int(wrong.sum()):
        raise AssertionError(f"{name}: argmax differs in {int(wrong.sum())} columns with a clear winner")
    below = float((y_ref - z.gather(2, am.long()[:, :, None]).squeeze(2)).max())
    if below > PICK_ATOL:
        raise AssertionError(f"{name}: a card pick lies {below:.3e} below the plain max (> {PICK_ATOL})")
    del z, top
    g = (dy * layers[-1][3]).contiguous()
    dsrc, dctr = (bwd(am_ref, g) if bwd is not None
                  else gc.gather_chain_bwd(src, ctr, idx, layers, layout, am_ref, g, slope=slope))
    dsrc_ref, dctr_ref = gc.gather_chain_bwd_plain(src, ctr, idx, layers, layout, am_ref, g, slope)
    torch.cuda.synchronize()
    # A winning row (the only rows with a cotangent) whose hidden
    # pre-activation lies within EDGE of 0 may fall on the other side of an
    # activation on either side (sums in another order): the points it
    # gathered (dsrc) and its group (dctr) are left out, and counted.
    win = winners(am_ref, idx.shape[2])
    edge = torch.zeros_like(win)
    h, z = gc.gather_rows(src, ctr, idx, layout), None  # one layer (DGCNN) has no hidden unit
    for w, b_, mean, mul, beta in layers[:-1]:
        z = (h @ w + b_ - mean) * mul + beta
        edge |= (z.abs() <= EDGE).any(-1)
        h = act(z, slope)
    del h, z
    errs = hold_gather_grads(name, f"src {tuple(src.shape)} G={idx.shape[1]} K={idx.shape[2]}: y max|err| "
                             f"{float((y - y_ref).abs().max()):.3e}, argmax equal except {int((am != am_ref).sum())} "
                             f"of {int(near.sum())} near-tie columns; {int(win.sum())} of {win.numel()} rows win a "
                             f"column, {int((edge & win).sum())} of them hold a hidden unit within {EDGE} of 0",
                             idx, edge & win, dsrc, dctr, dsrc_ref, dctr_ref)
    return {"y": float((y - y_ref).abs().max()), **errs}, am_ref, g, int(win.sum())


def hold_gather_grads(name, head, idx, edge, dsrc, dctr, dsrc_ref, dctr_ref):
    """dsrc and dctr within DX_TOL of the plain version's, leaving out the
    points that the ``edge`` rows ``[B, G, K]`` gathered and their groups;
    logs ``head`` and the errors; returns them."""
    import torch

    b, n = dsrc.shape[:2]
    pts = torch.zeros(b * n, dtype=torch.bool, device=idx.device)
    pts[(idx.long() + torch.arange(b, device=idx.device)[:, None, None] * n)[edge]] = True
    pts, grp = pts.view(b, n), edge.any(-1)
    torch.testing.assert_close(dsrc[~pts], dsrc_ref[~pts], **DX_TOL)
    torch.testing.assert_close(dctr[~grp], dctr_ref[~grp], **DX_TOL)
    if not float(dctr_ref.abs().max()) > 0:
        raise AssertionError(f"{name}: dctr is 0 everywhere, so its check sees nothing")
    errs = {"dsrc": float((dsrc - dsrc_ref)[~pts].abs().max()), "dctr": float((dctr - dctr_ref)[~grp].abs().max())}
    off_tol = lambda a, r: int((~torch.isclose(a, r, **DX_TOL)).any(-1).sum())  # noqa: E731
    log(f"[kernels] gather {name}: {head}; dsrc and dctr held on the other {1 - float(pts.float().mean()):.4f} "
        f"of the points and {1 - float(grp.float().mean()):.4f} of the groups: max|err| {errs['dsrc']:.3e} "
        f"and {errs['dctr']:.3e}; beyond the tolerance, all among those left out: {off_tol(dsrc, dsrc_ref)} "
        f"points, {off_tol(dctr, dctr_ref)} groups (all-element max|err| "
        f"{float((dsrc - dsrc_ref).abs().max()):.3e} and {float((dctr - dctr_ref).abs().max()):.3e})")
    return errs


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


def gather_bounds(src, ctr, idx, layout, dims, win):
    """(forward, backward) (bound_ms, bound_by) of the gather max at one
    case: ``gather_fwd_flops`` forward, the ``win`` winning rows backward."""
    b, ng, k = idx.shape
    io = 4.0 * (src.numel() + ctr.numel() + idx.numel())
    pools = 4.0 * b * ng * dims[-1]
    b_fwd = bound(gather_fwd_flops(src.shape[1], b, ng, k, layout, dims), io + param_bytes(dims) + 2 * pools)
    b_bwd = bound(chain_bwd_flops(win, b * ng, dims),
                  io + 2 * param_bytes(dims) + 2 * pools + 4.0 * (src.numel() + ctr.numel()))
    return b_fwd, b_bwd


def time_gather(name, widths, src, ctr, idx, layers, layout, am, g, win, slope=0.0):
    """Gather kernel and plain times at one case, and the bounds."""
    from pointcloudattack_tpu_torch.ops import gather_chain as gc
    from pointcloudattack_tpu_torch.ops import gather_hoist as gh

    wts = [layer[0].t().contiguous() for layer in layers]
    fns = {
        "fwd_plain": lambda: gc.gather_chain_plain(src, ctr, idx, layers, layout, slope),
        "fwd": lambda: gc.gather_chain_fwd(src, ctr, idx, layers, layout, slope),
        "bwd_plain": lambda: gc.gather_chain_bwd_plain(src, ctr, idx, layers, layout, am, g, slope),
        "bwd": lambda: gc.gather_chain_bwd(src, ctr, idx, layers, layout, am, g, wts, slope),
    }
    hoisted = gh.takes(layers, False)
    if hoisted:  # the row kernel too, the route this case took before gather_hoist: the earlier time
        def rows(fn):
            def run():
                with row_route():
                    return fn()
            return run

        fns.update(fwd_rows=rows(fns["fwd"]), bwd_rows=rows(fns["bwd"]))
    ms = time_pairs(fns)
    b, ng, k = idx.shape
    dims = (gc.layout_width(layout), *widths)
    b_fwd, b_bwd = gather_bounds(src, ctr, idx, layout, dims, win)
    rows_note = (lambda key: f", the row kernel {ms[key + '_rows']:.4f}") if hoisted else (lambda key: "")
    log(f"[kernels] gather {name} chain {dims}{' (one layer: gather_hoist)' if hoisted else ''}: forward "
        f"{ms['fwd']:.4f} ms (plain {ms['fwd_plain']:.4f}{rows_note('fwd')}, bound {b_fwd[0]:.4f} by {b_fwd[1]} "
        f"over {b * ng * k} rows), backward {ms['bwd']:.4f} ms (plain {ms['bwd_plain']:.4f}{rows_note('bwd')}, "
        f"bound {b_bwd[0]:.4f} by {b_bwd[1]} over the {win} winning rows)")
    return ms, b_fwd, b_bwd


@contextlib.contextmanager
def row_route():
    """While open, the gather max of one layer runs the row kernel of
    ``csrc/gather_chain.cu`` (its route before ``gather_hoist``), so that
    its time can be taken beside the new kernels' in one run."""
    from pointcloudattack_tpu_torch.ops import gather_hoist as gh

    orig = gh.takes
    gh.takes = lambda layers, pre_act: False
    try:
        yield
    finally:
        gh.takes = orig


def hoist_case(seed, b, n, c, cout, how=None):
    """An EdgeConv's inputs for the one-layer route (src = centers, idx its
    self-kNN, layout diff + center), as ``gather_case`` gives them, with
    ``how`` as in HOIST_EDGE_CASES."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops.knn import knn

    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).cuda()
    if how == "repeat":
        src = torch.cat([src[:, : n // 4]] * 4, 1).contiguous()
    idx = knn(src, DG_K)
    if how == "hub":  # every 4th group takes point 7 in its first 5 slots
        idx[:, ::4, :5] = 7
    layers = seeded_layers(rng, (2 * c, cout), "cuda")
    if how == "negative":
        layers[0][3][::2] *= -1.0
    dy = torch.from_numpy(rng.randn(b, n, cout).astype(np.float32)).cuda()
    return src, src, idx, layers, (("diff", 0, c, 0), ("center", 0, c)), dy


def hoist_parts(src, ctr, idx, layers, layout):
    """The one-layer route's pieces on one case: the products' operand
    pairs, and a function of the products' outputs giving (p, q)."""
    import torch

    from pointcloudattack_tpu_torch.ops import gather_hoist as gh

    b, n, cs = src.shape
    g, cc = ctr.shape[1:]
    c1 = layers[0][0].shape[1]
    ws, wc = gh.split_weight(layers[0][0], layout, cs, cc)
    if gh._shared(src, ctr):
        pairs = [(src.view(b * n, cs), torch.cat([ws, wc], 1))]
        split = lambda outs: (outs[0].view(b, n, 2 * c1)[..., :c1], outs[0].view(b, n, 2 * c1)[..., c1:])  # noqa: E731
    else:
        pairs = [(src.view(b * n, cs), ws), (ctr.view(b * g, cc), wc)]
        split = lambda outs: (outs[0].view(b, n, c1), outs[1].view(b, g, c1))  # noqa: E731
    return pairs, split, ws, wc


def check_hoist(name, src, ctr, idx, layers, layout, dy, tag="kernels-gather-dgcnn"):
    """Each kernel of the one-layer route (``ops/gather_hoist.py``) against
    its plain version on the card, on the same inputs: the products within
    Y_TOL and DX_TOL of ``product_plain``, the max (y and am), the reverse
    lists and the pull bit for bit; then two calls of the whole backward,
    which must give the same bits.  Returns each kernel's max |error|."""
    import torch

    from pointcloudattack_tpu_torch.ops import gather_hoist as gh

    b, n, _ = src.shape
    g, k, c1 = idx.shape[1], idx.shape[2], layers[0][0].shape[1]
    _, bias, mean, mul, beta = layers[0]
    pairs, split, ws, wc = hoist_parts(src, ctr, idx, layers, layout)
    outs = gh.products(pairs, "product_fwd")
    refs = [gh.product_plain(a, w) for a, w in pairs]
    p, q = split(outs)
    y, am = gh.gather_max(p, q, idx, bias, mean, mul, beta)
    y_ref, am_ref = gh.max_plain(p, q, idx, bias, mean, mul, beta)
    start, lst = gh.reverse_lists(idx, n)
    start_ref, lst_ref = gh.lists_plain(idx, n)
    gg = (dy * mul).contiguous()
    dp = gh.pull(start, lst, am, gg, k)
    dp_ref = gh.pull_plain(start, lst, am, gg, k)
    bpairs = [(dp.view(b * n, c1), ws.t()), (gg.view(b * g, c1), wc.t())]
    douts = gh.products(bpairs, "product_bwd")
    drefs = [gh.product_plain(a, w) for a, w in bpairs]
    twice = [gh.hoisted_bwd(src, ctr, idx, layers[0], layout, am, gg) for _ in range(2)]
    torch.cuda.synchronize()
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o, r, **Y_TOL)
    for o, r in zip(douts, drefs):
        torch.testing.assert_close(o, r, **DX_TOL)
    same = {"y": torch.equal(y, y_ref), "am": torch.equal(am, am_ref), "start": torch.equal(start, start_ref),
            "list": torch.equal(lst, lst_ref), "dP": torch.equal(dp, dp_ref),
            "two backwards": all(torch.equal(u, v) for u, v in zip(*twice))}
    if not all(same.values()):
        raise AssertionError(f"{name}: not bit-equal: {[key for key, ok in same.items() if not ok]}")
    if not int(am.max()) > 0 or not float(dp.abs().max()) > 0:
        raise AssertionError(f"{name}: every pick is k=0 or dP is 0, so the checks see little")
    counts = start[:, 1:] - start[:, :-1]
    err = lambda us, vs: max(float((u - v).abs().max()) for u, v in zip(us, vs))  # noqa: E731
    errs = {"product_fwd": err(outs, refs), "max_fwd": float((y - y_ref).abs().max()),
            "lists_bwd": float((lst - lst_ref).abs().max()), "pull_bwd": float((dp - dp_ref).abs().max()),
            "product_bwd": err(douts, drefs)}
    log(f"[{tag}] hoist {name}: src {tuple(src.shape)} G={g} K={k} -> {c1}: products max|err| "
        f"{errs['product_fwd']:.3e} and {errs['product_bwd']:.3e}; y, am, the reverse lists (longest "
        f"{int(counts.max())}, mean {float(counts.float().mean()):.2f}), dP and two backwards bit-equal; "
        f"{int((am > 0).sum())} of {am.numel()} picks past k=0")
    return errs


def hoist_bounds(src, ctr, idx, c1):
    """(bound_ms, bound_by) of each kernel of the one-layer route on one
    case: the products' FMAs and operands; the max's 6 operations a (row,
    unit) and P, Q, idx, y and am once; the lists' count and placement of
    each entry and idx, start and list once; the pull's compare a (list
    entry, unit) and add a pick, reading start, list, am and g once and
    writing dP."""
    from pointcloudattack_tpu_torch.ops import gather_hoist as gh

    b, n, cs = src.shape
    g, cc = ctr.shape[1:]
    e = b * g * idx.shape[2]
    f = 4.0
    if gh._shared(src, ctr):
        prod = bound(2.0 * b * n * cs * 2 * c1, f * (b * n * cs + cs * 2 * c1 + b * n * 2 * c1))
    else:
        prod = bound(2.0 * c1 * (b * n * cs + b * g * cc),
                     f * (b * n * cs + b * g * cc + (cs + cc) * c1 + (b * n + b * g) * c1))
    return {"product_fwd": prod,
            "max_fwd": bound(6.0 * e * c1, f * (b * n * c1 + b * g * c1 + e + 2 * b * g * c1 + 4 * c1)),
            "lists_bwd": bound(2.0 * e, f * (2 * e + b * (n + 1))),
            "pull_bwd": bound(1.0 * e * c1 + b * g * c1, f * (b * (n + 1) + e + 2 * b * g * c1 + b * n * c1)),
            "product_bwd": bound(2.0 * c1 * (b * n * cs + b * g * cc),
                                 f * (b * n * c1 + b * g * c1 + (cs + cc) * c1 + b * n * cs + b * g * cc))}


def time_hoist(tag, name, src, ctr, idx, layers, layout, am, g):
    """Each kernel of the one-layer route beside its plain version (and,
    for the products, ``torch.matmul``, one call a product) on one case;
    returns {key: (ms, plain_ms, library_ms or None, bound)}."""
    import torch

    from pointcloudattack_tpu_torch.ops import gather_hoist as gh

    b, n, _ = src.shape
    ng, k, c1 = idx.shape[1], idx.shape[2], layers[0][0].shape[1]
    _, bias, mean, mul, beta = layers[0]
    pairs, split, ws, wc = hoist_parts(src, ctr, idx, layers, layout)
    p, q = split(gh.products(pairs, "product_fwd"))
    start, lst = gh.reverse_lists(idx, n)
    dp = gh.pull(start, lst, am, g, k)
    bpairs = [(dp.view(b * n, c1), ws.t()), (g.view(b * ng, c1), wc.t())]
    fns = {
        "product_fwd": (lambda: gh.products(pairs, "product_fwd"), lambda: [gh.product_plain(a, w) for a, w in pairs],
                        lambda: [torch.matmul(a, w) for a, w in pairs]),
        "max_fwd": (lambda: gh.gather_max(p, q, idx, bias, mean, mul, beta),
                    lambda: gh.max_plain(p, q, idx, bias, mean, mul, beta), None),
        "lists_bwd": (lambda: gh.reverse_lists(idx, n), lambda: gh.lists_plain(idx, n), None),
        "pull_bwd": (lambda: gh.pull(start, lst, am, g, k), lambda: gh.pull_plain(start, lst, am, g, k), None),
        "product_bwd": (lambda: gh.products(bpairs, "product_bwd"),
                        lambda: [gh.product_plain(a, w) for a, w in bpairs],
                        lambda: [torch.matmul(a, w) for a, w in bpairs]),
    }
    bounds = hoist_bounds(src, ctr, idx, c1)
    out = {}
    for key, (kern, plain, lib) in fns.items():
        ms = time_pairs({"plain": plain, "kernel": kern, **({"library": lib} if lib else {})}, reps=10)
        out[key] = (ms["kernel"], ms["plain"], ms.get("library"), bounds[key])
        log(f"[{tag}] hoist {name} {key}: kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms"
            + (f", torch.matmul {ms['library']:.4f} ms" if lib else "")
            + f", bound {bounds[key][0]:.5f} ms by {bounds[key][1]}")
    return out


def ball_scan_pairs(xyz, ctr, radius, k) -> float:
    """The (ball, point) pairs the ball query must test on these inputs:
    each ball's points in index order up to its K-th member, or all N when
    it holds fewer."""
    import torch

    from pointcloudattack_tpu_torch.ops.ball_query import ball_r2
    from pointcloudattack_tpu_torch.ops.pairwise import pairwise_sqdist

    inside = pairwise_sqdist(ctr[..., :3], xyz) <= float(ball_r2(radius))  # [B, G, N]
    count = inside.int().cumsum(-1)
    n = xyz.shape[1]
    reach = torch.where(count[..., -1] >= k, (count < k).sum(-1) + 1, torch.full_like(count[..., -1], n))
    return float(reach.sum())


BALL_KEYS = ("slots_fwd", "product_fwd", "stack_fwd", "winners_bwd", "stack_bwd", "lists_bwd", "pull_bwd",
             "product_bwd")


def check_ball_kernels(name, src, ctr, idx, layers, layout, am, g, tag="kernels-ballq"):
    """Each kernel of the ball route (``ops/ball_hoist.py``) against its
    plain version on the card, on the same inputs: the products within
    Y_TOL and DX_TOL of ``product_plain``; the stack forward's y within
    Y_TOL, its argmax equal outside near-ties and its hidden signs equal
    wherever the plain pre-activation lies beyond EDGE of 0; the winners,
    the reverse lists and the pull bit for bit; the stack backward's d1
    within DX_TOL (both on the kernel's signs); two calls of the whole
    backward bit-equal.  ``am`` and ``g`` are the backward's picks and
    cotangent.  Returns each kernel's max |error|."""
    import torch

    from pointcloudattack_tpu_torch.ops import ball_hoist as bh
    from pointcloudattack_tpu_torch.ops import gather_hoist as gh
    from pointcloudattack_tpu_torch.ops.chain_maxpool import act
    from pointcloudattack_tpu_torch.ops.gather import index_points
    from pointcloudattack_tpu_torch.ops.gather_hoist import split_weight

    b, n, cs = src.shape
    ng, cc = ctr.shape[1:]
    k = idx.shape[2]
    ws, wc = split_weight(layers[0][0], layout, cs, cc)
    c1 = ws.shape[1]
    pairs = [(src.view(b * n, cs), ws), (ctr.view(b * ng, cc), wc)]
    p, q = (t.clone() for t in gh.products(pairs, "product_fwd", launches=bh.LAUNCHES))
    p_ref, q_ref = (gh.product_plain(a, w) for a, w in pairs)
    p, q = p.view(b, n, c1), q.view(b, ng, c1)
    y, am_k, signs = bh.stack_fwd(p, q, idx, layers)
    y_ref, am_ref, signs_ref = bh.stack_fwd_plain(p, q, idx, layers)
    win = bh.winners(am, k)
    win = bh.Winners(*(t.clone() for t in win))
    win_ref = bh.winners_plain(am, k)
    total = int(win_ref.off[-1])
    start, lst = (t.clone() for t in bh.reverse_lists(idx, win, n))
    start_ref, lst_ref = bh.lists_plain(idx, win_ref, n)
    d1 = bh.stack_bwd(win, am, g, signs, layers, k)[:total].clone()
    d1_ref = bh.stack_bwd_plain(win_ref, am, g, signs, layers, k)
    dp, dq = (t.clone() for t in bh.pull(start, lst, win, d1, n, ng))
    dp_ref, dq_ref = bh.pull_plain(start_ref, lst_ref, win_ref, d1, n, ng)
    bpairs = [(dp.view(b * n, c1), ws.t()), (dq.view(b * ng, c1), wc.t())]
    douts = gh.products(bpairs, "product_bwd", launches=bh.LAUNCHES)
    drefs = [gh.product_plain(a, w) for a, w in bpairs]
    twice = [bh.hoisted_bwd(src, ctr, idx, layers, layout, am, g, signs) for _ in range(2)]
    torch.cuda.synchronize()
    for o, r in zip((p.view(b * n, c1), q.view(b * ng, c1)), (p_ref, q_ref)):
        torch.testing.assert_close(o, r, **Y_TOL)
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    # the plain pre-activations on the same P and Q: near-ties, and the hidden units near 0
    z, sides = index_points(p, idx) + q[:, :, None, :], []
    for i, (w, bb, mean, mul, beta) in enumerate(layers):
        z = ((z if i == 0 else act(z) @ w) + bb - mean) * mul + beta
        if i < len(layers) - 1:
            sides.append(z.abs() <= EDGE)
    near = top2_margin(z, 2) <= Y_TOL["atol"]
    if int(((am_k != am_ref) & ~near).sum()):
        raise AssertionError(f"{name}: the stack's argmax differs in {int(((am_k != am_ref) & ~near).sum())} "
                             f"columns with a clear winner")
    del z
    widths = bh.sign_widths(layers)
    apart = [u != v for u, v in zip(bh.unpack_signs(signs, widths), bh.unpack_signs(signs_ref, widths))]
    off_sign = sum(int((d & ~e).sum()) for d, e in zip(apart, sides))
    flipped = sum(int(d.sum()) for d in apart)
    if off_sign:
        raise AssertionError(f"{name}: {off_sign} hidden signs differ from the plain version's beyond {EDGE} of 0")
    same = {"winners": all(torch.equal(u[: len(v)], v) for u, v in ((win.mask, win_ref.mask), (win.off, win_ref.off),
                                                                    (win.wrow, win_ref.wrow))),
            "start": torch.equal(start, start_ref), "list": torch.equal(lst[:total], lst_ref),
            "dP": torch.equal(dp, dp_ref), "dQ": torch.equal(dq, dq_ref),
            "two backwards": all(torch.equal(u, v) for u, v in zip(*twice))}
    if not all(same.values()):
        raise AssertionError(f"{name}: not bit-equal: {[key for key, ok in same.items() if not ok]}")
    torch.testing.assert_close(d1, d1_ref, **DX_TOL)
    for o, r in zip(douts, drefs):
        torch.testing.assert_close(o, r, **DX_TOL)
    if not float(dp.abs().max()) > 0 or not float(dq.abs().max()) > 0:
        raise AssertionError(f"{name}: dP or dQ is 0 everywhere, so the checks see little")
    err = lambda us, vs: max(float((u - v).abs().max()) for u, v in zip(us, vs))  # noqa: E731
    errs = {"slots_fwd": 0.0, "product_fwd": err((p.view(b * n, c1), q.view(b * ng, c1)), (p_ref, q_ref)),
            "stack_fwd": float((y - y_ref).abs().max()), "winners_bwd": 0.0,
            "stack_bwd": float((d1 - d1_ref).abs().max()),
            "lists_bwd": 0.0, "pull_bwd": 0.0, "product_bwd": err(douts, drefs)}
    counts = start[:, 1:] - start[:, :-1]
    log(f"[{tag}] ball {name}: products max|err| {errs['product_fwd']:.3e} and {errs['product_bwd']:.3e}; stack y "
        f"max|err| {errs['stack_fwd']:.3e}, argmax equal except {int((am_k != am_ref).sum())} of {int(near.sum())} "
        f"near-tie columns, {flipped} hidden signs differ, all within {EDGE} of 0; {total} of {b * ng * k} rows win "
        f"(longest point list {int(counts.max())}); winners, reverse lists, dP, dQ and two backwards bit-equal; d1 "
        f"max|err| {errs['stack_bwd']:.3e}")
    return errs


def check_ball(name, src, ctr, layers, layout, radius, k, dy):
    """The ball route on one case: its slots equal ``query_ball_point``'s
    bit for bit; its forward run again gives the same bits; it holds to
    ``gather_chain.py``'s plain versions under ``check_gather``'s rules (the
    backward on the forward's hidden signs); and each of its kernels holds
    to its plain version (``check_ball_kernels``).  Returns (errors, am_ref,
    g, winning rows, slots)."""
    import torch

    from pointcloudattack_tpu_torch.ops import ball_hoist as bh
    from pointcloudattack_tpu_torch.ops import gather_chain as gc
    from pointcloudattack_tpu_torch.ops.ball_query import ball_r2, query_ball_point
    from pointcloudattack_tpu_torch.ops.pairwise import pairwise_sqdist

    xyz = src[..., :3].contiguous()
    y, am, idx = gc.ball_gather_chain_fwd(src, ctr, xyz, layers, layout, radius, k)
    want = query_ball_point(radius, k, xyz, ctr[..., :3])
    torch.cuda.synchronize()
    if not torch.equal(idx, want):
        bad = (idx != want).any(-1)
        raise AssertionError(f"ball {name}: the kernel's slots differ from query_ball_point's in {int(bad.sum())} "
                             f"of {bad.numel()} balls")
    y2, am2, signs, folded = bh.hoisted_fwd(src, ctr, idx, layers, layout)
    if src.is_cuda and not (torch.equal(y, y2) and torch.equal(am, am2)):  # the CPU's route is gather_chain's
        raise AssertionError(f"ball {name}: the route's forward gave other bits the second time")
    sqr = pairwise_sqdist(ctr[..., :3], xyz)
    r2 = float(ball_r2(radius))
    members = (sqr <= r2).sum(-1)
    log(f"[kernels-ballq] {name}: xyz {tuple(xyz.shape)} G={ctr.shape[1]} radius {radius} K={k}: slots bit-equal "
        f"to query_ball_point's; balls empty {int((members == 0).sum())}, short "
        f"{int(((members > 0) & (members < k)).sum())}, full {int((members >= k).sum())} of {members.numel()}; "
        f"{int((sqr == r2).sum())} (ball, point) pairs exactly on the radius")
    errs, am_ref, g, win = check_gather(f"{name} (ball route)", src, ctr, idx, layers, layout, dy, got=(y, am),
                                        bwd=lambda a, gg: bh.hoisted_bwd(src, ctr, idx, layers, layout, a, gg, signs,
                                                                         0.0, folded))
    errs.update(check_ball_kernels(name, src, ctr, idx, layers, layout, am_ref, g))
    return errs, am_ref, g, win, idx


def ball_bounds(src, ctr, idx, layout, dims, win, pairs):
    """{kernel: (bound_ms, bound_by)} of each kernel of the ball route at one
    case, with ``win`` winning rows and ``pairs`` (ball, point) pairs the
    query tests, and {"fwd", "bwd", "fwd_fp32", "bwd_fp32"}: the route's
    sums.  Products on the tensor cores take three TF32 products over
    PEAK_TF32, the rest over the FP32 peak; each input read once, each
    output written once.  The backward's least work through the last layer
    is one row of W_L a pooled column (FP32), through the other layers a
    product over the winning rows only."""
    b, n, cs = src.shape
    ng, cc = ctr.shape[1:]
    k, f = idx.shape[2], 4.0
    rows, pools, c1, cl = b * ng * k, b * ng, dims[1], dims[-1]
    src_w = sum(s[2] - s[1] for s in layout if s[0] in ("diff", "pass"))
    ctr_w = sum(s[2] - s[1] for s in layout if s[0] in ("diff", "center"))
    words = sum(-(-c // 32) for c in dims[1:-1])
    hoist = 2.0 * c1 * (b * n * src_w + b * ng * ctr_w)
    wbytes = (cs + cc) * c1 * f

    hidden_bwd = sum(2.0 * win * a * c for a, c in zip(dims[1:-2], dims[2:-1]))
    out = {
        "slots_fwd": bound(9.0 * pairs, f * (b * n * 3 + b * ng * 3 + rows)),
        "product_fwd": bound(hoist, f * (b * n * cs + b * ng * cc + (b * n + b * ng) * c1) + wbytes),
        "stack_fwd": tc_bound(chain_flops(rows, dims[1:]), 6.0 * rows * c1,
                              f * ((b * n + b * ng) * c1 + rows + 2 * pools * cl + rows * words)
                              + param_bytes(dims[1:])),
        "winners_bwd": bound(1.0 * pools * cl, f * (pools * cl + pools + 1 + win)),
        "stack_bwd": tc_bound(hidden_bwd, 2.0 * pools * cl * dims[-2] + 2.0 * win * c1,
                              f * (2 * pools * cl + win * (words + 1 + c1)) + param_bytes(dims[1:])),
        "lists_bwd": bound(2.0 * win, f * (2 * win + b * (n + 1) + win)),
        "pull_bwd": bound(2.0 * win * c1, f * (win * c1 + win + b * (n + 1) + pools + (b * n + pools) * c1)),
        "product_bwd": bound(hoist, f * ((b * n + pools) * c1 + b * n * cs + pools * cc) + wbytes),
    }
    out["fwd"] = tc_bound(chain_flops(rows, dims[1:]), 9.0 * pairs + hoist + 6.0 * rows * c1,
                          f * (b * n * (cs + 3) + b * ng * cc + rows * (1 + words) + 2 * pools * cl)
                          + param_bytes(dims))
    out["bwd"] = tc_bound(hidden_bwd, 2.0 * pools * cl * dims[-2] + 2.0 * win * c1 + hoist,
                          f * (2 * pools * cl + rows + win * words + b * n * cs + pools * cc) + param_bytes(dims))
    out["fwd_fp32"] = bound(chain_flops(rows, dims[1:]) + 9.0 * pairs + hoist + 6.0 * rows * c1,
                            f * (b * n * (cs + 3) + b * ng * cc + rows * (1 + words) + 2 * pools * cl)
                            + param_bytes(dims))
    out["bwd_fp32"] = bound(hidden_bwd + 2.0 * pools * cl * dims[-2] + 2.0 * win * c1 + hoist,
                            f * (2 * pools * cl + rows + win * words + b * n * cs + pools * cc) + param_bytes(dims))
    return out


def time_ball(name, widths, src, ctr, layers, layout, radius, k, am, g, win, idx):
    """The ball route at one case, per launch: its forward (slots, product,
    stack) beside the plain version and the row kernel of ``gather_chain.cu``
    on the same slots, computed beforehand (the earlier route's ball kernel
    chose its slots inside its launch; this leaves that query out), its
    backward (winners, stack, lists, pull, product) beside the plain one and
    the row kernel's backward; each stage's device time under the profiler
    beside its plain version (and ``torch.matmul`` for the products); and
    the bounds (``ball_bounds``).  Returns (route times, {kernel: (ms,
    plain_ms, library_ms, bound)}, bounds)."""
    import torch

    from pointcloudattack_tpu_torch.ops import ball_hoist as bh
    from pointcloudattack_tpu_torch.ops import gather_chain as gc
    from pointcloudattack_tpu_torch.ops.gather_hoist import product_plain, split_weight

    xyz = src[..., :3].contiguous()
    b, n, cs = src.shape
    ng, cc = ctr.shape[1:]
    _, _, _, signs, folded = bh.forward(src, ctr, xyz, layers, layout, radius, k)
    wts = [layer[0].t().contiguous() for layer in layers]
    fwd = lambda: bh.forward(src, ctr, xyz, layers, layout, radius, k)  # noqa: E731
    bwd = lambda: bh.hoisted_bwd(src, ctr, idx, layers, layout, am, g, signs, 0.0, folded)  # noqa: E731
    ms = time_pairs({
        "fwd_plain": lambda: gc.ball_gather_chain_plain(src, ctr, xyz, layers, layout, radius, k),
        "fwd": fwd,
        "fwd_rows": lambda: gc._fwd_kernel(src, ctr, idx, layers, layout),
        "bwd_plain": lambda: gc.gather_chain_bwd_plain(src, ctr, idx, layers, layout, am, g),
        "bwd": bwd,
        "bwd_rows": lambda: gc._bwd_kernel(src, ctr, idx, layers, layout, am, g, wts),
    })
    dev_f, dev_b = device_ms(fwd), device_ms(bwd)
    # each stage's plain version on the stage's own inputs, and torch.matmul beside the products
    ws, wc = split_weight(layers[0][0], layout, cs, cc)
    pairs_f = [(src.view(b * n, cs), ws), (ctr.view(b * ng, cc), wc)]
    p, q = product_plain(*pairs_f[0]).view(b, n, -1), product_plain(*pairs_f[1]).view(b, ng, -1)
    win_p = bh.winners_plain(am, k)
    d1 = bh.stack_bwd_plain(win_p, am, g, signs, layers, k)
    start, lst = bh.lists_plain(idx, win_p, n)
    dp, dq = bh.pull_plain(start, lst, win_p, d1, n, ng)
    pairs_b = [(dp.view(b * n, -1), ws.t()), (dq.view(b * ng, -1), wc.t())]
    plain = {
        "slots_fwd": lambda: bh.slots_plain(xyz, ctr, radius, k),
        "product_fwd": lambda: [product_plain(a, w) for a, w in pairs_f],
        "stack_fwd": lambda: bh.stack_fwd_plain(p, q, idx, layers),
        "winners_bwd": lambda: bh.winners_plain(am, k),
        "stack_bwd": lambda: bh.stack_bwd_plain(win_p, am, g, signs, layers, k),
        "lists_bwd": lambda: bh.lists_plain(idx, win_p, n),
        "pull_bwd": lambda: bh.pull_plain(start, lst, win_p, d1, n, ng),
        "product_bwd": lambda: [product_plain(a, w) for a, w in pairs_b],
    }
    library = {"product_fwd": lambda: [torch.matmul(a, w) for a, w in pairs_f],
               "product_bwd": lambda: [torch.matmul(a, w) for a, w in pairs_b]}
    # each stage's kernels by name (the winners stage launches two)
    kernel_names = {"slots_fwd": "slots_kernel", "product_fwd": "product_kernel", "stack_fwd": "stack_fwd_kernel",
                    "winners_bwd": "winners_", "stack_bwd": "stack_bwd_kernel", "lists_bwd": "lists_kernel",
                    "pull_bwd": "pull_kernel", "product_bwd": "product_kernel"}
    dims = (sum(s[2] - s[1] for s in layout), *widths)
    bounds = ball_bounds(src, ctr, idx, layout, dims, win, ball_scan_pairs(xyz, ctr, radius, k))
    stages = {}
    for key in BALL_KEYS:
        dev = dev_f if key.endswith("fwd") else dev_b
        kern = sum(v for name_, v in dev.items() if kernel_names[key] in name_)
        lib = time_ms(library[key], reps=10) if key in library else None
        stages[key] = (kern, time_ms(plain[key], reps=3, warmup=1), lib, bounds[key])
    log(f"[kernels-ballq] {name} chain {dims}: forward {ms['fwd']:.4f} ms (plain {ms['fwd_plain']:.4f}, the row "
        f"kernel on the same slots {ms['fwd_rows']:.4f}; bound {bounds['fwd'][0]:.4f} by {bounds['fwd'][1]} on the "
        f"tensor cores' 3xTF32, {bounds['fwd_fp32'][0]:.4f} in FP32), backward {ms['bwd']:.4f} ms (plain "
        f"{ms['bwd_plain']:.4f}, the row kernel {ms['bwd_rows']:.4f}; bound {bounds['bwd'][0]:.4f} by "
        f"{bounds['bwd'][1]}, {bounds['bwd_fp32'][0]:.4f} in FP32, over the {win} winning rows); device per "
        "stage: " + ", ".join(f"{key} {v[0]:.4f} (plain {v[1]:.4f}"
                              + (f", torch.matmul {v[2]:.4f}" if v[2] is not None else "")
                              + f", bound {v[3][0]:.5f} by {v[3][1]})" for key, v in stages.items()))
    return ms, stages, bounds


def phase_kernels_ballq():
    """The ball route at every set abstraction of one SSG and one MSG forward
    (B=16, N=1024), then at BALL_EDGE_SHAPES; per shape the route's times
    and each kernel's.  The record's numbers sum the shapes of one SSG
    forward (and backward), and of one MSG forward."""
    import torch

    rec = new_record(*BALL_KEYS)
    shapes = {}
    cases = [(name, shape + (None,)) for name, shape in GATHER_SHAPES.items()] + list(BALL_EDGE_SHAPES.items())
    for i, (name, shape) in enumerate(cases):
        src, ctr, _, layers, layout, dy = gather_case(120 + i, *shape)
        radius, k = shape[2], shape[3]
        errs, am, g, win, idx = check_ball(name, src, ctr, layers, layout, radius, k, dy)
        for key in BALL_KEYS:
            rec[key]["err"] = max(rec[key]["err"], errs[key], errs["y"] if key == "stack_fwd" else 0.0,
                                  max(errs["dsrc"], errs["dctr"]) if key == "product_bwd" else 0.0)
        if name in GATHER_SHAPES:
            ms, stages, bounds = time_ball(name, shape[6], src, ctr, layers, layout, radius, k, am, g, win, idx)
            shapes[name] = {"route": ms, "stages": {key: (*v[:3], v[3][0]) for key, v in stages.items()},
                            "bound_fwd": bounds["fwd"][0], "bound_bwd": bounds["bwd"][0],
                            "bound_fwd_fp32": bounds["fwd_fp32"][0], "bound_bwd_fp32": bounds["bwd_fp32"][0],
                            "winning_rows": win}
            if name.startswith("ssg"):  # one SSG forward / backward
                for key, (kms, pms, lms, bnd) in stages.items():
                    accumulate(rec[key], kms, pms, bnd)
                    if lms is not None:
                        rec[key]["library_ms"] = rec[key].get("library_ms", 0.0) + lms
        del src, ctr, layers, am, g, idx
        torch.cuda.empty_cache()
    return rec, shapes


def lpfa_gather_case(seed, b, n, c, k, widths, device="cuda"):
    """A residual LPFA's gather inputs: sources S and centers T ``[b, n,
    c]``, the kNN ``idx [b, n, k]`` of a seeded cloud (each point's own
    row first), seeded layers and cotangent."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops.knn import knn

    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy((rng.randn(b, n, 3) * 0.5).astype(np.float32)).to(device)
    src = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(device)
    ctr = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(device)
    idx = knn(xyz, k + 1)[:, :, :k].contiguous()
    layers = seeded_layers(rng, (c, *widths), device)
    dy = torch.from_numpy(rng.randn(b, n, widths[-1]).astype(np.float32)).to(device)
    return src, ctr, idx, layers, dy


def check_gather_mean(name, src, ctr, idx, layers, layout, dy, slope=CN_SLOPE, pre_act=True):
    """The gather mean kernel against its plain version on one case, both on
    the card, under ``check_group``'s rules: y within Y_TOL; dsrc and dctr
    within DX_TOL, leaving out the points and groups of rows with an
    activated pre-activation within EDGE of 0 (the built rows with
    ``pre_act``, every layer's output), which may take the other slope on
    either side (counted).  Returns (errors, g)."""
    import torch

    from pointcloudattack_tpu_torch.ops import gather_chain as gc
    from pointcloudattack_tpu_torch.ops.chain_maxpool import act

    y = gc.gather_chain_mean_fwd(src, ctr, idx, layers, layout, slope, pre_act)
    y_ref = gc.gather_chain_mean_plain(src, ctr, idx, layers, layout, slope, pre_act)
    k = idx.shape[2]
    g = (dy * layers[-1][3] / k).contiguous()
    dsrc, dctr = gc.gather_chain_mean_bwd(src, ctr, idx, layers, layout, g, slope=slope, pre_act=pre_act)
    dsrc_ref, dctr_ref = gc.gather_chain_mean_bwd_plain(src, ctr, idx, layers, layout, g, slope, pre_act)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    h = gc.gather_rows(src, ctr, idx, layout)
    edge = (h.abs() <= EDGE).any(-1) if pre_act else torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    h = act(h, slope) if pre_act else h
    for w, b_, mean, mul, beta in layers:
        z = (h @ w + b_ - mean) * mul + beta
        edge |= (z.abs() <= EDGE).any(-1)
        h = act(z, slope)
    del h, z
    dims = [gc.layout_width(layout)] + [layer[0].shape[1] for layer in layers]
    errs = hold_gather_grads(f"mean {name}", f"src {tuple(src.shape)} G={idx.shape[1]} K={k} chain {dims} slope "
                             f"{slope} pre_act {pre_act}: y max|err| {float((y - y_ref).abs().max()):.3e}; "
                             f"{int(edge.sum())} of {edge.numel()} rows hold an activated unit within {EDGE} of 0",
                             idx, edge, dsrc, dctr, dsrc_ref, dctr_ref)
    return {"y": float((y - y_ref).abs().max()), **errs}, g


def gather_mean_bounds(src, ctr, idx, layout, dims):
    """(forward, backward) (bound_ms, bound_by) of the gather mean with
    ``pre_act`` (the rows' activation leaves no factoring of the first
    layer): the chain over every row forward; recomputed and run back over
    every row backward; src, centers and idx read once, the pooled output
    written (read, backward) once, dsrc and dctr written once."""
    b, ng, k = idx.shape
    rows = b * ng * k
    io = 4.0 * (src.numel() + ctr.numel() + idx.numel())
    out = 4.0 * b * ng * dims[-1]
    b_fwd = bound(chain_flops(rows, dims), io + out + param_bytes(dims))
    b_bwd = bound(2 * chain_flops(rows, dims), io + out + 4.0 * (src.numel() + ctr.numel()) + 2 * param_bytes(dims))
    return b_fwd, b_bwd


def time_gather_mean(name, src, ctr, idx, layers, layout, g, slope=CN_SLOPE, pre_act=True):
    """Gather mean kernel and plain times at one case, and the bounds."""
    from pointcloudattack_tpu_torch.ops import gather_chain as gc

    wts = [layer[0].t().contiguous() for layer in layers]
    ms = time_pairs({
        "fwd_plain": lambda: gc.gather_chain_mean_plain(src, ctr, idx, layers, layout, slope, pre_act),
        "fwd": lambda: gc.gather_chain_mean_fwd(src, ctr, idx, layers, layout, slope, pre_act),
        "bwd_plain": lambda: gc.gather_chain_mean_bwd_plain(src, ctr, idx, layers, layout, g, slope, pre_act),
        "bwd": lambda: gc.gather_chain_mean_bwd(src, ctr, idx, layers, layout, g, wts, slope, pre_act),
    })
    dims = [gc.layout_width(layout)] + [layer[0].shape[1] for layer in layers]
    b_fwd, b_bwd = gather_mean_bounds(src, ctr, idx, layout, dims)
    b, ng, k = idx.shape
    log(f"[kernels-gather-curvenet] mean {name} chain {dims}: forward {ms['fwd']:.4f} ms (plain "
        f"{ms['fwd_plain']:.4f}, bound {b_fwd[0]:.5f} by {b_fwd[1]} over {b * ng * k} rows), backward "
        f"{ms['bwd']:.4f} ms (plain {ms['bwd_plain']:.4f}, bound {b_bwd[0]:.5f} by {b_bwd[1]})")
    return ms, b_fwd, b_bwd


def phase_kernels_gather_curvenet():
    """The gather kernels on CurveNet's gather route: the mean with
    ``pre_act`` at the eight residual LPFA shapes of one CurveNet forward
    (B=8, K=20, LeakyReLU 0.2), the slope-0.2 max at the initial LPFA (one
    layer: the one-layer route, each of its kernels against its plain
    version too), then both at a ragged N=1000 and with a 2-layer chain;
    the record's numbers sum the eight residual LPFAs (the mean)."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops.knn import knn

    rec = new_record("mean_fwd", "mean_bwd")
    for i, (name, (n, c)) in enumerate(CURVENET_GATHER_SHAPES.items()):
        src, ctr, idx, layers, dy = lpfa_gather_case(140 + i, CN_B, n, c, CN_K, (c,))
        layout = (("diff", 0, c, 0),)
        errs, g = check_gather_mean(name, src, ctr, idx, layers, layout, dy)
        ms, b_fwd, b_bwd = time_gather_mean(name, src, ctr, idx, layers, layout, g)
        rows = CN_B * n * CN_K
        for key, e, m, p, bb in (("mean_fwd", errs["y"], ms["fwd"], ms["fwd_plain"], b_fwd),
                                 ("mean_bwd", max(errs["dsrc"], errs["dctr"]), ms["bwd"], ms["bwd_plain"], b_bwd)):
            rec[key]["err"] = max(rec[key]["err"], e)
            accumulate(rec[key], m, p, bb, rows)
    # the initial LPFA: the points are sources and centers, LeakyReLU 0.2 (one layer: no hidden activation)
    rng = np.random.RandomState(150)
    xyz = torch.from_numpy((rng.randn(CN_B, N, 3) * 0.5).astype(np.float32)).cuda()
    idx = knn(xyz, CN_K + 1)[:, :, :CN_K].contiguous()
    layers = seeded_layers(rng, (9, 32), "cuda")
    dy = torch.from_numpy(rng.randn(CN_B, N, 32).astype(np.float32)).cuda()
    _, am, g, win = check_gather("lpfa (initial, slope 0.2)", xyz, xyz, idx, layers, CN_INITIAL_LAYOUT, dy, CN_SLOPE)
    check_hoist("lpfa (initial)", xyz, xyz, idx, layers, CN_INITIAL_LAYOUT, dy, "kernels-gather-curvenet")
    time_gather("lpfa (initial, slope 0.2)", (32,), xyz, xyz, idx, layers, CN_INITIAL_LAYOUT, am, g, win, CN_SLOPE)
    time_hoist("kernels-gather-curvenet", "lpfa (initial)", xyz, xyz, idx, layers, CN_INITIAL_LAYOUT, am, g)
    # a ragged N=1000 and 2-layer chains, the mean (pre_act) and the slope-0.2 max
    for j, (name, n, c, widths) in enumerate((("ragged N=1000", 1000, 32, (32,)), ("2 layers", 256, 32, (64, 32)))):
        src, ctr, idx, layers, dy = lpfa_gather_case(160 + j, CN_B, n, c, CN_K, widths)
        layout = (("diff", 0, c, 0),)
        errs, _ = check_gather_mean(name, src, ctr, idx, layers, layout, dy)
        rec["mean_fwd"]["err"] = max(rec["mean_fwd"]["err"], errs["y"])
        rec["mean_bwd"]["err"] = max(rec["mean_bwd"]["err"], errs["dsrc"], errs["dctr"])
        pts = src[..., :3].contiguous()
        layers = seeded_layers(np.random.RandomState(170 + j), (9, *widths), "cuda")
        check_gather(f"{name} (slope 0.2)", pts, pts, idx, layers, CN_INITIAL_LAYOUT, dy, CN_SLOPE)
    torch.cuda.empty_cache()
    return rec


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


def knn_case(b, n, c, seed=0):
    """A seeded [b, n, c] input of the kNN kernel on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.RandomState(seed + n + c).randn(b, n, c).astype(np.float32)).cuda()


def time_knn(tag, name, x, k):
    """Row 9 on one input: the indices bit-equal to plain (``check_knn``),
    the wrapper's time beside plain's (``time_pairs``), each kernel's device
    time under the profiler and the bound; logs them and returns them."""
    from pointcloudattack_tpu_torch.ops import knn as knn_mod

    err = check_knn(tag, name, x, k)
    ms = time_pairs({"plain": lambda: knn_mod.knn_plain(x, k), "kernel": lambda: knn_mod.knn(x, k)}, reps=5)
    dev = device_ms(lambda: knn_mod.knn(x, k))
    bnd = knn_bound(*x.shape, k)
    log(f"[{tag}] {name} {tuple(x.shape)} k={k}: kernel {ms['kernel']:.4f} ms (device "
        + ", ".join(f"{n} {v:.4f}" for n, v in dev.items()) + f"), plain {ms['plain']:.4f} ms, bound "
        f"{bnd[0]:.4f} ms by {bnd[1]}")
    return {"err": err, "ms": ms["kernel"], "plain_ms": ms["plain"], "bound_ms": bnd[0], "bound_by": bnd[1],
            "device_ms": dev}


def chamfer_bound(b, n, m, issued=False):
    """(bound_ms, bound_by) of one row min: 8 operations a pair (3
    subtractions, 3 products, 2 sums); x and y read once, mins and argmin
    written once.  ``issued``: the least time at one operation an issued
    FP32 instruction, half the data sheet's rate (which counts an FMA as
    two): the kernel keeps the plain version's rounding with
    ``__fsub_rn``, ``__fmul_rn`` and ``__fadd_rn``, none of which fuse."""
    return bound((2.0 if issued else 1.0) * 8.0 * b * n * m, 4.0 * (3 * b * n + 3 * b * m + 2 * b * n))


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


def check_chamfer(tag, name, x, y, w, grad=True):
    """The row-min kernel against plain on one input: mins and argmin
    bit-equal, and ``dx`` of ``sum(mins * w)`` through autograd (the
    kernel's Function against autograd through the plain version's dense
    ``amin``) bit-equal on rows with one nearest point; where several tie
    (duplicated y points), ``amin`` splits the gradient among them, whose
    sum may round: atol 1e-6 there.  Without ``grad`` (rows whose minimum
    is +inf have no gradient to compare) mins and argmin alone.  Returns
    the measured max |diff| over mins, argmin and dx."""
    import torch

    from pointcloudattack_tpu_torch.ops import chamfer

    if not grad:
        mins, arg = chamfer.min_rows_fwd(x, y)
        mins_p, arg_p = chamfer.min_rows_plain(x, y)
        torch.cuda.synchronize()
        if not (torch.equal(mins, mins_p) and torch.equal(arg, arg_p)):
            raise AssertionError(f"min_sqdist_rows {name}: mins differ in {int((mins != mins_p).sum())} rows, "
                                 f"argmin in {int((arg != arg_p).sum())}")
        inf = torch.isinf(mins)
        log(f"[{tag}] {name} x {tuple(x.shape)} y {tuple(y.shape)}: mins and argmin bit-equal to the plain "
            f"version; {int(inf.sum())} rows at +inf, argmin 0 in {int((arg[inf] == 0).sum())} of them")
        return float((arg.long() - arg_p.long()).abs().max())
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


def fps_case(seed, b, n, kind, device="cuda"):
    """(xyz [B, N, 3], start [B] int32 or None) of an FPS_EDGE_CASES kind:
    a random cloud, one point repeated N times, or a random cloud from a
    given start."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    xyz = np.repeat(rng.randn(b, 1, 3), n, axis=1) if kind == "repeated" else rng.randn(b, n, 3) * 0.5
    start = torch.from_numpy(rng.randint(0, n, size=b).astype(np.int32)).to(device) if kind == "start" else None
    return torch.from_numpy(xyz.astype(np.float32)).to(device), start


def check_fps(tag, name, xyz, npoint, start=None):
    """The FPS kernel against the plain version on one input, bit for bit;
    returns the max |index difference|."""
    import torch

    from pointcloudattack_tpu_torch.ops import fps as fps_mod

    got = fps_mod.farthest_point_sample(xyz, npoint, start)
    zero = torch.zeros(xyz.shape[0], dtype=torch.int32, device=xyz.device)
    want = fps_mod.fps_plain(xyz, npoint, zero if start is None else start)
    err = float((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"FPS kernel differs from the plain version at {name} {tuple(xyz.shape)} -> {npoint} "
                             f"in {int((got != want).sum())} picks")
    log(f"[{tag}] fps {name} {tuple(xyz.shape)} -> {npoint}: bit-equal to the plain version")
    return err


def fps_bound(b, n, npoint):
    """(bound_ms, bound_by) of one FPS: 10 operations a point a step (3
    subtractions, 3 products, 2 sums, a min and a compare); the cloud, start
    and picks moved once."""
    return bound(10.0 * b * (npoint - 1) * n, 4.0 * (3 * b * n + b + b * npoint))


def phase_kernels_pn2():
    """The PointNet++ path's kernels at its shapes; the record's numbers sum
    the shapes of one SSG forward (and backward).  FPS also at CurveNet's two
    shapes (the record's ``shapes``, each with its device time) and at
    FPS_EDGE_CASES."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import fps as fps_mod

    rec = new_record("fps")
    rec["fps"]["device_ms"], rec["fps"]["shapes"] = 0.0, {}
    for what, b, shapes in (("ssg", PN2_B, FPS_SHAPES), ("curvenet", CN_B, CN_FPS_SHAPES)):
        for n, npoint in shapes:
            xyz = torch.from_numpy((np.random.RandomState(n).randn(b, n, 3) * 0.5).astype(np.float32)).cuda()
            start = torch.zeros(b, dtype=torch.int32, device="cuda")
            dup = torch.cat([xyz[:, : n // 4]] * 4, dim=1).contiguous()  # every pick ties with its copies
            err = max(check_fps("kernels", f"{what} N={n}", xyz, npoint),
                      check_fps("kernels", f"{what} N={n}, every point 4 times", dup, npoint))
            ms = time_pairs({"plain": lambda: fps_mod.fps_plain(xyz, npoint, start),
                             "kernel": lambda: fps_mod.farthest_point_sample(xyz, npoint)}, reps=10)
            t, by = fps_bound(b, n, npoint)
            dev = sum(v for k, v in device_ms(lambda: fps_mod.farthest_point_sample(xyz, npoint)).items()
                      if k.startswith("fps_kernel"))
            rec["fps"]["shapes"][f"{what} [{b},{n},3] -> {npoint}"] = {
                "ms": ms["kernel"], "plain_ms": ms["plain"], "device_ms": dev, "bound_ms": t, "max_abs_err": err,
                "us_a_step": dev * 1e3 / (npoint - 1)}
            if what == "ssg":
                rec["fps"]["err"] = max(rec["fps"]["err"], err)
                accumulate(rec["fps"], ms["kernel"], ms["plain"], (t, by))
                rec["fps"]["device_ms"] += dev
            log(f"[kernels] fps {what} [{b},{n},3] -> {npoint}: kernel {ms['kernel']:.4f} ms, device {dev:.4f} ms "
                f"({dev * 1e3 / (npoint - 1):.4f} us a step), plain {ms['plain']:.4f} ms, bound {t:.5f} ms by {by}")
    for j, (name, (b, n, npoint, kind)) in enumerate(FPS_EDGE_CASES.items()):
        xyz, start = fps_case(40 + j, b, n, kind)
        rec["fps"]["err"] = max(rec["fps"]["err"], check_fps("kernels", name, xyz, npoint, start))
    chain = {}
    for i, (name, dims) in enumerate(GROUP_ALL.items()):
        err_y, err_dx, (x, layers, idx, g, win) = check_chain(cm, PN2_B, 128, seed=30 + i, dims=dims)
        chain[name] = {"err_y": err_y, "err_dx": err_dx, **time_chain(cm, name, x, layers, idx, g, win)}
    return rec, chain


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
    from pointcloudattack_tpu_torch.ops import ball_hoist as bh
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import chamfer
    from pointcloudattack_tpu_torch.ops import fps as fps_mod
    from pointcloudattack_tpu_torch.ops import gather_chain as gc
    from pointcloudattack_tpu_torch.ops import gather_hoist as gh
    from pointcloudattack_tpu_torch.ops import group_chain as gch
    from pointcloudattack_tpu_torch.ops import kappa
    from pointcloudattack_tpu_torch.ops import knn as knn_mod

    return {**{f"hoist_{k}": (gh, k) for k in HOIST_KEYS}, **{f"ball_{k}": (bh, k) for k in BALL_KEYS},
            "fps": (fps_mod, "fps"), "gather_fwd": (gc, "fwd"), "gather_bwd": (gc, "bwd"),
            "gather_mean_fwd": (gc, "mean_fwd"), "gather_mean_bwd": (gc, "mean_bwd"),
            "chain_fwd": (cm, "fwd"), "chain_bwd": (cm, "bwd"), "chain_bwd_lists": (cm, "bwd_lists"),
            "chain_bwd_rows": (cm, "bwd_rows"), "knn": (knn_mod, "knn"),
            "min_rows": (chamfer, "min_rows"), "both_fwd": (chamfer, "both_fwd"), "both_bwd": (chamfer, "both_bwd"),
            "kappa_fwd": (kappa, "kappa_fwd"), "kappa_bwd": (kappa, "kappa_bwd"),
            "kappa_idx_fwd": (kappa, "kappa_idx_fwd"), "kappa_idx_bwd": (kappa, "kappa_idx_bwd"),
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


def counted_and_timed(tag, what, attack, data, target, expect, check, reps=3):
    """The counted main-path run (also the warm-up), whose launches must be
    ``expect`` (0 for a kernel it does not name), then ``check(result)``,
    then ``reps`` fenced timed reps; returns the launch counts."""
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
    for k in CHAIN_BWD_STAGES:  # each chain backward launches both of its stages
        want[k] = expect.get("chain_bwd", 0)
    log(f"[{tag}] kernel launches during the attack: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != expected {want}")
    check(res)
    if not reps:
        log(f"[{tag}] {what} B={b} N={data.shape[1]}: warm-up {t_warm:.4f} s")
        return launches
    times = [run(2 + i)[1] for i in range(reps)]
    tmin, tmean = min(times), sum(times) / len(times)
    log(f"[{tag}] {what} B={b} N={data.shape[1]}: warm-up {t_warm:.4f} s; "
        f"timed {[round(t, 6) for t in times]} s/batch; min {tmin:.6f} s "
        f"({b / tmin:.3f} clouds/s), mean {tmean:.6f} s ({b / tmean:.3f} clouds/s)")
    return launches


def cw_attack(model_fn, num_iter):
    """C&W ``BINARY_STEP`` x ``num_iter`` at the headline's kappa and budget."""
    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack

    return build_cw_attack(model_fn, CWPerturbConfig(binary_step=BINARY_STEP, num_iter=num_iter, kappa=KAPPA,
                                                     budget=BUDGET))


def run_attack(tag, model_fn, data, target, num_iter, per_fwd, per_bwd, reps=3):
    """C&W 1 x ``num_iter``, counted and timed (``reps`` timed runs);
    returns the launch counts."""
    import torch

    def check(res):
        succ = res.success
        asr, moved = check_adv(tag, res.best_attack, data, succ)
        if not bool(torch.isfinite(res.best_dist[succ]).all()):
            raise AssertionError("non-finite best_dist on a successful example")
        log(f"[{tag}] ASR {asr:.3f} ({int(succ.sum())}/{len(succ)}); max per-point move {moved:.4f}; "
            f"mean best L2 of successes {float(res.best_dist[succ].mean()):.5f}")

    return counted_and_timed(tag, f"CW {BINARY_STEP}x{num_iter}", cw_attack(model_fn, num_iter), data, target,
                             per_path(BINARY_STEP * num_iter, per_fwd, per_bwd), check, reps)


def in_turns(tag, arms, data, target, num_iter, turns=TURNS):
    """C&W 1 x ``num_iter`` through each of ``arms`` (name -> model_fn, each
    warmed up already) on the same clouds and seeds, timed in turns (A, B,
    A, B, ...), so that the host's drift falls on both alike; logs each
    arm's s/batch min and mean and the ratio of the mins; returns {name:
    [seconds]}."""
    import torch

    attacks = {name: cw_attack(fn, num_iter) for name, fn in arms.items()}
    gen = torch.Generator(device="cuda")
    times = {name: [] for name in arms}
    for t in range(turns):
        for name, attack in attacks.items():
            gen.manual_seed(2 + t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            attack(data, target, generator=gen)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    b = data.shape[0]
    first = list(arms)[0]
    log(f"[{tag}] CW {BINARY_STEP}x{num_iter} B={b} in turns ({', '.join(arms)}, ...): "
        + "; ".join(f"{name} {[round(t, 6) for t in ts]} s/batch, min {min(ts):.6f} ({b / min(ts):.3f} clouds/s), "
                    f"mean {sum(ts) / len(ts):.6f}" for name, ts in times.items())
        + "".join(f"; {name} / {first} min {min(times[name]) / min(times[first]):.4f}" for name in list(arms)[1:]))
    return times


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
    take them on the CPU.  A call whose first tensor argument lies on the card runs
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
            if next(a for a in args if hasattr(a, "is_cuda")).is_cuda:
                out, choice = on_card(orig[kind], *args, **kw)
                queues[kind].append(tuple(c.cpu() for c in choice) if isinstance(choice, tuple) else choice.cpu())
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


def hidden_sides(rows, layers, slope):
    """The last hidden activation of a chain over ``rows [B, G, K, C0]`` on
    the card, a layer at a time (``kernel_rows``), and the sides of 0 of
    its hidden pre-activations, one ``[B, G, K, C_l]`` bool a hidden layer."""
    import torch

    from pointcloudattack_tpu_torch.ops.chain_maxpool import act

    with torch.no_grad():
        h, sides = rows.detach(), []
        for layer in layers[:-1]:
            z = kernel_rows(h, [layer], slope)
            sides.append(z > 0)
            h = act(z, slope)
    return h, sides


def card_chain(rows, layers, slope, y, dim):
    """A fused chain + max's choices on the card, read from the group kernel
    over groups of one row, a layer at a time (``kernel_rows``: the same
    products in the same order as every fused chain kernel): the first row
    of ``rows [B, G, K, C0]`` attaining each pooled column's max over
    ``dim`` (1: the max over G of a chain over points, K being 1; 2: over
    K), held to give the fused op's ``y`` bit for bit, then the sides of 0
    of the hidden pre-activations, one ``[B, G, K, C_l]`` bool a hidden
    layer: ``(picks, *sides)``."""
    import torch

    with torch.no_grad():
        h, sides = hidden_sides(rows, layers, slope)
        z = kernel_rows(h, [layers[-1]], slope)
        z = z[:, :, 0] if dim == 1 else z
        yd = y.detach()
        if not torch.equal(z.amax(dim), yd):
            raise AssertionError(f"the kernels' pre-activations miss the fused pool in "
                                 f"{int((z.amax(dim) != yd).sum())} of {yd.numel()} outputs")
        at = torch.arange(z.shape[dim], device=z.device, dtype=torch.int32).view((-1,) + (1,) * (z.dim() - dim - 1))
        picks = torch.where(z == yd.unsqueeze(dim), at, z.shape[dim]).amin(dim).to(torch.int32)
    return (picks, *sides)


def signed_chain(h, layers, slope, sides):
    """The chain's last pre-activation over ``h``, each hidden layer through
    the activation on the side of 0 that ``sides`` gives (none given: the
    CPU's own sides), with per cloud the gaps to 0 and how far the taken
    sides lie from the CPU's own: ``(z, gaps, offs)``."""
    import torch

    gaps, offs = [], []
    for i, (w, b, mean, mul, beta) in enumerate(layers):
        z = (h @ w + b - mean) * mul + beta
        if i == len(layers) - 1:
            return z, gaps, offs
        zd = z.detach()
        side = sides[i].reshape(zd.shape) if sides else zd > 0
        h = torch.where(side, z, slope * z)
        gaps.append(zd.abs().flatten(1))
        offs.append(torch.where(side != (zd > 0), zd.abs(), 0.0).flatten(1))


def pick_hooks():
    """``replay`` hooks for the fused chain + max ops where the models call
    them: the chain + max over points ("chain": PointNet's and PointNet++'s
    ``PointMLP``), the gather + chain + max ("gather_dgcnn": DGCNN's
    EdgeConvs; "gather_curvenet": CurveNet's initial LPFA on its gather
    route) and its ball route ("ball": PointNet++'s set abstractions).  Each choice is every pooled column's winning row and the
    sides of 0 of the chain's hidden pre-activations (``card_chain``; for
    the chain + max over points, whose last layer runs on the tensor cores,
    and for a gather of one layer, which has no hidden layer, the argmax of
    the op's forward run again, which must give the op's bits; for the ball
    route, whose layers after the first run on the tensor cores, its picks
    and saved hidden signs from its forward run again), and for the ball
    route its slots, which must be the CPU's own.  The CPU
    runs the chain in plain differentiable ops on the card's choices, so
    its backward takes them too.  A column whose two best rows, or a hidden
    unit of a winning row and 0, lie within f32 rounding may otherwise send
    the cotangent elsewhere on each side."""
    import torch

    from pointcloudattack_tpu_torch.models import common
    from pointcloudattack_tpu_torch.models import curvenet as cn
    from pointcloudattack_tpu_torch.models import dgcnn
    from pointcloudattack_tpu_torch.ops import ball_hoist as bh
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import gather_chain as gc
    from pointcloudattack_tpu_torch.ops.ball_query import query_ball_point

    def pooled(z, pick, axis, gaps, offs):
        (y, _), gap, off = pool_at(z, pick, axis)
        b = z.shape[0]
        return y, torch.cat([gap.reshape(b, -1), *gaps], 1), torch.cat([off.reshape(b, -1), *offs], 1)

    def chain_card(orig, x, layers):
        """Row 1's picks from its own forward run again (its last layer runs
        on the tensor cores, no group kernel's product), which must give the
        op's bits; the hidden sides from ``hidden_sides``, the forward's
        f32 arithmetic."""
        y = orig(x, layers)
        with torch.no_grad():
            y2, pick = cm.chain_maxpool_fwd(x.detach().contiguous(), [tuple(t.detach() for t in layer)
                                                                     for layer in layers])
            if not torch.equal(y2, y.detach()):
                raise AssertionError(f"the chain's forward gave other bits the second time in "
                                     f"{int((y2 != y.detach()).sum())} of {y.numel()} outputs")
            _, sides = hidden_sides(x[:, :, None, :], layers, 0.0)
        return y, (pick, *sides)

    def chain(orig, choice, x, layers):
        pick, *sides = choice
        z, gaps, offs = signed_chain(x.float(), layers, 0.0, sides)
        return pooled(z, pick, 1, gaps, offs)

    def gather_card(orig, src, centers, idx, layers, layout, slope=0.0):
        y = orig(src, centers, idx, layers, layout, slope)
        if len(layers) == 1:  # the one-layer route's own picks, read again from its deterministic forward
            with torch.no_grad():
                y2, am = gc.gather_chain_fwd(src.detach().contiguous(), centers.detach().contiguous(),
                                             idx.to(torch.int32).contiguous(),
                                             [tuple(t.detach().contiguous() for t in layers[0])], layout)
            if not torch.equal(y2, y.detach()):
                raise AssertionError(f"the one-layer route's forward gave other bits the second time in "
                                     f"{int((y2 != y.detach()).sum())} of {y.numel()} outputs")
            return y, (am,)
        return y, card_chain(gc.gather_rows(src.detach(), centers.detach(), idx, layout), layers, slope, y, 2)

    def gather(orig, choice, src, centers, idx, layers, layout, slope=0.0):
        pick, *sides = choice
        z, gaps, offs = signed_chain(gc.gather_rows(src, centers, idx, layout), layers, slope, sides)
        return pooled(z, pick, 2, gaps, offs)

    def ball_card(orig, src, centers, xyz, layers, layout, radius, nsample, slope=0.0):
        """The ball route's slots, picks and hidden signs from its own
        forward run again (ops/ball_hoist.py), which must give the op's
        bits."""
        y = orig(src, centers, xyz, layers, layout, radius, nsample, slope)
        with torch.no_grad():
            det = [tuple(t.detach() for t in layer) for layer in layers]
            y2, am, idx, signs, _ = bh.forward(src.detach().contiguous(), centers.detach().contiguous(),
                                               xyz.detach().contiguous(), det, layout, radius, nsample, slope)
        if not torch.equal(y2, y.detach()):
            raise AssertionError(f"the ball route's forward gave other bits the second time in "
                                 f"{int((y2 != y.detach()).sum())} of {y.numel()} outputs")
        return y, (idx, am, *bh.unpack_signs(signs, bh.sign_widths(layers)))

    def ball(orig, choice, src, centers, xyz, layers, layout, radius, nsample, slope=0.0):
        """The card's picks and sides on the CPU's own slots, which must be
        the card's: a cloud with a slot that differs counts 1 in ``off``."""
        slots, pick, *sides = choice
        idx = query_ball_point(radius, nsample, xyz, centers[..., :3])
        z, gaps, offs = signed_chain(gc.gather_rows(src, centers, idx, layout), layers, slope, sides)
        y, gap, off = pooled(z, pick, 2, gaps, offs)
        return y, gap, off + (idx != slots).flatten(1).any(1, keepdim=True).float()

    return {"chain": (common, "mlp_chain_maxpool", chain_card, chain),
            "gather_dgcnn": (dgcnn, "gather_chain_groupmax", gather_card, gather),
            "gather_curvenet": (cn, "gather_chain_groupmax", gather_card, gather),
            "ball": (common, "ball_gather_chain_groupmax", ball_card, ball)}


def relu_hooks():
    """``replay`` hooks for the ReLUs after PointNet's and PointNet++'s fused
    max pools and between the unfused layers of a ``PointMLP`` (PointNet's
    transformers and head: "relu", ``models/common.py::relu``), at the end of
    PointNet's head ("pointnet_relu", ``models/pointnet.py``'s name for it)
    and in PointNet++'s head ("head_relu", ``models/pointnet2.py``'s): the
    side of 0 of each input.  A pooled feature or a head unit within
    rounding of 0 otherwise opens on one side only and moves the whole
    cloud's gradient."""
    import torch

    from pointcloudattack_tpu_torch.models import common
    from pointcloudattack_tpu_torch.models import pointnet as pn
    from pointcloudattack_tpu_torch.models import pointnet2 as pn2

    def card(orig, x):
        return orig(x), x.detach() > 0

    def cpu(orig, pos, x):
        xd = x.detach()
        return torch.where(pos, x, 0.0 * x), xd.abs(), torch.where(pos != (xd > 0), xd.abs(), 0.0)

    return {"relu": (common, "relu", card, cpu), "pointnet_relu": (pn, "relu", card, cpu),
            "head_relu": (pn2, "relu", card, cpu)}


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


def curvenet_hooks(signs=True, gather=False):
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
    slope 1 on one side and the other slope on the other.  With ``gather``
    (CurveNet's gather route), also the gather means' signs ("gmean",
    ``gather_chain_groupmean``: of the built rows before their activation
    and of the layer's output, read as for "mean"); the initial LPFA's max
    there is ``pick_hooks``' "gather_curvenet"."""
    import torch

    from pointcloudattack_tpu_torch.models import curvenet as cn
    from pointcloudattack_tpu_torch.ops import gather_chain as gc
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

    def mean_signs(x, layers, slope, y):
        """The kernel's own pre-activations over the rows ``x``, held to give
        its mean ``y`` bit for bit."""
        z, yd = kernel_rows(x, layers, slope), y.detach()
        mine = sum_neighbours(act(z, slope))
        mine = mine / torch.full_like(mine, x.shape[2])  # a true division, as the kernel's (not by a reciprocal)
        if not torch.equal(mine, yd):
            raise AssertionError(f"the kernel's pre-activations miss its mean in {int((mine != yd).sum())} "
                                 f"of {yd.numel()} outputs, by up to {float((mine - yd).abs().max()):.3e}")
        return z

    def mean_card(orig, x, layers, slope=0.0):
        y = orig(x, layers, slope)
        return y, mean_signs(x, layers, slope, y) > 0

    def gmean_card(orig, src, centers, idx, layers, layout, slope=0.0, pre_act=False):
        y = orig(src, centers, idx, layers, layout, slope, pre_act)
        with torch.no_grad():
            rows = gc.gather_rows(src, centers, idx, layout)
            z = mean_signs(act(rows, slope) if pre_act else rows, layers, slope, y)
        return y, torch.cat([rows > 0, z > 0], -1)

    def gmean_cpu(orig, pos, src, centers, idx, layers, layout, slope=0.0, pre_act=False):
        rows = gc.gather_rows(src, centers, idx, layout)
        c0 = rows.shape[-1]
        if pre_act:
            h, gap0, off0 = signed(pos[..., :c0], rows, slope)
        else:
            h, gap0, off0 = rows, rows.detach().abs(), torch.zeros_like(rows)
        h, gap1, off1 = signed(pos[..., c0:], gch._chain(h, layers, slope)[0], slope)
        return sum_neighbours(h) / idx.shape[2], torch.cat([gap0, gap1], -1), torch.cat([off0, off1], -1)

    def mean_cpu(orig, pos, x, layers, slope=0.0):
        h, gap, off = signed(pos, gch._chain(x, layers, slope)[0], slope)
        return sum_neighbours(h) / x.shape[2], gap, off

    hooks = {"pick": (cn, "hard_pick", same, pick), "starts": (cn, "curve_starts", same, starts),
             "max": (cn, "max_pool", max_card, max_cpu), "group": (gch, "chain_groupmax_fwd", group_card, group_cpu)}
    if signs:
        hooks.update({"sign": (cn, "leaky_relu", sign_card, sign_cpu),
                      "mean": (cn, "mlp_chain_groupmean", mean_card, mean_cpu)})
        if gather:
            hooks["gmean"] = (cn, "gather_chain_groupmean", gmean_card, gmean_cpu)
    return hooks


def knn_hooks(mod=None):
    """``replay`` hooks for the kNN that ``mod`` calls, DGCNN's by default
    (GeoA3's cached curvature sets: ``losses.geometry``) ("knn": each
    point's neighbour indices): the deeper stages' features (or the
    iterates) differ by rounding between the two sides, and a neighbour near
    the k-th may differ.  ``off`` is 1 for each index set the CPU's own
    would change."""
    if mod is None:
        from pointcloudattack_tpu_torch.models import dgcnn as mod

    def card(orig, x, k):
        idx = orig(x, k)
        return idx, idx

    def cpu(orig, idx, x, k):
        return idx, None, (orig(x, k).sort(-1).values != idx.sort(-1).values).any(-1).float()

    return {"knn": (mod, "knn", card, cpu)}


def normal_hooks(geo_mod=None):
    """``replay`` hooks for the normal estimates that ``geo_mod`` calls,
    GeoA3's by default (SIadv's: ``attacks.siadv``) ("normals"): a normal
    of a nearly collinear neighbourhood is ill-conditioned, and the card's
    and the CPU's eigensolvers (their acos and cos) may give it
    differently.  ``off`` is, per cloud, the largest difference of the
    CPU's own normals from the card's."""
    if geo_mod is None:
        from pointcloudattack_tpu_torch.attacks import geoa3 as geo_mod

    def card(orig, pc, k=3):
        nrm = orig(pc, k)
        return nrm, nrm

    def cpu(orig, nrm, pc, k=3):
        return nrm, None, (orig(pc, k) - nrm).abs().flatten(1).amax(1)

    return {"normals": (geo_mod, "estimate_normal", card, cpu)}


def jitter_hooks():
    """``replay`` hooks for GeoA3's tangent-plane jitter ("jitter"): the
    CPU takes the card's draw (its own generator's numbers are others).
    ``off`` is 0: there is no own choice to hold it to."""
    import torch

    from pointcloudattack_tpu_torch.attacks import geoa3 as geo_mod

    def card(orig, pc, *args, **kw):
        jit = orig(pc, *args, **kw)
        return jit, jit

    def cpu(orig, jit, pc, *args, **kw):
        return jit, None, torch.zeros(pc.shape[0])

    return {"jitter": (geo_mod, "estimate_perpendicular_jitter", card, cpu)}


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


def grad_parity(model_fn, cpu_fn, adv, ori, target, loss_fn=cw_loss, choices=None, signs=True, gather=False,
                hooks=None):
    """Log-probs and the input gradient of ``loss_fn`` at ``adv``, on the
    card and on the CPU, the CPU taking the card's max-pool picks
    and their chains' hidden signs (``pick_hooks``) and CurveNet's discrete
    choices, with ``signs`` the signs of the other activations' inputs too
    (``relu_hooks``, ``curvenet_hooks``), through ``replay``, whose
    stats go to the list ``choices`` when given.  Per cloud: log-probs
    max|diff|, the gradient's relative L2 difference, the log-prob tie gap
    (``logp_ties``, on the card) and how far the taken choices lie from the
    CPU's own, at most.  ``hooks``, when given, replaces that set of
    hooks."""
    import torch

    outs = []
    if hooks is None:
        hooks = {**pick_hooks(), **(relu_hooks() if signs else {}), **curvenet_hooks(signs, gather)}
    with replay(hooks) as stats:
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


def hold_grad_parity(tag, steps):
    """Holds ``grad_parity`` results (one per step): the taken choices
    within PICK_ATOL of the CPU's own and log-probs within LOGP_ATOL
    everywhere; the gradient within GRAD_CLEAN at every (step, cloud) whose
    log-probs do not tie."""
    import torch

    lp, g, tie, pick = (torch.stack([s[k] for s in steps]) for k in ("lp", "grad", "tie", "pick"))
    ties = tie <= LOGP_ATOL
    held = g[~ties]
    log(f"[{tag}] at {len(steps)} input(s) x {g.shape[1]} clouds, card vs CPU (the CPU taking the card's "
        f"choices, which lie at most {float(pick.max()):.3e} from its own): log-probs max|diff| "
        f"{float(lp.max()):.3e}; loss gradient relative L2 difference per step and cloud "
        f"{[[float(f'{v:.3g}') for v in row] for row in g]}; log-prob tie gaps "
        f"{[[round(float(v), 6) for v in row] for row in tie]}; left out as ties (step, cloud): "
        f"{[tuple(ix) for ix in ties.nonzero().tolist()]}; of the other {held.numel()}, max "
        f"{float(held.max()) if held.numel() else float('nan'):.3e} (bound {GRAD_CLEAN})")
    if float(pick.max()) > PICK_ATOL or float(lp.max()) > LOGP_ATOL:
        raise AssertionError(f"{tag}: card choices {float(pick.max()):.3e} from the CPU's own (> {PICK_ATOL}) "
                             f"or log-probs {float(lp.max()):.3e} apart (> {LOGP_ATOL})")
    if not held.numel() or not float(held.max()) <= GRAD_CLEAN:  # a NaN fails too
        raise AssertionError(f"{tag}: loss gradients differ by more than {GRAD_CLEAN} (or every step tied)")


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
    hold_grad_parity("parity-msg", [grad_parity(model_fn, cpu_fn, adv, ori, target[:b])])


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
    copies = sum(n for name, (_, n) in by_name.items() if "copy" in name.lower())
    log(f"[{tag}] {what} B={data.shape[0]} under the profiler: {copies} copy kernels; wall {wall * 1e3:.3f} ms; "
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
def knn_inputs(mod=None):
    """While open, records the input and k of every kNN that the victim
    module ``mod`` (DGCNN's by default) runs."""
    if mod is None:
        from pointcloudattack_tpu_torch.models import dgcnn as mod

    orig, seen = mod.knn, []

    def rec(x, k):
        seen.append((x.detach().clone(), k))
        return orig(x, k)

    mod.knn = rec
    try:
        yield seen
    finally:
        mod.knn = orig


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

    rec = new_record("knn", "gather_fwd", "gather_bwd", *HOIST_KEYS)
    with knn_inputs() as inputs, torch.no_grad():
        model_fn(data)
    if [tuple(x.shape[1:]) + (k,) for x, k in inputs] != [(N, c, DG_K) for c in (3, 64, 64, 128)]:
        raise AssertionError(f"DGCNN ran kNN on {[tuple(x.shape) for x, _ in inputs]}")
    with phase_clock("kernels-knn"):
        rec["knn"]["shapes"] = {}
        for i, (x, k) in enumerate(inputs):
            r = time_knn("kernels-knn", f"DGCNN conv{i + 1} input", x, k)
            rec["knn"]["err"] = max(rec["knn"]["err"], r["err"])
            accumulate(rec["knn"], r["ms"], r["plain_ms"], (r["bound_ms"], r["bound_by"]))
            rec["knn"]["shapes"][f"dgcnn conv{i + 1} {tuple(x.shape)} k={k}"] = r
        r = rec["knn"]
        log(f"[kernels-knn] per DGCNN forward (the four EdgeConv inputs): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms; device "
            f"{sum(sum(v['device_ms'].values()) for v in r['shapes'].values()):.4f} ms")
        errs = [check_knn("kernels-knn", "conv2 input, first 1000 points (ragged)",
                          inputs[1][0][:, :1000].contiguous(), DG_K)]
        for i in (0, 3):  # every point 4 times: each row's first 4 neighbours tie at distance 0
            x = inputs[i][0]
            errs.append(check_knn("kernels-knn", f"conv{i + 1} input, its first 256 points 4 times (ties)",
                                  torch.cat([x[:, :256]] * 4, dim=1).contiguous(), DG_K))
        for name, (b, n, c, k) in KNN_EDGE_CASES.items():
            errs.append(check_knn("kernels-knn", name, knn_case(b, n, c), k))
        rec["knn"]["err"] = max(rec["knn"]["err"], *errs)
    with phase_clock("kernels-gather-dgcnn"):
        for i, (name, shape) in enumerate(DGCNN_GATHER_SHAPES.items()):
            case = gather_case(40 + i, *shape)
            errs, am, g, win = check_gather(name, *case)
            herrs = check_hoist(name, *case)
            ms, b_fwd, b_bwd = time_gather(name, shape[6], *case[:5], am, g, win)
            hms = time_hoist("kernels-gather-dgcnn", name, *case[:5], am, g)
            b, ng, k = case[2].shape
            for key, e, m, p, bb, rows in (
                ("gather_fwd", errs["y"], ms["fwd"], ms["fwd_plain"], b_fwd, b * ng * k),
                ("gather_bwd", max(errs["dsrc"], errs["dctr"]), ms["bwd"], ms["bwd_plain"], b_bwd, win),
            ):
                rec[key]["err"] = max(rec[key]["err"], e)
                accumulate(rec[key], m, p, bb, rows)
                rec[key]["rows_ms"] = rec[key].get("rows_ms", 0.0) + ms[key[len("gather_"):] + "_rows"]
            for key, (m, p, lib, bb) in hms.items():
                rec[key]["err"] = max(rec[key]["err"], herrs[key])
                accumulate(rec[key], m, p, bb)
                if lib is not None:
                    rec[key]["library_ms"] = rec[key].get("library_ms", 0.0) + lib
            del case, am, g
            torch.cuda.empty_cache()
        for i, (name, args) in enumerate(HOIST_EDGE_CASES.items()):
            case = hoist_case(*args)
            check_gather(name, *case)
            for key, e in check_hoist(name, *case).items():
                rec[key]["err"] = max(rec[key]["err"], e)
        for key, what in (("gather_fwd", "forward"), ("gather_bwd", "backward")):
            r = rec[key]
            log(f"[kernels-gather-dgcnn] the one-layer route per DGCNN {what} (the four EdgeConvs): "
                f"{r['ms']:.4f} ms, the row kernel it replaces {r['rows_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms; its kernels "
                + ", ".join(f"{h} {rec[h]['ms']:.4f}" for h in HOIST_KEYS if h.endswith(key[-3:])))
        rec["edgeconv"] = edgeconv_fused_vs_unfused(model, inputs)
    return rec


def phase_kernels_chamfer(data):
    """The row-min kernel at the KNN attack's shape, against an iterate a
    few steps in (clean clouds plus noise of 0.01), at B = 16 and 8 (its
    first clouds), on GeoA3's clouds, at a ragged N = M = 1000 against a
    cloud whose points each appear 4 times, and at ROWMIN_EDGE_CASES; at each of
    ROWMIN_BATCHES its device time beside its bound and its floor at one
    operation an issued instruction."""
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
    for bb in ROWMIN_BATCHES[1:]:
        err = max(err, check_chamfer("kernels-chamfer", f"B={bb} N=M={data.shape[1]}", adv[:bb].contiguous(),
                                     data[:bb].contiguous(), w[:bb].contiguous()))
    geo = synthetic_data(8, 1, GEO_DATA, "cuda")[0]
    geo_adv = (geo + torch.from_numpy(rng.randn(*geo.shape).astype(np.float32) * 0.01).cuda()).contiguous()
    err = max(err, check_chamfer("kernels-chamfer", "GeoA3's clouds", geo_adv, geo, w[:8].contiguous()))
    for j, (name, (bb, nn, mm, kind)) in enumerate(ROWMIN_EDGE_CASES.items()):
        xe, ye = rowmin_case(30 + j, bb, nn, mm, kind)
        we = torch.from_numpy(rng.rand(bb, nn).astype(np.float32)).cuda()
        err = max(err, check_chamfer("kernels-chamfer", name, xe, ye, we, grad=kind != "overflow"))
    ms = time_pairs({"plain": lambda: chamfer.min_rows_plain(adv, data), "kernel": lambda: chamfer.min_rows_fwd(adv, data)})
    b, n, _ = data.shape
    bnd, floor = chamfer_bound(b, n, n), chamfer_bound(b, n, n, issued=True)
    shapes = {}
    for bb in ROWMIN_BATCHES:
        x, y = adv[:bb].contiguous(), data[:bb].contiguous()
        dev = device_ms(lambda: chamfer.min_rows_fwd(x, y), reps=20)
        sb, sf = chamfer_bound(bb, n, n), chamfer_bound(bb, n, n, issued=True)
        shapes[f"[{bb},{n},3]^2"] = {"device_ms": sum(dev.values()), "bound_ms": sb[0], "bound_issued_ms": sf[0]}
        log(f"[kernels-chamfer] [{bb},{n},3] x [{bb},{n},3]: device " + ", ".join(f"{k} {v:.4f}" for k, v in dev.items())
            + f" ms, bound {sb[0]:.5f} ms by {sb[1]}, at one operation an issued FP32 instruction {sf[0]:.5f} ms")
    dev = shapes[f"[{b},{n},3]^2"]["device_ms"]
    log(f"[kernels-chamfer] [{b},{n},3] x [{b},{n},3]: kernel {ms['kernel']:.4f} ms (device {dev:.4f} ms), plain "
        f"{ms['plain']:.4f} ms, bound {bnd[0]:.5f} ms by {bnd[1]} ({8.0 * b * n * n / 1e9:.3f} G operations); at one "
        f"operation an issued FP32 instruction {floor[0]:.5f} ms")
    return {"ms": ms["kernel"], "plain_ms": ms["plain"], "bound": bnd, "bound_issued": floor, "err": err,
            "device_ms": dev, "shapes": shapes}


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
    hold_grad_parity("parity-dgcnn", [res])


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


def kappa_idx_bound(b, n, k):
    """(bound_ms, bound_by) of one curvature forward on a given neighbour
    set: per edge 8 operations for the distance and 11 for its contribution,
    5 a row for n_i . a_i; the indices, adv and the normals read once, kappa
    written once.  (The backward is ``kappa_bwd_bound``'s work on the given
    set.)"""
    return bound(19.0 * b * n * k + 5.0 * b * n, 4.0 * (b * n * k + 2 * 3 * b * n + b * n))


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


def check_kappa(tag, name, a, nrm, dk, k=None):
    """The curvature kernels against the plain versions on the CPU (whose
    sums run in a fixed order) on one input, at ``k`` neighbours (GEO_K when
    absent): the forward's picks and kappa bit-equal, dadv and dnormal
    within KAPPA_GRAD_ATOL.  Returns the max |diff| over all of them."""
    from pointcloudattack_tpu_torch.ops import chamfer, kappa

    k = GEO_K if k is None else k
    kap, picks = kappa.kappa_fwd(a, nrm, k)
    dadv, dnrm = kappa.kappa_bwd(a, nrm, picks, dk, k)
    twice(tag, f"kappa {name}", (dadv, dnrm), kappa.kappa_bwd(a, nrm, picks, dk, k))
    kap_p, picks_p = kappa.kappa_plain(a.cpu(), nrm.cpu(), k)
    dadv_p, dnrm_p = kappa.kappa_bwd_plain(a.cpu(), nrm.cpu(), picks_p, dk.cpu(), k)
    res = {"picks": _same(tag, "picks", picks, picks_p),
           "kappa": _same(tag, "kappa", kap, kap_p),
           "dadv": _same(tag, "dadv", dadv, dadv_p, rtol=0.0, atol=KAPPA_GRAD_ATOL),
           "dnormal": _same(tag, "dnormal", dnrm, dnrm_p, rtol=0.0, atol=KAPPA_GRAD_ATOL)}
    zero = int((chamfer.exact_sqdist(a, a).gather(-1, picks.long()) == 0).sum())
    log(f"[{tag}] kappa {name} {tuple(a.shape)} k={k}: picks and kappa bit-equal to the plain version's; max |diff| "
        + ", ".join(f"{k} {e:.3e} ({'bit-equal' if eq else 'not bit-equal'})" for k, (e, eq) in res.items())
        + f"; {zero} picks at distance 0, all finite")
    return max(e for e, _ in res.values())


def check_kappa_idx(tag, name, a, nrm, idx, dk):
    """The curvature kernels on a given neighbour set ``idx`` against the
    plain versions on the CPU on one input: kappa bit-equal, dadv and
    dnormal within KAPPA_GRAD_ATOL.  Returns the max |diff| over them."""
    from pointcloudattack_tpu_torch.ops import chamfer, kappa

    kap = kappa.kappa_idx_fwd(a, nrm, idx, GEO_K)
    dadv, dnrm = kappa.kappa_bwd(a, nrm, idx, dk, GEO_K, counter="kappa_idx_bwd")
    twice(tag, f"kappa_knn_mean_from_idx {name}", (dadv, dnrm),
          kappa.kappa_bwd(a, nrm, idx, dk, GEO_K, counter="kappa_idx_bwd"))
    kap_p = kappa.kappa_idx_plain(a.cpu(), nrm.cpu(), idx.cpu(), GEO_K)
    dadv_p, dnrm_p = kappa.kappa_bwd_plain(a.cpu(), nrm.cpu(), idx.cpu(), dk.cpu(), GEO_K)
    res = {"kappa": _same(tag, "kappa (given set)", kap, kap_p),
           "dadv": _same(tag, "dadv (given set)", dadv, dadv_p, rtol=0.0, atol=KAPPA_GRAD_ATOL),
           "dnormal": _same(tag, "dnormal (given set)", dnrm, dnrm_p, rtol=0.0, atol=KAPPA_GRAD_ATOL)}
    zero = int((chamfer.exact_sqdist(a, a).gather(-1, idx.long()) == 0).sum())
    log(f"[{tag}] kappa_knn_mean_from_idx {name} {tuple(a.shape)} k={GEO_K}: max |diff| "
        + ", ".join(f"{k} {e:.3e} ({'bit-equal' if eq else 'not bit-equal'})" for k, (e, eq) in res.items())
        + f"; {zero} given neighbours at distance 0, all finite")
    return max(e for e, _ in res.values())


def twice(tag, what, first, second):
    """Two backwards on the same inputs must give the same bits."""
    import torch

    if not all(torch.equal(u, v) for u, v in zip(first, second)):
        raise AssertionError(f"{tag} {what}: two backwards differ")


def check_kappa_bwd(tag, name, a, nrm, idx, dk):
    """The curvature backward alone on a given set ``idx [B, N, k]``, whose
    indices may lie outside [0, N) (they add nothing), against the plain
    version that orders it as the kernel does (``kappa_bwd_lists_plain`` on
    the CPU, the bits of ``kappa_bwd_plain`` wherever every index is in
    range): dadv and dnormal within KAPPA_GRAD_ATOL, two backwards
    bit-equal.  Returns the max |diff|."""
    from pointcloudattack_tpu_torch.ops import kappa

    k = idx.shape[-1]
    got = kappa.kappa_bwd(a, nrm, idx, dk, k, counter="kappa_idx_bwd")
    twice(tag, f"kappa backward {name}", got, kappa.kappa_bwd(a, nrm, idx, dk, k, counter="kappa_idx_bwd"))
    start, lst = kappa.kappa_lists_plain(idx.cpu(), a.shape[1])
    want = kappa.kappa_bwd_lists_plain(a.cpu(), nrm.cpu(), idx.cpu(), dk.cpu(), k, start, lst)
    res = {w: _same(tag, f"kappa backward {w} ({name})", g, p, rtol=0.0, atol=KAPPA_GRAD_ATOL)
           for w, g, p in zip(("dadv", "dnormal"), got, want)}
    outside = int(((idx < 0) | (idx >= a.shape[1])).sum())
    log(f"[{tag}] kappa backward {name} {tuple(a.shape)} k={k}: against the list-ordered plain version, max |diff| "
        + ", ".join(f"{w} {e:.3e} ({'bit-equal' if eq else 'not bit-equal'})" for w, (e, eq) in res.items())
        + f"; two backwards bit-equal; {outside} indices outside the cloud, the longest list "
        f"{int((start[:, 1:] - start[:, :-1]).max())} edges")
    return max(e for e, _ in res.values())


def stale_idx(adv, data, moved=8):
    """``data``'s own neighbour sets (the kNN kernel on the card, k =
    GEO_K), stale on the iterate ``adv``; the same iterate with the fifth
    neighbour of ``moved`` rows of cloud 0 (every 7th, no centre itself
    moved) moved exactly onto its centre; and those rows."""
    from pointcloudattack_tpu_torch.losses.geometry import self_knn_idx

    idx = self_knn_idx(data, GEO_K).contiguous()
    hit = adv.clone()
    rows, taken = [], set()
    for i in range(0, adv.shape[1], 7):
        j = int(idx[0, i, 4])
        if j in taken or j in rows or i in taken:
            continue
        hit[0, j] = hit[0, i]
        rows.append(i)
        taken.add(j)
        if len(rows) == moved:
            break
    return idx, hit.contiguous(), rows


def check_both(tag, name, x, y, gr, gc):
    """The two-direction kernels against the plain versions on the CPU on
    one input: both mins and argmins, dx and dy bit for bit, and two
    backwards bit-equal.  Returns the max |diff| over all of them."""
    from pointcloudattack_tpu_torch.ops import chamfer

    fwd = chamfer.both_fwd(x, y)
    dx, dy = chamfer.both_bwd(x, y, fwd[1], fwd[3], gr, gc)
    twice(tag, f"min_sqdist_both {name}", (dx, dy), chamfer.both_bwd(x, y, fwd[1], fwd[3], gr, gc))
    fwd_p = chamfer.both_plain(x.cpu(), y.cpu())
    dx_p, dy_p = chamfer.both_bwd_plain(x.cpu(), y.cpu(), fwd_p[1], fwd_p[3], gr.cpu(), gc.cpu())
    res = {k: _same(tag, k, g, w) for k, g, w in zip(("row_min", "row_arg", "col_min", "col_arg", "dx", "dy"),
                                                      (*fwd, dx, dy), (*fwd_p, dx_p, dy_p))}
    log(f"[{tag}] min_sqdist_both {name} x {tuple(x.shape)} y {tuple(y.shape)}: mins, argmins, dx and dy bit-equal "
        "to the plain version, two backwards bit-equal")
    return max(e for e, _ in res.values())


def both_case(seed, b, n, m, kind, device="cuda"):
    """(x [B, N, 3], y [B, M, 3]) of a BOTH_EDGE_CASES kind: random clouds,
    or a hub, x's point 0 at (5, 0, 0) and y within 0.03 of (10, 0, 0)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x, y = rng.randn(b, n, 3) * 0.5, rng.randn(b, m, 3) * 0.5
    if kind == "hub":
        x[:, 0] = (5.0, 0.0, 0.0)
        y = y * 0.02 + np.array([10.0, 0.0, 0.0])
    return (torch.from_numpy(x.astype(np.float32)).to(device), torch.from_numpy(y.astype(np.float32)).to(device))


def rowmin_case(seed, b, n, m, kind, device="cuda"):
    """(x [B, N, 3], y [B, M, 3]) of a ROWMIN_EDGE_CASES kind: random
    clouds; every point the same one; or random clouds with x's odd rows at
    1e20 and y's first quarter at -1e20, whose squared distances overflow to
    +inf."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x, y = rng.randn(b, n, 3) * 0.5, rng.randn(b, m, 3) * 0.5
    if kind == "equal":
        x[:], y[:] = (0.3, -0.2, 0.1), (0.3, -0.2, 0.1)
    if kind == "overflow":
        x[:, 1::2] = 1e20
        y[:, : m // 4] = -1e20
    return (torch.from_numpy(x.astype(np.float32)).to(device), torch.from_numpy(y.astype(np.float32)).to(device))


def given_idx(seed, b, n, k, device="cuda"):
    """A given neighbour set [B, N, k] int32 for row 8b: random indices in
    the cloud, slot 1 repeating slot 0, every 11th row's slot 0 the row
    itself (distance 0), every 5th row's last slot -1 and every 7th row's
    middle slot N + 3 (outside the cloud)."""
    import numpy as np
    import torch

    idx = np.random.RandomState(seed).randint(0, n, size=(b, n, k))
    if k > 1:
        idx[:, :, 1] = idx[:, :, 0]
    idx[:, ::11, 0] = np.arange(0, n, 11)
    idx[:, ::5, k - 1] = -1
    idx[:, ::7, k // 2] = n + 3
    return torch.from_numpy(idx.astype(np.int32)).to(device).contiguous()


def check_kappa_idx_fwd(tag, name, a, nrm, idx, k):
    """Row 8b's forward on a given set ``idx`` against the plain version on
    the CPU, kappa bit for bit; an index outside the cloud adds 0 in the
    kernel, as the row's own index (distance 0) does in the plain version,
    which takes it in its place.  Returns the max |diff|."""
    import torch

    from pointcloudattack_tpu_torch.ops import kappa

    kap = kappa.kappa_idx_fwd(a, nrm, idx, k)
    n = a.shape[1]
    own = torch.arange(n, dtype=idx.dtype, device=idx.device)[None, :, None].expand_as(idx)
    inside = (idx >= 0) & (idx < n)
    kap_p = kappa.kappa_idx_plain(a.cpu(), nrm.cpu(), torch.where(inside, idx, own).cpu(), k)
    err, _ = _same(tag, f"kappa_knn_mean_from_idx {name}", kap, kap_p)
    log(f"[{tag}] kappa_knn_mean_from_idx {name} {tuple(a.shape)} k={k}: kappa bit-equal to the plain version; "
        f"{int((~inside).sum())} indices outside the cloud, all finite")
    return err


def phase_kernels_geoa3(data):
    """The curvature and the two-direction kernels at GeoA3's shapes, on an
    iterate a few steps in (clean clouds plus 1e-3 noise) with the normals
    of each point's nearest clean point, at a ragged N=1000, and with every
    point twice (kappa) or 4 times (the bundle's y), and the bundle at
    BOTH_EDGE_CASES; the curvature on a
    given neighbour set (the clean clouds' own, from the kNN kernel) on an
    iterate 1e-2 away, with 8 exact collisions and at a ragged N=1000; times
    beside the plain versions' (on the card) and the bounds."""
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
    rec = new_record("kappa_fwd", "kappa_bwd", "kappa_idx_fwd", "kappa_idx_bwd", "both_fwd", "both_bwd")
    err_k = max(check_kappa("kernels-geoa3", f"B={b} N={n}", adv, nrm, dk),
                check_kappa("kernels-geoa3", "ragged N=1000", adv[:, :1000].contiguous(), nrm[:, :1000].contiguous(),
                            dk[:, :1000].contiguous()),
                check_kappa("kernels-geoa3", "every point twice", half(adv), half(nrm), dk))
    # the forward's selection at its edges: k = 1, the last k the bound serves (63: k + 1 = 64 share
    # minima), the k-pass fallback (64), the largest N with every point 4 times, and a hub (300 copies
    # of one point: more than the gather's 128 pairs under the bound)
    erng = np.random.RandomState(12)
    for name, (bb, nn, kk, copies, hub) in KAPPA_EDGE_CASES.items():
        pts = np.concatenate([erng.randn(bb, nn // copies, 3) * 0.5] * copies, axis=1)
        pts[:, :hub] = pts[:, :1]
        nv = erng.randn(bb, nn, 3)
        err_k = max(err_k, check_kappa("kernels-geoa3", name, dev(pts), dev(nv / np.linalg.norm(nv, axis=-1, keepdims=True)),
                                       dev(erng.randn(bb, nn) * 1e-3), kk))
    dup = torch.cat([data[:, :250]] * 4, dim=1).contiguous()
    err_b = max(check_both("kernels-geoa3", f"B={b} N=M={n}", adv, data, gr, gc),
                check_both("kernels-geoa3", "ragged N=M=1000, every y point 4 times", adv[:, :1000].contiguous(), dup,
                           gr[:, :1000].contiguous(), gc[:, :1000].contiguous()))
    for j, (name, (bb, nn, mm, kind)) in enumerate(BOTH_EDGE_CASES.items()):
        xe, ye = both_case(20 + j, bb, nn, mm, kind)
        err_b = max(err_b, check_both("kernels-geoa3", name, xe, ye, dev(erng.rand(bb, nn)), dev(erng.rand(bb, mm))))
    # the curvature on a given set: the clean clouds' sets on the iterate 1e-2 from them (stale), with
    # exact collisions, and at a ragged N=1000
    moved = (data + dev(rng.randn(b, n, 3) * 1e-2)).contiguous()
    idx, hit, _ = stale_idx(moved, data)
    idx_r = stale_idx(moved[:, :1000].contiguous(), data[:, :1000].contiguous())[0]
    err_i = max(check_kappa_idx("kernels-geoa3", f"B={b} N={n} stale set", moved, nrm, idx, dk),
                check_kappa_idx("kernels-geoa3", "8 exact collisions", hit, nrm, idx, dk),
                check_kappa_idx("kernels-geoa3", "ragged N=1000", moved[:, :1000].contiguous(),
                                nrm[:, :1000].contiguous(), idx_r, dk[:, :1000].contiguous()))
    # the backward alone: a hub point (every row's fifth neighbour), indices outside the cloud beside exact
    # collisions
    hub, outside = idx.clone(), idx.clone()
    hub[:, :, 4] = 7
    outside[0, ::5, 2], outside[1, ::7, 9] = -1, n + 5
    err_i = max(err_i, check_kappa_bwd("kernels-geoa3", "a hub point picked by every row", moved, nrm,
                                       hub.contiguous(), dk),
                check_kappa_bwd("kernels-geoa3", "indices outside the cloud, 8 exact collisions", hit, nrm,
                                outside.contiguous(), dk))
    # the given-set forward at the widths it takes: repeated slots, a row's own index, indices outside the cloud
    for j, (name, (bb, nn, kk)) in enumerate(KAPPA_IDX_CASES.items()):
        pts = erng.randn(bb, nn, 3) * 0.5
        nv = erng.randn(bb, nn, 3)
        err_i = max(err_i, check_kappa_idx_fwd("kernels-geoa3", name, dev(pts),
                                               dev(nv / np.linalg.norm(nv, axis=-1, keepdims=True)),
                                               given_idx(40 + j, bb, nn, kk), kk))
    for key in ("kappa_fwd", "kappa_bwd"):
        rec[key]["err"] = err_k
    for key in ("kappa_idx_fwd", "kappa_idx_bwd"):
        rec[key]["err"] = err_i
    for key in ("both_fwd", "both_bwd"):
        rec[key]["err"] = err_b
    _, picks = kappa.kappa_fwd(adv, nrm, GEO_K)
    fwd = chamfer.both_fwd(adv, data)
    ms = time_pairs({
        "kappa_idx_fwd_plain": lambda: kappa.kappa_idx_plain(moved, nrm, idx, GEO_K),
        "kappa_idx_fwd": lambda: kappa.kappa_idx_fwd(moved, nrm, idx, GEO_K),
        "kappa_idx_bwd_plain": lambda: kappa.kappa_bwd_plain(moved, nrm, idx, dk, GEO_K),
        "kappa_idx_bwd": lambda: kappa.kappa_bwd(moved, nrm, idx, dk, GEO_K, counter="kappa_idx_bwd"),
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
                     ("kappa_idx_fwd", kappa_idx_bound(b, n, GEO_K)), ("kappa_idx_bwd", kappa_bwd_bound(b, n, GEO_K)),
                     ("both_fwd", both_bound(b, n, n)), ("both_bwd", both_bwd_bound(b, n, n))):
        accumulate(rec[key], ms[key], ms[f"{key}_plain"], bnd)
        log(f"[kernels-geoa3] {key} [{b},{n},3] k={GEO_K}: kernel {ms[key]:.4f} ms, plain {ms[f'{key}_plain']:.4f} ms, "
            f"bound {bnd[0]:.5f} ms by {bnd[1]}")
    # row 8b's forward beside a one-element zero_() in the same profiler window: the launch floor
    one = torch.zeros(1, device="cuda")
    both = device_ms(lambda: (kappa.kappa_idx_fwd(moved, nrm, idx, GEO_K), one.zero_()), reps=20)
    rec["kappa_idx_fwd"]["device_ms"] = {k: v for k, v in both.items() if "kappa" in k}
    floor = [v for k, v in both.items() if "kappa" not in k]
    rec["kappa_idx_fwd"]["launch_floor_ms"] = floor[0] if floor else None
    log(f"[kernels-geoa3] kappa_idx_fwd [{b},{n},3] k={GEO_K}: device "
        + ", ".join(f"{name} {v:.4f} ms" for name, v in both.items())
        + f" (the one-element zero_() is the launch floor), bound {rec['kappa_idx_fwd']['bound_ms']:.5f} ms")
    for key, fn in (("kappa_fwd", lambda: kappa.kappa_fwd(adv, nrm, GEO_K)),
                    ("kappa_bwd", lambda: kappa.kappa_bwd(adv, nrm, picks, dk, GEO_K)),
                    ("kappa_idx_bwd", lambda: kappa.kappa_bwd(moved, nrm, idx, dk, GEO_K, counter="kappa_idx_bwd")),
                    ("both_fwd", lambda: chamfer.both_fwd(adv, data)),
                    ("both_bwd", lambda: chamfer.both_bwd(adv, data, fwd[1], fwd[3], gr, gc))):
        rec[key]["device_ms"] = dev = device_ms(fn, reps=20)
        log(f"[kernels-geoa3] {key} [{b},{n},3] k={GEO_K}, its kernels' device time a launch: "
            + ", ".join(f"{name} {v:.4f} ms" for name, v in dev.items())
            + f"; {sum(dev.values()):.4f} ms in all, bound {rec[key]['bound_ms']:.5f} ms")
    rec["knn_geoa3"] = time_knn("kernels-knn", "GeoA3's cached curvature set (the clean clouds)", data, GEO_K + 1)
    return rec


def run_geoa3(tag, model_fn, data, target, per_fwd, per_bwd, rounds=GEO_ROUNDS, iters=GEO_ITER, refresh=1):
    """GeoA3 (bench.py's geoa3 settings, ``rounds`` x ``iters``, the
    curvature's neighbour set cached for ``refresh`` iterations), counted
    and timed: per iteration one model forward and backward (launching
    ``per_fwd`` and ``per_bwd``), the curvature forward and backward (on the
    cached set when ``refresh`` > 1: the given-set kernels, and a kNN at
    each refresh) and the bundle's forward and backward; per round one more
    forward; once the normals' kNN, the clean cloud's curvature and the
    final forward."""
    from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack

    steps = rounds * iters
    expect = {k: per_fwd.get(k, 0) * (steps + rounds + 1) + per_bwd.get(k, 0) * steps for k in {*per_fwd, *per_bwd}}
    expect.update(knn=expect.get("knn", 0) + 1, kappa_fwd=1 + steps, kappa_bwd=steps, both_fwd=steps,
                  both_bwd=steps)
    if refresh > 1:
        expect.update(knn=expect["knn"] + rounds * -(-iters // refresh), kappa_fwd=1, kappa_bwd=0,
                      kappa_idx_fwd=steps, kappa_idx_bwd=steps)
    attack = build_geoa3_attack(model_fn, GeoA3Config(binary_max_steps=rounds, iter_max_steps=iters,
                                                      curv_knn_refresh=refresh))
    what = f"GeoA3 {rounds}x{iters}" + (f" curv_knn_refresh {refresh}" if refresh > 1 else "")
    return counted_and_timed(tag, what, attack, data, target, expect, geoa3_check(tag, data))


def geoa3_check(tag, data):
    """``check`` of a GeoA3 result: finite clouds of the input's shape, ASR
    > 0 and finite best constraints where a cloud flipped."""
    import torch

    def check(res):
        adv, best_loss, succ = res
        asr, moved = check_adv(tag, adv, data, succ, budget=None)
        if not bool(torch.isfinite(best_loss[succ]).all()):
            raise AssertionError(f"{tag}: non-finite best_loss on a successful example")
        log(f"[{tag}] ASR {asr:.3f} ({int(succ.sum())}/{len(succ)}); max per-point move {moved:.4f}; "
            f"best constraint of the successes {[round(float(v), 8) for v in best_loss[succ]]}")

    return check


def run_geoa3_partial(tag, model_fn, data, target, per_fwd, per_bwd):
    """GeoA3's partial mode (PARTIAL_ROUNDS x PARTIAL_ITER, a patch of
    PARTIAL_RANGE points every PARTIAL_REFRESH iterations, the curvature's
    set cached for GEO_REFRESH, evaluated on a PARTIAL_NPOINT farthest-point
    subsample), counted and timed: per iteration the loss forward and
    backward, the subsample's FPS and forward, the given-set curvature and
    the bundle; a kNN at each refresh of the set; per round one more
    forward; once the normals' kNN, the clean cloud's curvature and the
    final forward."""
    from pointcloudattack_tpu_torch.attacks.geoa3_partial import GeoA3PartialConfig, build_geoa3_partial_attack

    rounds, iters = PARTIAL_ROUNDS, PARTIAL_ITER
    steps = rounds * iters
    expect = {k: per_fwd.get(k, 0) * (2 * steps + rounds + 1) + per_bwd.get(k, 0) * steps
              for k in {*per_fwd, *per_bwd}}
    expect.update(knn=expect.get("knn", 0) + 1 + rounds * -(-iters // GEO_REFRESH), kappa_fwd=1,
                  kappa_idx_fwd=steps, kappa_idx_bwd=steps, both_fwd=steps, both_bwd=steps,
                  fps=expect.get("fps", 0) + steps)
    cfg = GeoA3PartialConfig(binary_max_steps=rounds, iter_max_steps=iters, curv_knn_refresh=GEO_REFRESH,
                             knn_range=PARTIAL_RANGE, refresh_iters=PARTIAL_REFRESH, subsample_npoint=PARTIAL_NPOINT)
    what = (f"GeoA3 partial {rounds}x{iters} (patches of {PARTIAL_RANGE} every {PARTIAL_REFRESH}, curv_knn_refresh "
            f"{GEO_REFRESH}, subsample {PARTIAL_NPOINT})")
    return counted_and_timed(tag, what, build_geoa3_partial_attack(model_fn, cfg), data, target, expect,
                             geoa3_check(tag, data))


def geoa3_loss(normals, k_oris, cached=False):
    """GeoA3's first-round loss (CE plus 10 x the constraint) as a
    ``grad_parity`` loss, each side on its own normals and clean curvature
    (``normals`` / ``k_oris``: device type -> tensor); with ``cached``, the
    curvature on the card's neighbour set of the input (the given-set
    kernels), which the CPU then takes."""
    from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, _constraint_loss, _make_cls_fn
    from pointcloudattack_tpu_torch.losses.geometry import self_knn_idx

    cfg = GeoA3Config()
    cls = _make_cls_fn(cfg)
    shared = {}

    def loss(logp, a, o, t):
        dev = a.device.type
        idx = None
        if cached:
            if a.is_cuda:
                shared["idx"] = self_knn_idx(a, cfg.curv_loss_knn).contiguous()
            idx = shared["idx"].to(a.device)
        return cls(logp, t) + cfg.initial_const * _constraint_loss(a, o, normals[dev], k_oris[dev], cfg, self_idx=idx)

    return loss


def phase_parity_geoa3(model_fn, state, data, target, tag="parity-geoa3", **kw):
    """GeoA3 (B=4, 2 rounds x 10 iterations, with the GeoA3Config settings
    ``kw``) on the card and on the CPU from the same weights and start
    offsets, the CPU taking the card's normals (``normal_hooks``) and, where
    the settings make them, its cached curvature sets (``knn_hooks`` on
    ``losses.geometry``) and its jitter (``jitter_hooks``).  Held:
    ``success`` identical; the step whose iterate each side keeps (under
    jitter the bare iterate, which the second forward evaluates), and where
    it is the same, ``best_loss`` within rtol 1e-4 and ``best_attack``
    within 1e-5 at every point whose iterates never parted (by more than
    PART_ATOL); the run's first parting explained (``round_partings``: after
    a gradient within TINY_GRAD of 0, or GRAD_APART apart between the sides,
    or after the two sides' iterates chose other neighbours, nearest points
    or max-pool picks, ``geoa3_choices``), and at least GEO_HELD_SHARE of
    the points never parted; and at each of the card's iterates the loss
    gradient, the CPU taking the card's picks (``hold_grad_parity``; with a
    cached set, the curvature on the card's set of that input)."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack
    from pointcloudattack_tpu_torch.geometry.normals import estimate_normal
    from pointcloudattack_tpu_torch.losses import geometry as geo_losses
    from pointcloudattack_tpu_torch.losses.geometry import kappa_ori
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b, rounds, iters = 4, 2, 10
    cfg = GeoA3Config(binary_max_steps=rounds, iter_max_steps=iters, **kw)
    cached, jitter = cfg.curv_knn_refresh > 1, cfg.use_jitter
    offsets = torch.from_numpy((np.random.RandomState(6).randn(rounds, b, N, 3) * 1e-3).astype(np.float32))
    cpu_fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state, "cpu")
    calls, grads = {"card": [], "cpu": []}, {"card": [], "cpu": []}

    def recording(fn, side):  # every victim call's input, and the gradient at each loss forward's
        def run(a):
            calls[side].append(a.detach().cpu())
            if a.requires_grad:
                a.register_hook(lambda g: grads[side].append(g.detach().cpu()))
            return fn(a)
        return run

    hooks = {**normal_hooks(), **(knn_hooks(geo_losses) if cached else {}), **(jitter_hooks() if jitter else {})}
    with replay(hooks) as taken:
        adv_g, loss_g, succ_g = build_geoa3_attack(recording(model_fn, "card"), cfg)(
            data[:b], target[:b], init_offsets=offsets.cuda())
        adv_c, loss_c, succ_c = build_geoa3_attack(recording(cpu_fn, "cpu"), cfg)(
            data[:b].cpu(), target[:b].cpu(), init_offsets=offsets)
    steps, per = rounds * iters, 2 if jitter else 1  # under jitter each iteration evaluates the bare cloud too
    its = {}
    for side, rec in calls.items():
        if len(rec) != rounds * (per * iters + 1) + 1 or len(grads[side]) != steps:
            raise AssertionError(f"{tag}: recorded {len(rec)} victim calls and {len(grads[side])} gradients on the "
                                 f"{side}, expected {rounds * (per * iters + 1) + 1} and {steps}")
        its[side] = torch.stack([rec[r * (per * iters + 1) + per * i + per - 1] for r in range(rounds)
                                 for i in range(iters)])
    card_it, cpu_it = its["card"], its["cpu"]
    kept = []
    for it_, adv in ((card_it, adv_g.cpu()), (cpu_it, adv_c)):
        eq = (it_ == adv[None]).flatten(2).all(-1)
        kept.append(torch.where(eq.any(0), eq.int().argmax(0), -1))
    same = kept[0] == kept[1]
    parted, lines, first_ok = round_partings(card_it, cpu_it, grads["card"], iters,
                                             geoa3_choices(cpu_fn, data[:b].cpu()), grads["cpu"])
    held_share = 1.0 - float(parted.float().mean())
    diff = (adv_g.cpu() - adv_c).abs()
    log(f"[{tag}] card vs CPU, PointNet B={b}, {rounds}x{iters} {kw}: the CPU took the card's {choice_line(taken)}; "
        f"success card {succ_g.tolist()} cpu {succ_c.tolist()}; best_loss card "
        f"{loss_g.cpu().tolist()} cpu {loss_c.tolist()}; kept step card {kept[0].tolist()} cpu {kept[1].tolist()} "
        f"({int((~same).sum())} clouds differ); {int(parted.sum())} of {parted.numel()} points parted (> {PART_ATOL}), "
        f"{held_share:.3f} never did (at least {GEO_HELD_SHARE}); the others max |diff| "
        f"{float(diff[~parted].max()):.3e}" + "".join(f"; {w}" for w in lines))
    if not torch.equal(succ_g.cpu(), succ_c):
        raise AssertionError(f"{tag}: success differs between the card and the CPU")
    if not bool(succ_c.any()):
        raise AssertionError(f"{tag}: the short attack flipped no cloud: it tests no best tracking")
    if not first_ok or held_share < GEO_HELD_SHARE:
        raise AssertionError(f"{tag}: nothing explains the first parting, or only {held_share:.3f} of "
                             "the points never parted")
    torch.testing.assert_close(loss_g.cpu()[same], loss_c[same], rtol=1e-4, atol=0.0)
    held = same[:, None] & ~parted
    torch.testing.assert_close(adv_g.cpu()[held], adv_c[held], rtol=0.0, atol=1e-5)
    card_nrm = estimate_normal(data[:b])
    nrm = {"cuda": card_nrm, "cpu": card_nrm.cpu()}  # the CPU on the card's normals, as in the attack
    k_oris = {dev: kappa_ori(x, nrm[dev], GEO_K) for dev, x in (("cuda", data[:b]), ("cpu", data[:b].cpu()))}
    loss = geoa3_loss(nrm, k_oris, cached)
    hold_grad_parity(tag, [grad_parity(model_fn, cpu_fn, a.cuda(), data[:b], target[:b], loss)
                           for a in card_it])


def group_case(seed, b, g, k, dims, device="cuda"):
    """Seeded grouped rows ``x [b, g, k, dims[0]]``, layers and cotangent."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, g, k, dims[0]).astype(np.float32)).to(device)
    layers = seeded_layers(rng, dims, device)
    dy = torch.from_numpy(rng.randn(b, g, dims[-1]).astype(np.float32)).to(device)
    return x, layers, dy


def max_bwd_case(seed, b, g, k, dims, kind, device="cuda"):
    """``group_case``'s rows, layers and cotangent ``g = dy * mul`` with an
    argmax ``am [b, g, C]`` made to order for the max backward: "hub"
    (every column's winner is row k // 2 of its group) or "distinct" (column
    c's is row (2 c) % k, so no row wins twice where k >= 2 C)."""
    import torch

    x, layers, dy = group_case(seed, b, g, k, dims, device)
    c = torch.arange(dims[-1], device=device, dtype=torch.int32)
    row = torch.full_like(c, k // 2) if kind == "hub" else (2 * c) % k
    am = row.expand(b, g, dims[-1]).contiguous()
    return x, layers, am, (dy * layers[-1][3]).contiguous()


def check_max_bwd(name, x, layers, am, g, slope=CN_SLOPE):
    """The max backward on a given argmax against its plain version, both
    on the card: dx within DX_TOL on every row (a row that wins no column
    gets 0) and two backwards bit-equal.  Returns dx's max |err|."""
    import torch

    from pointcloudattack_tpu_torch.ops import group_chain as gch

    dx = gch.chain_groupmax_bwd(x, layers, am, g, slope)
    twice(name, "group max backward", (dx,), (gch.chain_groupmax_bwd(x, layers, am, g, slope),))
    dx_ref = gch.chain_groupmax_bwd_plain(x, layers, am, g, slope)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx, dx_ref, **DX_TOL)
    won = winners(am, x.shape[2])
    err = float((dx - dx_ref).abs().max())
    log(f"[kernels-curvenet] max backward {name} x {tuple(x.shape)} chain {[x.shape[-1]] + [l[0].shape[1] for l in layers]}: "
        f"{int(won.sum())} of {won.numel()} rows win a column (at most {int(won.sum(-1).max())} a group, the busiest "
        f"row {int(torch.nn.functional.one_hot(am.long(), x.shape[2]).sum(-2).max())} columns); dx max|err| "
        f"{err:.3e}, {int((dx[~won] != 0).sum())} nonzero entries on rows that win nothing; two backwards bit-equal")
    return err


def mask_flips(x, layers, slope=CN_SLOPE):
    """The (row, unit) pairs of a one-layer mean whose backward mask
    differs from the sign the forward gave the unit.  The forward's
    pre-activations are the group kernels' own (the max kernel over groups
    of one row, ``kernel_rows``' pass); the backward's mask of unit u is
    read from a backward whose cotangent is 1 at u and 0 elsewhere: its dx
    row is m W[:, u], m = 1 where the backward took z > 0 and ``slope``
    elsewhere.  On CPU tensors both are the plain versions."""
    import torch

    from pointcloudattack_tpu_torch.ops import group_chain as gch

    if len(layers) != 1:
        raise ValueError(f"mask_flips reads a one-layer mean's masks, got {len(layers)} layers")
    b, g, k, c0 = x.shape
    w = layers[0][0]
    with torch.no_grad():
        z, _ = gch.chain_groupmax_fwd(x.reshape(b, g * k, 1, c0).contiguous(), layers, slope)
        z = z.reshape(b, g, k, -1)
        flips = 0
        for u in range(w.shape[1]):
            onehot = torch.zeros((b, g, w.shape[1]), dtype=torch.float32, device=x.device)
            onehot[..., u] = 1.0
            dx = gch.chain_groupmean_bwd(x, layers, onehot, slope)
            at = int(w[:, u].abs().argmax())
            took = dx[..., at] / w[at, u] > (1.0 + slope) / 2
            flips += int((took != (z[..., u] > 0)).sum())
    return flips


def check_group(name, pool, x, layers, dy, slope=CN_SLOPE, tag="kernels-curvenet"):
    """The group chain kernel (``pool`` "max" or "mean") against its plain
    version on one case, both on the card: y within Y_TOL; for the max the
    argmax equal except at near ties and every card pick at most PICK_ATOL
    below the plain max; dx within DX_TOL on the rows that carry a
    cotangent (the max's winning rows, every row for the mean), except rows
    with an activated pre-activation within EDGE of 0, which may take the
    other slope on either side (counted); two backwards bit-equal; for a
    mean that runs the one-layer kernels no unit whose backward mask differs
    from the forward's sign (``mask_flips``).  Returns (errors, am_ref or
    None, g, rows that carry a cotangent)."""
    import torch

    from pointcloudattack_tpu_torch.ops import _build
    from pointcloudattack_tpu_torch.ops import group_chain as gch

    b, ng, k, _ = x.shape
    lib = _build.load_library()
    mean1 = pool == "mean" and gch.one_layer_kernel(lib, lib.pca_group_mean1_smem, k,
                                                      [x.shape[-1]] + [l[0].shape[1] for l in layers])
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
        twice(name, "group max backward", (dx,), (gch.chain_groupmax_bwd(x, layers, am_ref, g, slope),))
        dx_ref = gch.chain_groupmax_bwd_plain(x, layers, am_ref, g, slope)
        carry = winners(am_ref, k)  # [B, G, K]
        extra = (f"argmax equal except {int((am != am_ref).sum())} of {int(near.sum())} near-tie columns, "
                 f"card picks at most {below:.3e} below the plain max; ")
    else:
        y, y_ref, am_ref = gch.chain_groupmean_fwd(x, layers, slope), gch.chain_groupmean_plain(x, layers, slope), None
        g = (dy * mul / k).contiguous()
        dx = gch.chain_groupmean_bwd(x, layers, g, slope)
        twice(name, "group mean backward", (dx,), (gch.chain_groupmean_bwd(x, layers, g, slope),))
        dx_ref = gch.chain_groupmean_bwd_plain(x, layers, g, slope)
        carry = torch.ones(x.shape[:3], dtype=torch.bool, device=x.device)
        extra = ""
        if mean1:
            flips = mask_flips(x, layers, slope)
            if flips:
                raise AssertionError(f"{name}: {flips} units' backward masks differ from the forward's signs")
            # the product back the wrapper does not take (time_group times it), held to dx's rules below
            dx_other = gch._mean1_bwd_kernel(x, layers, g, slope, not gch.mean1_tc(*layers[0][0].shape))
            extra = "0 backward masks differ from the forward's signs; "
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **Y_TOL)
    edge = torch.zeros_like(carry)
    for zl in zs + ([z] if pool == "mean" else []):  # the activated pre-activations
        edge |= (zl.abs() <= EDGE).any(-1)
    edge &= carry
    torch.testing.assert_close(dx[~edge], dx_ref[~edge], **DX_TOL)
    errs = {"y": float((y - y_ref).abs().max()), "dx": float((dx - dx_ref)[~edge].abs().max())}
    if mean1:
        torch.testing.assert_close(dx_other[~edge], dx_ref[~edge], **DX_TOL)
        extra += f"the other product back's dx max|err| {float((dx_other - dx_ref)[~edge].abs().max()):.3e}; "
    log(f"[{tag}] {pool} {name} x {tuple(x.shape)} chain {[x.shape[-1]] + [l[0].shape[1] for l in layers]} "
        f"slope {slope}: y max|err| {errs['y']:.3e}; {extra}{int(carry.sum())} of {carry.numel()} rows carry a "
        f"cotangent, {int(edge.sum())} of them an activated unit within {EDGE} of 0 (left out); dx max|err| "
        f"{errs['dx']:.3e} (all rows {float((dx - dx_ref).abs().max()):.3e}); two backwards bit-equal")
    return errs, am_ref, g, int(carry.sum())


def group_bound(b, g, k, dims, pool, carry=None, fp32=False):
    """(bound_ms, bound_by) of a group chain forward or, with ``carry``
    rows carrying a cotangent, of its backward, counted as ``chain_bound``
    counts them: the forward's chain over every row; the max's backward
    over the winning rows (``chain_bwd_flops``), the mean's over every row,
    recomputed and run back; the pooled output (and the argmax) written or
    read once, dx written once, and the rows read once where a pass needs
    them: the max's one-layer backward (dx = g on the argmax rows times
    W^T) needs none.  The one-layer mean's backward recomputes in FP32 (its
    masks are the forward's signs) and may run its product back on the
    tensor cores as 3xTF32 (``tc_bound``); ``fp32`` counts that product
    over the FP32 peak too."""
    rows = b * g * k
    out = 4.0 * b * g * dims[-1] * (2 if pool == "max" else 1)
    x_bytes = 4.0 * rows * dims[0]
    if carry is None:
        return bound(chain_flops(rows, dims), x_bytes + out + param_bytes(dims))
    flops = chain_bwd_flops(carry, b * g, dims) if pool == "max" else 2 * chain_flops(rows, dims)
    reads_x = pool == "mean" or len(dims) > 2
    nbytes = (2 if reads_x else 1) * x_bytes + out + 2 * param_bytes(dims)
    if pool == "mean" and len(dims) == 2 and not fp32:
        return tc_bound(chain_flops(rows, dims), chain_flops(rows, dims), nbytes)
    return bound(flops, nbytes)


def time_group(name, pool, x, layers, am, g, carry, slope=CN_SLOPE, tag="kernels-curvenet"):
    """Group kernel and plain times at one case, and the bounds; for a
    one-layer mean the backward's other product back beside the one the
    wrapper takes (``other``), on the same inputs."""
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
        if len(layers) == 1:
            tc = gch.mean1_tc(*layers[0][0].shape)
            fns["bwd_other"] = lambda: gch._mean1_bwd_kernel(x, layers, g, slope, not tc)
    ms = time_pairs(fns)
    ms["fwd_device"], ms["bwd_device"] = device_ms(fns["fwd"]), device_ms(fns["bwd"])
    b, ng, k, _ = x.shape
    dims = [x.shape[-1]] + [layer[0].shape[1] for layer in layers]
    b_fwd, b_bwd = group_bound(b, ng, k, dims, pool), group_bound(b, ng, k, dims, pool, carry)
    other = ""
    if "bwd_other" in fns:
        ms["bwd_other_device"] = device_ms(fns["bwd_other"])
        ms["bound_fp32"] = group_bound(b, ng, k, dims, pool, carry, fp32=True)
        other = (f"; the product back {'in FP32' if tc else 'as 3xTF32'} instead: {ms['bwd_other']:.4f} "
                 "ms, device " + (", ".join(f"{n} {v:.4f}" for n, v in ms["bwd_other_device"].items())
                                  or "not measured") + f"; the bound in FP32 only {ms['bound_fp32'][0]:.5f} by "
                 f"{ms['bound_fp32'][1]}")
    log(f"[{tag}] {pool} {name} chain {dims}: forward {ms['fwd']:.4f} ms (device "
        + (", ".join(f"{n} {v:.4f}" for n, v in ms["fwd_device"].items()) or "not measured") + "; plain "
        f"{ms['fwd_plain']:.4f}, "
        f"bound {b_fwd[0]:.5f} by {b_fwd[1]} over {b * ng * k} rows), backward {ms['bwd']:.4f} ms (device "
        + (", ".join(f"{n} {v:.4f}" for n, v in ms["bwd_device"].items()) or "not measured") + "; plain "
        f"{ms['bwd_plain']:.4f}, bound {b_bwd[0]:.5f} by {b_bwd[1]} over the {carry} rows with a cotangent{other})")
    return ms, b_fwd, b_bwd


def phase_kernels_curvenet():
    """The group chain kernels at the nine LPFA shapes of one CurveNet
    forward (B=8, K=20), then at a ragged G=1000, K=1 over 1024 groups, B=1,
    K=7, K=64, widths 3 -> 300 and with 2-layer chains, and the max backward
    at MAX_BWD_EDGE_CASES' argmaxes; the record's numbers sum the nine LPFAs
    of one forward (and backward), and the mean backward's device time the
    eight residual ones'.  The one-layer mean backward's tiles (32 to 256
    rows) straddle K=20's groups; the one-layer forward's hold whole groups
    (a ragged G ends one inside a cloud)."""
    import torch

    from pointcloudattack_tpu_torch.ops import group_chain as gch

    rec = new_record("group_max_fwd", "group_max_bwd", "group_mean_fwd", "group_mean_bwd")
    for key in rec:
        rec[key]["device_ms"] = 0.0
    for i, (name, (ng, c0, widths, pool)) in enumerate(CURVENET_GROUP_SHAPES.items()):
        x, layers, dy = group_case(60 + i, CN_B, ng, CN_K, (c0, *widths))
        errs, am, g, carry = check_group(name, pool, x, layers, dy)
        ms, b_fwd, b_bwd = time_group(name, pool, x, layers, am, g, carry)
        for key, d in ((f"group_{pool}_fwd", "fwd_device"), (f"group_{pool}_bwd", "bwd_device")):
            if key != "group_mean_bwd":  # None once a launch was not measured
                dev = sum(ms[d].values()) if ms[d] else None
                rec[key]["device_ms"] = None if dev is None or rec[key]["device_ms"] is None else rec[key]["device_ms"] + dev
        if pool == "mean":
            dev = sum(ms["bwd_device"].values()) if ms["bwd_device"] else None  # None: not measured
            rec["group_mean_bwd"]["device_ms"] = (None if dev is None or rec["group_mean_bwd"]["device_ms"] is None
                                                  else rec["group_mean_bwd"]["device_ms"] + dev)
            dev_other = sum(ms["bwd_other_device"].values()) if ms["bwd_other_device"] else None
            rec["group_mean_bwd"].setdefault("shapes", {})[f"{name} {tuple(x.shape)} -> {widths[-1]}"] = {
                "ms": ms["bwd"], "plain_ms": ms["bwd_plain"], "device_ms": dev, "bound_ms": b_bwd[0],
                "bound_fp32_ms": ms["bound_fp32"][0], "max_abs_err": errs["dx"], "other_ms": ms["bwd_other"],
                "other_device_ms": dev_other, "tc": gch.mean1_tc(c0, widths[-1])}
        for key, e, m, p, bb, rows in ((f"group_{pool}_fwd", errs["y"], ms["fwd"], ms["fwd_plain"], b_fwd,
                                        x.shape[0] * ng * CN_K),
                                       (f"group_{pool}_bwd", errs["dx"], ms["bwd"], ms["bwd_plain"], b_bwd, carry)):
            rec[key]["err"] = max(rec[key]["err"], e)
            accumulate(rec[key], m, p, bb, rows)
    dev = {key: rec[key]["device_ms"] for key in ("group_max_fwd", "group_mean_fwd", "group_max_bwd")}
    log("[kernels-curvenet] the one-layer kernels' device time: " + ", ".join(
        f"{what} {'not measured' if dev[key] is None else f'{dev[key]:.4f} ms'}"
        for what, key in (("the initial LPFA's max forward", "group_max_fwd"),
                          ("the eight mean forwards", "group_mean_fwd"),
                          ("the initial LPFA's max backward", "group_max_bwd"))))
    eight = rec["group_mean_bwd"]["shapes"].values()
    if all(s["device_ms"] is not None and s["other_device_ms"] is not None for s in eight):
        tf32 = sum(s["device_ms"] if s["tc"] else s["other_device_ms"] for s in eight)
        fp32 = sum(s["other_device_ms"] if s["tc"] else s["device_ms"] for s in eight)
        dev = (f"{sum(s['device_ms'] for s in eight):.4f} ms as the wrapper takes them (group_chain.mean1_tc: FP32 "
               f"up to 16 wide, 3xTF32 past it), {tf32:.4f} with the product back as 3xTF32 at every width, "
               f"{fp32:.4f} in FP32 at every width")
    else:
        dev = "not measured"
    log(f"[kernels-curvenet] the eight mean backwards on the same inputs, device time {dev}; through the wrapper "
        f"{sum(s['ms'] for s in eight):.4f} ms (the other product backs {sum(s['other_ms'] for s in eight):.4f}); "
        f"bound {sum(s['bound_ms'] for s in eight):.4f} ms (in FP32 only {sum(s['bound_fp32_ms'] for s in eight):.4f})")
    for j, (name, b, ng, k, dims) in enumerate((("ragged G=1000", CN_B, 1000, CN_K, (9, 32)),
                                                 ("ragged G=1000", CN_B, 1000, CN_K, (16, 16)),
                                                 ("K=1 over 1024 groups", CN_B, 1024, 1, (9, 32)),
                                                 ("B=1", 1, 1024, CN_K, (9, 32)),
                                                 ("K=7", 4, 333, 7, (16, 24)),
                                                 ("K=64", 2, 50, 64, (32, 32)),
                                                 ("widths 3 -> 300, K=33", 1, 7, 33, (3, 300)),
                                                 ("2 layers", 4, 256, CN_K, (9, 32, 32)),
                                                 ("2 layers", 4, 256, CN_K, (32, 64, 32)))):
        for pool in ("max", "mean"):
            errs, *_ = check_group(name, pool, *group_case(80 + 2 * j + (pool == "mean"), b, ng, k, dims))
            rec[f"group_{pool}_fwd"]["err"] = max(rec[f"group_{pool}_fwd"]["err"], errs["y"])
            rec[f"group_{pool}_bwd"]["err"] = max(rec[f"group_{pool}_bwd"]["err"], errs["dx"])
    for j, (name, b, ng, k, dims, kind) in enumerate(MAX_BWD_EDGE_CASES):
        err = check_max_bwd(name, *max_bwd_case(100 + j, b, ng, k, dims, kind))
        rec["group_max_bwd"]["err"] = max(rec["group_max_bwd"]["err"], err)
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
    """Each LPFA stage three ways at the path's shapes: the neighbour rows,
    then the fused group kernel (and LeakyReLU after the initial block's
    max); the gather route (``fused_gather``: the gather kernel on the
    points, or on the folded sources); and the unfused plain layer (the
    same rows, matmul, BN, LeakyReLU, pool), forward and forward + input
    backward; each route's output within Y_TOL of the unfused layer's."""
    import torch

    for i, (lpfa, x, xyz, idx) in enumerate(inputs):
        def fused(a, p, gather=False):
            lpfa.fused_gather = gather
            try:
                return lpfa(a, p, idx)
            finally:
                lpfa.fused_gather = False

        unfused = lambda a, p: lpfa.unfused(lpfa.rows(a, p, idx))  # noqa: E731
        want = unfused(x, xyz)
        torch.testing.assert_close(fused(x, xyz), want, **Y_TOL)
        torch.testing.assert_close(fused(x, xyz, True), want, **Y_TOL)
        leaves = [t.clone().requires_grad_(True) if t is not None else None for t in (x, xyz)]
        wrt = [t for t in leaves if t is not None]
        ms = time_pairs({
            "unfused": lambda: unfused(x, xyz), "fused": lambda: fused(x, xyz),
            "gather": lambda: fused(x, xyz, True),
            "gather_fb": lambda: torch.autograd.grad(fused(*leaves, True).sum(), wrt),
            "fused_fb": lambda: torch.autograd.grad(fused(*leaves).sum(), wrt),
            "unfused_fb": lambda: torch.autograd.grad(unfused(*leaves).sum(), wrt),
        }, reps=10)
        kind = "initial (max)" if lpfa.initial else "residual (mean)"
        log(f"[kernels-curvenet] LPFA {i} {kind} xyz {tuple(xyz.shape)} k={lpfa.k} -> "
            f"{lpfa.mlp[-1][1].num_features}: fused forward {ms['fused']:.4f} ms, gather route {ms['gather']:.4f} "
            f"ms, unfused plain {ms['unfused']:.4f} ms; forward + input backward fused {ms['fused_fb']:.4f} ms, "
            f"gather route {ms['gather_fb']:.4f} ms, unfused {ms['unfused_fb']:.4f} ms")
    torch.cuda.empty_cache()


def phase_parity_curvenet(model_fn, state, data, target, tag="parity-curvenet", gather=False):
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
    gradient difference d moves Adam's steps about lr * d apart.  With
    ``gather``, both sides run the gather route and the CPU also takes the
    gather means' signs."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.attacks.cw import CWPerturbConfig, build_cw_attack
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b = 2
    cfg = CWPerturbConfig(binary_step=1, num_iter=10, kappa=KAPPA, budget=BUDGET)
    noise = torch.from_numpy(np.random.RandomState(5).randn(1, b, N, 3).astype(np.float32))
    cpu_fn = make_model_fn(models.make_model("CurveNet", NUM_CLASSES, fused_gather=gather), state, "cpu")
    its, grads = {"card": [], "cpu": []}, {"card": [], "cpu": []}
    recording = lambda fn, side: recording_fn(fn, its[side], grads[side])  # noqa: E731
    with replay({**pick_hooks(), **curvenet_hooks(gather=gather)}) as stats:
        res_gpu = build_cw_attack(recording(model_fn, "card"), cfg)(data[:b], target[:b], init_noise=noise.cuda())
        res_cpu = build_cw_attack(recording(cpu_fn, "cpu"), cfg)(data[:b].cpu(), target[:b].cpu(), init_noise=noise)
    if not all(len(v) == cfg.num_iter for v in (*its.values(), *grads.values())):
        raise AssertionError(f"{tag}: recorded {[len(v) for v in its.values()]} iterates and "
                             f"{[len(v) for v in grads.values()]} gradients, expected {cfg.num_iter} each")
    apart = (torch.stack(its["card"]) - torch.stack(its["cpu"])).abs().flatten(2).amax(-1)  # [S, b]
    log(f"[{tag}] card vs CPU, CurveNet B={b} 1x10: success card {res_gpu.success.tolist()} cpu "
        f"{res_cpu.success.tolist()}; best_dist card {res_gpu.best_dist.tolist()} cpu {res_cpu.best_dist.tolist()}; "
        f"iterates max |diff| per step and cloud {[[float(f'{v:.3g}') for v in row] for row in apart]}; in the "
        f"attacks the CPU took the card's choices: {choice_line(stats)}")
    if not torch.equal(res_gpu.success.cpu(), res_cpu.success):
        raise AssertionError(f"{tag}: success differs between the card and the CPU")
    if not bool(res_cpu.success.any()):
        raise AssertionError(f"{tag}: the short attack flipped no cloud")
    at, steps, unsigned = [], [], []
    for a in its["card"]:
        steps.append(grad_parity(model_fn, cpu_fn, a.cuda(), data[:b], target[:b], choices=at, gather=gather))
        unsigned.append(grad_parity(model_fn, cpu_fn, a.cuda(), data[:b], target[:b], signs=False)["grad"])
    log(f"[{tag}] at the card's first iterate the CPU took the card's choices: {choice_line(at[0])}")
    signed_kinds = [k for k in ("sign", "mean", "gmean") if k in at[0]]
    flips = torch.stack([sum(n for k in signed_kinds for n in st[k]["other"]) for st in at])  # [S, b]
    unsigned = torch.stack(unsigned)
    near = sum(st[k]["near"] for st in at for k in st)
    log(f"[{tag}] over the {len(at)} iterates, {near} of "
        f"{sum(st[k]['choices'] for st in at for k in st)} choices and activation inputs lay within {TIE_GAP} of a "
        f"tie or of 0 on the CPU ({sum(st[k]['exact'] for st in at for k in st)} exact); activation inputs on the "
        f"other side of 0 than on the card, per iterate and cloud, {flips.tolist()} (each at most "
        f"{max(st[k]['off'] for st in at for k in signed_kinds):.3e} from 0); with every choice but these signs "
        f"replayed, the loss gradient's relative L2 difference {[[float(f'{v:.3g}') for v in row] for row in unsigned]}"
        f", {float((unsigned <= GRAD_CLEAN).float().mean()):.3f} of the pairs within {GRAD_CLEAN} (of those with no "
        f"input on the other side, {float((unsigned[flips == 0] <= GRAD_CLEAN).float().mean()):.3f})")
    hold_grad_parity(tag, steps)


def curvenet_path(name="CurveNet"):
    """The CurveNet victim on bench.py's cw_curvenet clouds, its LPFA stages
    every way, its counted C&W and GeoA3 attacks, card against CPU and the
    profile, and C&W on the gather route (counted, in turns with the grouped
    route, card against CPU); returns the launch counts of C&W, of GeoA3
    and of C&W on the gather route, and row 9's record at the nine kNN
    inputs of one forward."""
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.models import curvenet as curvenet_mod
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    data, labels = synthetic_data(8, 1, CN_DATA, "cuda")
    fn, state = make_victim(name, "cuda", data, ("dp1",))
    target = victim_labels(fn, data, labels, "slice-curvenet")
    model = models.make_model(name, NUM_CLASSES)
    model_fn = make_model_fn(model, state, "cuda")  # the victim again, its LPFAs to be timed alone
    with phase_clock("kernels-knn (CurveNet)"):
        with knn_inputs(curvenet_mod) as inputs, torch.no_grad():
            model_fn(data)
        if len(inputs) != CN_LAUNCHES[0]["knn"]:
            raise AssertionError(f"CurveNet ran {len(inputs)} kNNs a forward, expected {CN_LAUNCHES[0]['knn']}")
        knn = {f"curvenet knn{i + 1} {tuple(x.shape)} k={k}": time_knn("kernels-knn", f"CurveNet's kNN {i + 1} of 9",
                                                                       x, k)
               for i, (x, k) in enumerate(inputs)}
        log("[kernels-knn] per CurveNet forward (its nine kNNs): "
            f"{sum(r['ms'] for r in knn.values()):.4f} ms, plain {sum(r['plain_ms'] for r in knn.values()):.4f} ms, "
            f"bound {sum(r['bound_ms'] for r in knn.values()):.4f} ms; device "
            f"{sum(sum(r['device_ms'].values()) for r in knn.values()):.4f} ms")
    with phase_clock("kernels-curvenet (LPFA stages)"):
        lpfa_fused_vs_unfused(lpfa_inputs(model, model_fn, data))
    per_fwd, per_bwd = CN_LAUNCHES
    with phase_clock("slice-curvenet"):
        cw = run_attack("slice-curvenet", fn, data, target, CN_ITER, per_fwd, per_bwd)
    with phase_clock("parity-curvenet"):
        phase_parity_curvenet(fn, state, data, target)
    # the gather route (fused_gather=True) on the same victim and clouds
    gather_fn = make_model_fn(models.make_model(name, NUM_CLASSES, fused_gather=True), state, "cuda")
    with phase_clock("slice-curvenet-gather"):
        cw_gather = run_attack("slice-curvenet-gather", gather_fn, data, target, CN_ITER, *CN_GATHER_LAUNCHES, reps=0)
        in_turns("slice-curvenet-gather", {"grouped route": fn, "gather route": gather_fn}, data, target, CN_ITER)
    with phase_clock("parity-curvenet-gather"):
        phase_parity_curvenet(gather_fn, state, data, target, "parity-curvenet-gather", gather=True)
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
    return cw, geo, cw_gather, knn


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


def loss_grad(fn, a, ori, target, loss_fn=cw_loss):
    """(log-probs, the input gradient of ``loss_fn``, the CW loss by
    default) of ``fn`` at ``a``."""
    import torch

    a = a.detach().clone().requires_grad_(True)
    logp = fn(a)
    (g,) = torch.autograd.grad(loss_fn(logp, a, ori, target).sum(), a)
    return logp.detach(), g


def first_step_spread(tag, fn, data, target):
    """Two card runs of the first step of the attack ``tag`` times: the CW
    loss's input gradient at its first iterate (the clouds plus the start
    noise of seed 1), twice, which must be bit-equal: no kernel on the
    PointNet++ paths adds a float with an atomic (ROADMAP Queue 3 item 1).
    Logs the largest difference; returns it."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    a0 = data + torch.randn(data.shape, generator=gen, device="cuda") * 1e-7
    (_, g1), (_, g2) = (loss_grad(fn, a0, data, target) for _ in range(2))
    d = float((g1 - g2).abs().max())
    log(f"[{tag}] the first step's loss gradient, two runs on the card: max |diff| {d:.3e} (largest |gradient| "
        f"{float(g1.abs().max()):.3e}; {int((g1 != g2).sum())} of {g1.numel()} coordinates differ)")
    if not torch.equal(g1, g2):
        raise AssertionError(f"{tag}: two runs of the first step's gradient differ in {int((g1 != g2).sum())} "
                             f"coordinates")
    return d


@contextlib.contextmanager
def op_trace(targets, inputs=False):
    """While open, records in run order what each function ``(module,
    name)`` of ``targets`` returns, its tensors flattened into one, or with
    ``inputs`` its positional arguments, each tensor detached and copied;
    yields the list of (name, record)."""
    import torch

    def copied(a):
        if torch.is_tensor(a):
            return a.detach().clone(memory_format=torch.contiguous_format)
        return type(a)(copied(v) for v in a) if isinstance(a, (list, tuple)) else a

    rec, saved = [], []
    for mod, name in targets:
        def traced(*args, _fn=getattr(mod, name), _name=f"{mod.__name__.rsplit('.', 1)[-1]}.{name}", **kw):
            if inputs:
                rec.append((_name, copied(args)))
            out = _fn(*args, **kw)
            if not inputs:
                outs = out if isinstance(out, tuple) else (out,)
                rec.append((_name, torch.cat([o.detach().flatten().double() for o in outs if torch.is_tensor(o)])))
            return out

        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, traced)
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def traced_first_steps(tag, fn, data, target, loss, targets):
    """A reading, not a check: the input gradient of ``loss`` at the first
    iterate (the clouds plus the start noise of seed 1), twice on the
    clouds' device, each run under ``op_trace(targets)``: how many
    coordinates differ, and the first traced op whose bits part, if any
    (ROADMAP Queue 3 item 1).  Logs them; returns (the count, the op's
    name or None)."""
    import torch

    gen = torch.Generator(device=data.device).manual_seed(1)
    a0 = data + torch.randn(data.shape, generator=gen, device=data.device) * 1e-7
    runs = []
    for _ in range(2):
        with op_trace(targets) as rec:
            _, grad = loss_grad(fn, a0, data, target, loss)
        runs.append((rec, grad))
    (r1, g1), (r2, g2) = runs
    if [n for n, _ in r1] != [n for n, _ in r2]:
        raise AssertionError(f"{tag}: the two runs traced different ops")
    parted = next((n for (n, u), (_, v) in zip(r1, r2) if not torch.equal(u, v)), None)
    differ = int((g1 != g2).sum())
    log(f"[{tag}] first_step_spread (a reading): the first step's loss gradient, two runs on "
        f"{'the card' if data.is_cuda else 'the CPU'}: {differ} of {g1.numel()} coordinates differ, max |diff| "
        f"{float((g1 - g2).abs().max()):.3e} (largest |gradient| {float(g1.abs().max()):.3e}); of the {len(r1)} "
        "traced ops (" + ", ".join(sorted({n for n, _ in r1})) + ") "
        + ("every one bit-equal" if parted is None else f"the first to part: {parted}"))
    return differ, parted


def geoa3_first_steps(tag, fn, data, target, cached=False):
    """``traced_first_steps`` of GeoA3's first-round loss (CE plus 10 x the
    bundle and the curvature, on the card's normals), tracing the chain,
    bundle and curvature kernels' wrappers, forward and backward; with
    ``cached``, the curvature on the iterate's own neighbour set (the kNN
    and the given-set kernels, as at curv_knn_refresh > 1).  Returns (the
    count of coordinates that differ, the op that parts or None)."""
    from pointcloudattack_tpu_torch.geometry.normals import estimate_normal
    from pointcloudattack_tpu_torch.losses import geometry
    from pointcloudattack_tpu_torch.losses.geometry import kappa_ori
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import chamfer, kappa

    nrm = estimate_normal(data)
    dev = data.device.type
    loss = geoa3_loss({dev: nrm}, {dev: kappa_ori(data, nrm, GEO_K)}, cached=cached)
    targets = ((cm, "chain_maxpool_fwd"), (cm, "chain_maxpool_bwd"), (chamfer, "both_fwd"), (chamfer, "both_bwd"))
    targets += (((geometry, "knn"), (kappa, "kappa_idx_fwd"), (kappa, "kappa_bwd")) if cached else
                ((kappa, "kappa_fwd"), (kappa, "kappa_bwd")))
    return traced_first_steps(tag, fn, data, target, loss, targets)


def knn_first_steps(tag, fn, data, target):
    """``traced_first_steps`` of the KNN attack's loss (the adversarial
    loss plus N x the Chamfer row min), tracing the chain's wrappers and
    the row min's.  Returns (the count, the op that parts or None)."""
    from pointcloudattack_tpu_torch.ops import chain_maxpool as cm
    from pointcloudattack_tpu_torch.ops import chamfer

    targets = ((cm, "chain_maxpool_fwd"), (cm, "chain_maxpool_bwd"), (chamfer, "min_rows_fwd"))
    return traced_first_steps(tag, fn, data, target, knn_loss, targets)


@contextlib.contextmanager
def dgcnn_trace():
    """While open, records in run order what DGCNN's EdgeConvs compute: each
    kNN's indices, each gather op's output, the cotangent it receives and
    the input gradients its backward returns; yields the list of (name,
    tensor)."""
    import torch

    from pointcloudattack_tpu_torch.models import dgcnn as dg
    from pointcloudattack_tpu_torch.ops import gather_chain as gc

    rec, at = [], {"knn": 0, "gather": 0, "cot": None}
    knn0, gather0, bwd0 = dg.knn, dg.gather_chain_groupmax, gc.gather_chain_bwd

    def knn(x, k):
        at["knn"] += 1
        out = knn0(x, k)
        rec.append((f"EdgeConv {at['knn']}'s kNN", out.clone()))
        return out

    def gather(*args, **kw):
        at["gather"] += 1
        stage = at["gather"]
        y = gather0(*args, **kw)
        rec.append((f"EdgeConv {stage}'s gather forward", y.detach().clone()))

        def hook(g):
            at["cot"] = stage
            rec.append((f"the cotangent into EdgeConv {stage}'s gather", g.detach().clone()))

        if y.requires_grad:
            y.register_hook(hook)
        return y

    def bwd(*args, **kw):
        out = bwd0(*args, **kw)
        rec.append((f"EdgeConv {at['cot']}'s gather backward (dsrc, dctr)", torch.cat([o.flatten() for o in out])))
        return out

    dg.knn, dg.gather_chain_groupmax, gc.gather_chain_bwd = knn, gather, bwd
    try:
        yield rec
    finally:
        dg.knn, dg.gather_chain_groupmax, gc.gather_chain_bwd = knn0, gather0, bwd0


def dgcnn_first_steps(tag, fn, data, target):
    """The CW loss's input gradient at slice-dgcnn's first iterate, twice on
    the card, each run traced (``dgcnn_trace``): whether the two agree bit
    for bit, and if not, the first traced op whose bits part; returns the
    gradients' max |diff|."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    a0 = data + torch.randn(data.shape, generator=gen, device="cuda") * 1e-7
    runs = []
    for _ in range(2):
        with dgcnn_trace() as rec:
            _, grad = loss_grad(fn, a0, data, target)
        runs.append((rec, grad))
    (r1, g1), (r2, g2) = runs
    if [n for n, _ in r1] != [n for n, _ in r2]:
        raise AssertionError(f"{tag}: the two runs traced different ops")
    parted = next((n for (n, u), (_, v) in zip(r1, r2) if not torch.equal(u, v)), None)
    d = float((g1 - g2).abs().max())
    log(f"[{tag}] the first step's loss gradient, two runs on the card: "
        + ("bit-equal" if torch.equal(g1, g2) else f"max |diff| {d:.3e}, {int((g1 != g2).sum())} of {g1.numel()} "
           f"coordinates differ") + f" (largest |gradient| {float(g1.abs().max()):.3e}); of the {len(r1)} traced "
        f"ops (kNN, gather forward, cotangent, gather backward) "
        + ("every one bit-equal" if parted is None else f"the first to part: {parted}"))
    return d


def dgcnn_routes(state, data, target, kernel_fn):
    """C&W 1 x DG_ITER on DGCNN through each EdgeConv route, DG_TURNS times
    each in turns: the one-layer route's kernels (the model's eval route),
    ``EdgeConv.unfused`` and ``graph_feature`` then the group kernel
    (``mlp_chain_groupmax``, the JAX package's own fused route); the last
    two live only here.  Each route's EdgeConv outputs are first held to
    the model's on the four stage inputs of one forward, on the same kNN
    (Y_TOL: after a stage the kNN in feature space may pick another
    neighbour on rounding, so whole forwards are not compared); logs the
    route that was fastest in every turn, if one was; returns the times."""
    import torch
    import torch.nn.functional as F

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.models.dgcnn import SLOPE, graph_feature
    from pointcloudattack_tpu_torch.ops.gather_chain import gather_chain_groupmax
    from pointcloudattack_tpu_torch.ops.group_chain import mlp_chain_groupmax
    from pointcloudattack_tpu_torch.ops.knn import knn
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    def hoisted(e, x, idx):
        c = x.shape[-1]
        return F.leaky_relu(gather_chain_groupmax(x, x, idx, [e.fused_layer()], (("diff", 0, c, 0), ("center", 0, c))),
                            SLOPE)

    def grouped(e, x, idx):
        return F.leaky_relu(mlp_chain_groupmax(graph_feature(x, e.k, idx), [e.fused_layer()]), SLOPE)

    routes = {"EdgeConv.unfused": lambda e, x, idx: e.unfused(x, idx), "graph_feature + group kernel": grouped}
    with knn_inputs() as inputs, torch.no_grad():
        kernel_fn(data)
    arms = {"gather_hoist kernels": kernel_fn}
    for name, route in routes.items():
        model = models.make_model("DGCNN", NUM_CLASSES)
        fn = make_model_fn(model, state, "cuda")
        with torch.no_grad():
            for (x, k), e in zip(inputs, model.edges):
                idx = knn(x, k)
                torch.testing.assert_close(route(e, x, idx), hoisted(e, x, idx), **Y_TOL)
        model.edges = [(lambda e, r=route: lambda x, train=False: r(e, x, knn(x, e.k)))(e) for e in model.edges]
        cw_attack(fn, 2)(data, target)  # warm-up
        arms[name] = fn
    log(f"[slice-dgcnn-routes] each route's EdgeConvs within {Y_TOL} of the model's on the stage inputs")
    times = in_turns("slice-dgcnn-routes", arms, data, target, DG_ITER, DG_TURNS)
    best = [n for n, ts in times.items()
            if all(t < min(times[o][i] for o in times if o != n) for i, t in enumerate(ts))]
    log(f"[slice-dgcnn-routes] fastest in every one of the {DG_TURNS} turns: "
        + (best[0] if best else "no route (the runs overlap)"))
    return times


# BASELINE config 5 (AOF/TAOF and the SIadv family) on PointNet at bench.py's settings, 40 classes.
# aof (bench.py:381-407): make_synthetic_clouds(8, 1, 1024, seed=1), B=8, 2 rounds x 100, kappa 0,
# budget 0.45, low_pass 100 (Chebyshev: 5 x 100 < 1024), one basis (k=30) from the clean clouds
AOF_DATA, AOF_ROUNDS, AOF_ITER, AOF_KAPPA, AOF_BUDGET, AOF_LOW_PASS, AOF_K = 1, 2, 100, 0.0, 0.45, 100, 30
# si_ifgm and si_ifgm_r5 (bench.py:499-531): make_synthetic_clouds(8, 8, 1024, seed=2), B=64, eps 0.18,
# step 0.007, 50 steps, the normals (k=20: a kNN of 21) every step or every 5
SI_DATA, SI_STEPS, SI_EPS, SI_STEP, SI_K = 2, 50, 0.18, 0.007, 20
# si_query (bench.py:332-369): make_synthetic_clouds(8, 4, 1024, seed=14), B=32, eps 0.18, step 0.32; SimBA
# and SimBA++ (no bench cell) on its first SIMBA_B clouds at the same step, up to SIMBA_QUERIES iterations
SIQ_DATA, SIQ_STEP, SIMBA_B, SIMBA_QUERIES = 14, 0.32, 8, 3 * 1024
# PointNet forwards outside a query loop, backwards and kNNs of each query attack; each loop
# iteration adds two forwards (the +step and the -step probe)
QUERY_LAUNCHES = {"simba": (2, 0, 0), "simbapp": (3, 1, 0), "si-query": (3, 1, 1)}
# card against CPU: a coordinate's two gradients further apart than SWITCH of its cloud's largest
# |gradient| come from a max-pool pick or an activation's side taken otherwise (rounding alone
# leaves them within 3e-7 on the CPU against the JAX package, tests/test_torch_aof.py)
SWITCH = 1e-4


def aof_attack(fn, targeted=False, rounds=AOF_ROUNDS, iters=AOF_ITER):
    from pointcloudattack_tpu_torch.attacks.aof import AOFConfig, build_aof_attack

    return build_aof_attack(fn, AOFConfig(binary_step=rounds, num_iter=iters, kappa=AOF_KAPPA, budget=AOF_BUDGET,
                                          low_pass=AOF_LOW_PASS, knn_k=AOF_K, targeted=targeted))


def si_ifgm_attack(fn, refresh=1, steps=SI_STEPS):
    from pointcloudattack_tpu_torch.attacks.siadv import SIAdvConfig, build_si_ifgm

    return build_si_ifgm(fn, fn, SIAdvConfig(eps=SI_EPS, step_size=SI_STEP, max_steps=steps,
                                             normal_refresh=refresh, normal_k=SI_K))


def query_attack(family, fn, max_queries=SIMBA_QUERIES):
    """``attack(data, target, generator=None) -> QueryResult`` of one query
    family, the victim its own white box."""
    from pointcloudattack_tpu_torch.attacks import siadv

    cfg = siadv.SIAdvConfig(eps=SI_EPS, step_size=SIQ_STEP, max_queries=max_queries, normal_k=SI_K)
    if family == "simba":
        return siadv.build_simba(fn, cfg)
    if family == "simbapp":
        return siadv.build_simbapp(fn, fn, cfg)
    run = siadv.build_si_query_attack(fn, fn, cfg)
    return lambda d, t, generator=None: run(d, t)


def run_aof(tag, fn, data, target, truth=None):
    """AOF (TAOF, with the true labels ``truth``) at the aof cell's settings,
    counted and timed: per round 2 forwards and 2 backwards a step and 2
    forwards after the last, one forward at the end, one kNN (the basis)."""
    targeted = truth is not None
    run = aof_attack(fn, targeted)
    fwd, bwd = AOF_ROUNDS * (2 * AOF_ITER + 2) + 1, 2 * AOF_ROUNDS * AOF_ITER

    def check(res):
        adv, dist, succ = res
        asr, moved = check_adv(tag, adv, data, succ, AOF_BUDGET)
        kept = dist < 1e9
        log(f"[{tag}] ASR {asr:.3f} ({int(succ.sum())}/{len(succ)}); max per-point move {moved:.4f}; "
            f"{int(kept.sum())} clouds kept an iterate, mean best {'L2' if targeted else 'Linf'} distance "
            f"{float(dist[kept].mean()) if bool(kept.any()) else float('nan'):.5f}")

    log(f"[{tag}] {fwd} PointNet forwards, {bwd} backwards")
    return counted_and_timed(tag, f"{'TAOF' if targeted else 'AOF'} {AOF_ROUNDS}x{AOF_ITER}",
                             lambda d, t, generator=None: run(d, t, truth, generator=generator), data, target,
                             {"chain_fwd": 2 * fwd, "chain_bwd": 2 * bwd, "knn": 1}, check)


def run_si_ifgm(tag, fn, data, target, refresh):
    """SI iFGM at the si_ifgm cell's settings, counted and timed: a forward
    and a backward a step, one forward at the end, a kNN at each refresh."""
    run = si_ifgm_attack(fn, refresh)

    def check(res):
        adv, _, succ = res
        asr, moved = check_adv(tag, adv, data, succ, SI_EPS)
        log(f"[{tag}] ASR {asr:.3f} ({int(succ.sum())}/{len(succ)}); max per-point move {moved:.4f}")

    return counted_and_timed(tag, f"SI iFGM {SI_STEPS} steps, normal_refresh {refresh},",
                             lambda d, t, generator=None: run(d, t), data, target,
                             {"chain_fwd": 2 * (SI_STEPS + 1), "chain_bwd": 2 * SI_STEPS,
                              "knn": -(-SI_STEPS // refresh)}, check)


def run_query(tag, family, fn, data, target, reps=3, max_queries=SIMBA_QUERIES, per_fwd=None, per_bwd=None):
    """A query family counted (its launches held to the loop iterations it
    ran: the loop reads its stop flag once every ``QUERY_CHUNK``
    iterations) and timed; returns the counted run's launch counts and its
    queries per cloud.  ``per_fwd`` and ``per_bwd``: the launches of one forward and one
    backward of ``fn`` (PointNet's by default: the chain's 2 each)."""
    import torch

    from pointcloudattack_tpu_torch.attacks.siadv import QUERY_CHUNK

    attack = query_attack(family, fn, max_queries)
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
    fwd, bwd, knn = QUERY_LAUNCHES[family]
    forwards = fwd + 2 * res.iterations
    expect = {}
    for k, v in (per_fwd or {"chain_fwd": 2}).items():
        expect[k] = expect.get(k, 0) + v * forwards
    for k, v in (per_bwd or {"chain_bwd": 2}).items():
        expect[k] = expect.get(k, 0) + v * bwd
    expect["knn"] = expect.get("knn", 0) + knn
    for k in CHAIN_BWD_STAGES:  # each chain backward launches both of its stages
        expect[k] = expect.get("chain_bwd", 0)
    want = {k: expect.get(k, 0) for k in launches}
    log(f"[{tag}] {family} B={b}: {res.iterations} loop iterations (stop flag read every {QUERY_CHUNK}; cap "
        f"{max_queries if family != 'si-query' else data.shape[1]}), {forwards} victim forwards, {bwd} "
        f"backward(s); kernel launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != expected {want}")
    asr, moved = check_adv(tag, res.adv, data, res.success, None)
    log(f"[{tag}] ASR {asr:.3f} ({int(res.success.sum())}/{b}); queries per cloud {res.queries.tolist()}, mean "
        f"{float(res.queries.float().mean()):.1f}; max per-point move {moved:.4f}")
    runs = [run(2 + i) for i in range(reps)]
    times = [t for _, t in runs]
    tmin, tmean = min(times), sum(times) / len(times)
    log(f"[{tag}] {family} B={b} N={data.shape[1]}: warm-up {t_warm:.4f} s; timed {[round(t, 6) for t in times]} "
        f"s/batch at {[r.iterations for r, _ in runs]} loop iterations; min {tmin:.6f} s ({b / tmin:.3f} clouds/s), "
        f"mean {tmean:.6f} s ({b / tmean:.3f} clouds/s)")
    return launches, res.queries


def projector_error(v, ref):
    """``||V V^T - R R^T||_F / sqrt(2m)`` per cloud, in float64."""
    import torch

    p, r = (torch.bmm(x.double(), x.double().transpose(1, 2)) for x in (v, ref.to(v.device)))
    return torch.sqrt(((p - r) ** 2).sum(dim=(1, 2)) / (2 * v.shape[-1]))


def phase_spectral(data):
    """The AOF basis on the card at the aof cell's shape: the Chebyshev
    solve and a dense ``eigh`` timed (CUDA events over the whole call, the
    Laplacian's kNN kernel included; ``eigh`` reads its status back), each
    one's projector error against a float64 dense ``eigh`` of the same
    Laplacian and the CPU's Chebyshev basis beside them.  Held: the card's
    Chebyshev basis orthonormal within 1e-4 and its projector error at most
    twice the CPU's."""
    import torch

    from pointcloudattack_tpu_torch.geometry import spectral

    m = AOF_LOW_PASS
    lap, _ = spectral.laplacian_matrix(data, AOF_K)
    w64, ref = torch.linalg.eigh(lap.double())
    gap, ref = (w64[:, m] / w64[:, m - 1]).tolist(), ref[..., :m]
    ms = {name: time_ms(fn, reps=3, warmup=1) for name, fn in (
        ("laplacian", lambda: spectral.laplacian_matrix(data, AOF_K)),
        ("chebyshev", lambda: spectral.lowpass_basis(data, k=AOF_K, m=m, method="chebyshev")),
        ("dense", lambda: spectral.lowpass_basis(data, k=AOF_K, m=m, method="dense")))}
    v = {"chebyshev": spectral.lowpass_basis(data, k=AOF_K, m=m, method="chebyshev")[1],
         "dense": spectral.lowpass_basis(data, k=AOF_K, m=m, method="dense")[1]}
    t0 = time.perf_counter()
    v["cpu chebyshev"] = spectral.lowpass_basis(data.cpu(), k=AOF_K, m=m, method="chebyshev")[1]
    cpu_s = time.perf_counter() - t0
    err = {k: projector_error(x, ref).cpu() for k, x in v.items()}
    lfc_ref = torch.bmm(ref, torch.bmm(ref.transpose(1, 2), data.double())).cpu()
    lfc_err = {k: float((spectral.lowpass_split(data.to(x.device), x)[0].double().cpu() - lfc_ref).abs().max())
               for k, x in v.items()}
    card_cpu = projector_error(v["chebyshev"].cpu(), v["cpu chebyshev"])
    ortho = float((torch.bmm(v["chebyshev"].transpose(1, 2), v["chebyshev"]) - torch.eye(m, device="cuda")).abs().max())
    log(f"[spectral] B={data.shape[0]} N={data.shape[1]} m={m} k={AOF_K}: lambda_(m+1)/lambda_m per cloud "
        f"{[round(g, 5) for g in gap]}; the card's Laplacian {ms['laplacian']:.4f} ms, Chebyshev basis "
        f"{ms['chebyshev']:.4f} ms, dense eigh basis {ms['dense']:.4f} ms (dense / Chebyshev "
        f"{ms['dense'] / ms['chebyshev']:.3f}); the CPU's Chebyshev {cpu_s * 1e3:.1f} ms")
    for k in v:
        log(f"[spectral] {k}: projector error against float64 dense per cloud "
            f"{[float(f'{e:.3g}') for e in err[k]]}, max {float(err[k].max()):.3e}; lfc max |error| {lfc_err[k]:.3e}")
    log(f"[spectral] the card's Chebyshev basis against the CPU's: projector difference per cloud "
        f"{[float(f'{e:.3g}') for e in card_cpu]}; max |V^T V - I| {ortho:.3e}")
    if ortho > 1e-4 or bool((err["chebyshev"] > 2 * err["cpu chebyshev"]).any()):
        raise AssertionError("[spectral] the card's Chebyshev basis is not orthonormal, or further from the "
                             "float64 dense one than twice the CPU's")
    return ms


def step_partings(card, cpu, g_card, g_cpu, rounds, iters):
    """Where two runs of an attack whose rounds restart part.  ``card`` and
    ``cpu`` ``[rounds * (iters + 1), b, ...]`` hold each evaluation's victim
    input(s) (a round's steps, then its last iterate), ``g_card`` and
    ``g_cpu`` ``[rounds * iters, b, N, 3]`` each step's gradient.  A cloud
    parts at the first evaluation whose inputs lie further apart than
    PART_ATOL; the parting is explained when, at an earlier step of its
    round, a coordinate's two gradients had opposite signs (or 0 on one
    side only: Adam's step is about lr whatever the gradient's size) or lay
    further apart than SWITCH of the cloud's largest |gradient|, and it is
    not the round's first evaluation.  Returns (``held [b]``: never parted,
    a line per parted cloud, whether every parting is explained)."""
    apart = (card - cpu).abs().flatten(2).amax(-1) > PART_ATOL  # [E, b]
    held = ~apart.any(0)
    lines, ok = [], True
    for c in (~held).nonzero().flatten().tolist():
        e = int(apart[:, c].int().argmax())
        r, i = divmod(e, iters + 1)
        why = []
        for q in range(r * iters, r * iters + i):
            gc, gp = g_card[q][c], g_cpu[q][c]
            opp = int(((gc * gp < 0) | ((gc == 0) != (gp == 0))).sum())
            far = float((gc - gp).abs().max() / gc.abs().max().clamp_min(1e-30))
            if opp or far > SWITCH:
                why.append((q - r * iters, opp, float(f"{far:.3g}")))
        ok &= i > 0 and bool(why)
        lines.append(f"cloud {c} parted in round {r} at step {i}; before it (step, coordinates of opposite signs, "
                     f"largest difference over the cloud's largest |gradient|): {why[:4]}")
    return held, lines, ok


def input_recorder(fn, calls, grads):
    """``fn`` that records each call's input and the gradient of each
    differentiated input, that use's own (a step that calls ``fn`` twice
    on one leaf records two)."""
    def run(a):
        calls.append(a.detach().cpu())
        if a.requires_grad:
            a = a.view_as(a)  # this use's gradient, not its leaf's sum
            a.register_hook(lambda g: grads.append(g.detach().cpu()))
        return fn(a)
    return run


def basis_hooks():
    """``replay`` hooks for AOF's basis ("basis"): at the cut the 100th and
    101st eigenvalues nearly coincide, so f32 fixes the basis only up to a
    rotation there, and the card's and the CPU's differ.  ``off`` is, per
    cloud, the projector difference of the CPU's own basis from the card's."""
    from pointcloudattack_tpu_torch.geometry import spectral

    def card(orig, pc, **kw):
        res = orig(pc, **kw)
        return res, res

    def cpu(orig, res, pc, **kw):
        return res, None, projector_error(orig(pc, **kw)[1], res[1]).float()

    return {"basis": (spectral, "lowpass_basis", card, cpu)}


def siadv_hooks(family):
    """``replay`` hooks for the SIadv families' choices: the normals
    (``normal_hooks``), SimBA's order ("order"), SimBA++'s draws ("draws")
    and SI-query's ranking ("rank", ``off`` the positions where the CPU's
    own order differs)."""
    import torch

    from pointcloudattack_tpu_torch.attacks import siadv

    def card(orig, *args, **kw):
        res = orig(*args, **kw)
        return res, res

    def take(orig, res, x, *args, **kw):
        return res, None, torch.zeros(x.shape[0])

    def rank(orig, res, rankings):
        return res, None, (orig(rankings) != res).float()

    hooks = {"siadv": normal_hooks(siadv), "simba": {"order": (siadv, "simba_order", card, take)},
             "simbapp": {"draws": (siadv, "simbapp_draws", card, take)},
             "si-query": {**normal_hooks(siadv), "rank": (siadv, "rank_order", card, rank)}}
    return hooks[family]


def phase_parity_aof(fn, state, data, target, truth=None, tag="parity-aof"):
    """AOF (TAOF with ``truth``; B=4, 2 x 10) on the card and on the CPU from
    the same weights and noise, the CPU taking the card's basis
    (``basis_hooks``), each side's victim inputs and gradients recorded.
    Held: every parting explained (``step_partings``), some cloud never
    parting, and on those ``success`` identical, ``best_dist`` rtol 1e-4
    and the clouds within 1e-5."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b, rounds, iters = 4, 2, 10
    noise = torch.from_numpy(np.random.RandomState(7).randn(rounds, b, N, 3).astype(np.float32))
    cpu_fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state, "cpu")
    rec = {side: ([], []) for side in ("card", "cpu")}
    out = {}
    with replay(basis_hooks()) as taken:
        for side, f, dev in (("card", fn, "cuda"), ("cpu", cpu_fn, "cpu")):
            out[side] = aof_attack(input_recorder(f, *rec[side]), truth is not None, rounds, iters)(
                data[:b].to(dev), target[:b].to(dev), None if truth is None else truth[:b].to(dev),
                init_noise=noise.to(dev))
    evals = rounds * (iters + 1)
    its, grads = {}, {}
    for side, (calls, gs) in rec.items():
        if len(calls) != 2 * evals + 1 or len(gs) != 2 * rounds * iters:
            raise AssertionError(f"{tag}: recorded {len(calls)} victim calls and {len(gs)} gradients on the {side}")
        its[side] = torch.stack([torch.stack(calls[2 * e:2 * e + 2], dim=1) for e in range(evals)])
        grads[side] = [gs[2 * q] + gs[2 * q + 1] for q in range(rounds * iters)]
    held, lines, ok = step_partings(its["card"], its["cpu"], grads["card"], grads["cpu"], rounds, iters)
    (adv_g, dist_g, succ_g), (adv_c, dist_c, succ_c) = ((t.cpu() for t in out[s]) for s in ("card", "cpu"))
    log(f"[{tag}] card vs CPU, PointNet B={b}, {rounds}x{iters}, the CPU taking the card's {choice_line(taken)}: "
        f"success card {succ_g.tolist()} cpu {succ_c.tolist()}; best_dist card {dist_g.tolist()} cpu "
        f"{dist_c.tolist()}; clouds never parted {held.tolist()}; adv max |diff| per cloud "
        f"{[float(f'{v:.3g}') for v in (adv_g - adv_c).abs().flatten(1).amax(1)]}" + "".join(f"; {w}" for w in lines))
    if not ok or not bool(held.any()):
        raise AssertionError(f"{tag}: a parting nothing explains, or every cloud parted")
    if not torch.equal(succ_g[held], succ_c[held]):
        raise AssertionError(f"{tag}: success differs between the card and the CPU")
    torch.testing.assert_close(dist_g[held], dist_c[held], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(adv_g[held], adv_c[held], rtol=0.0, atol=PART_ATOL)


def phase_parity_si_ifgm(fn, state, data, target, tag="parity-si-ifgm"):
    """SI iFGM (B=4, 10 steps) on the card and on the CPU, the CPU taking
    the card's normals; held as ``phase_parity_aof`` (one round), and
    ``pred`` identical on the clouds that never parted."""
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    b, steps = 4, 10
    cpu_fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state, "cpu")
    rec = {side: ([], []) for side in ("card", "cpu")}
    out = {}
    with replay(siadv_hooks("siadv")) as taken:
        for side, f, dev in (("card", fn, "cuda"), ("cpu", cpu_fn, "cpu")):
            out[side] = si_ifgm_attack(input_recorder(f, *rec[side]), 1, steps)(data[:b].to(dev), target[:b].to(dev))
    for side, (calls, gs) in rec.items():
        if len(calls) != steps + 1 or len(gs) != steps:
            raise AssertionError(f"{tag}: recorded {len(calls)} victim calls and {len(gs)} gradients on the {side}")
    held, lines, ok = step_partings(torch.stack(rec["card"][0]), torch.stack(rec["cpu"][0]), rec["card"][1],
                                    rec["cpu"][1], 1, steps)
    (adv_g, pred_g, succ_g), (adv_c, pred_c, succ_c) = ((t.cpu() for t in out[s]) for s in ("card", "cpu"))
    log(f"[{tag}] card vs CPU, PointNet B={b}, {steps} steps, the CPU taking the card's {choice_line(taken)}: "
        f"pred card {pred_g.tolist()} cpu {pred_c.tolist()}; success card {succ_g.tolist()} cpu {succ_c.tolist()}; "
        f"clouds never parted {held.tolist()}; adv max |diff| per cloud "
        f"{[float(f'{v:.3g}') for v in (adv_g - adv_c).abs().flatten(1).amax(1)]}" + "".join(f"; {w}" for w in lines))
    if not ok or not bool(held.any()):
        raise AssertionError(f"{tag}: a parting nothing explains, or every cloud parted")
    if not (torch.equal(succ_g[held], succ_c[held]) and torch.equal(pred_g[held], pred_c[held])):
        raise AssertionError(f"{tag}: pred or success differs between the card and the CPU")
    torch.testing.assert_close(adv_g[held], adv_c[held], rtol=0.0, atol=PART_ATOL)


def phase_parity_query(family, fn, state, data, target, b, max_queries, tag, cpu_fn=None, hooks=None):
    """A query family on the card and on the CPU from the same weights, the
    CPU taking the card's choices (``siadv_hooks``, and ``hooks`` when
    given): ``pred``, ``success`` and the queries identical, the clouds
    within PART_ATOL.  ``cpu_fn``: the CPU's victim (by default PointNet on
    ``state``)."""
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    if cpu_fn is None:
        cpu_fn = make_model_fn(models.make_model("PointNet", NUM_CLASSES), state, "cpu")
    gen = torch.Generator(device="cuda").manual_seed(3)
    with replay({**siadv_hooks(family), **(hooks or {})}) as taken:
        card = query_attack(family, fn, max_queries)(data[:b], target[:b], generator=gen)
        cpu = query_attack(family, cpu_fn, max_queries)(data[:b].cpu(), target[:b].cpu())
    diff = (card.adv.cpu() - cpu.adv).abs().flatten(1).amax(1)
    log(f"[{tag}] card vs CPU, {family} on PointNet B={b}, cap {max_queries}, the CPU taking the card's "
        f"{choice_line(taken)}: iterations card {card.iterations} cpu {cpu.iterations}; queries card "
        f"{card.queries.tolist()} cpu {cpu.queries.tolist()}; pred card {card.pred.tolist()} cpu {cpu.pred.tolist()}; "
        f"success card {card.success.tolist()} cpu {cpu.success.tolist()}; adv max |diff| per cloud "
        f"{[float(f'{v:.3g}') for v in diff]}")
    for name in ("queries", "pred", "success"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"{tag}: {name} differs between the card and the CPU")
    if float(diff.max()) > PART_ATOL:
        raise AssertionError(f"{tag}: the adversarial clouds differ by more than {PART_ATOL}")


def config5_path():
    """BASELINE config 5 on PointNet: the spectral basis on the card, row 9
    at the new kNN shapes, then AOF and TAOF (the aof cell), SI iFGM at
    normal_refresh 1 and 5 (si_ifgm, si_ifgm_r5), SI-query (si_query),
    SimBA and SimBA++: each counted and timed, card against CPU, and the
    profiles of AOF and iFGM.  Returns the launch counts of each path and
    row 9's records at the new shapes."""
    aof_data, aof_labels = synthetic_data(8, 1, AOF_DATA, "cuda")
    si_data, si_labels = synthetic_data(8, 8, SI_DATA, "cuda")
    siq_data, siq_labels = synthetic_data(8, 4, SIQ_DATA, "cuda")
    with phase_clock("spectral"):
        phase_spectral(aof_data)
    with phase_clock("kernels-knn (config 5)"):
        knn = {f"aof graph {tuple(aof_data.shape)} k={AOF_K}": time_knn("kernels-knn", "AOF's graph", aof_data, AOF_K),
               **{f"siadv normals {tuple(x.shape)} k={SI_K + 1}": time_knn("kernels-knn", "SIadv's normals", x,
                                                                          SI_K + 1) for x in (si_data, siq_data)}}
    launches = {}
    aof_fn, aof_state = make_victim("PointNet", "cuda", aof_data, ("dropout",))
    aof_target = victim_labels(aof_fn, aof_data, aof_labels, "slice-aof")
    with phase_clock("slice-aof"):
        launches["aof"] = run_aof("slice-aof", aof_fn, aof_data, aof_target)
    with phase_clock("slice-taof"):
        launches["taof"] = run_aof("slice-taof", aof_fn, aof_data, (aof_target + 1) % NUM_CLASSES, aof_target)
    with phase_clock("parity-aof"):
        phase_parity_aof(aof_fn, aof_state, aof_data, aof_target)
        phase_parity_aof(aof_fn, aof_state, aof_data, (aof_target + 1) % NUM_CLASSES, aof_target, "parity-taof")
    with phase_clock("profile-aof"):
        phase_profile("profile-aof", aof_fn, aof_data, aof_target, aof_attack(aof_fn, False, 1, 10), "AOF 1x10")
    si_fn, si_state = make_victim("PointNet", "cuda", si_data, ("dropout",))
    si_target = victim_labels(si_fn, si_data, si_labels, "slice-si-ifgm")
    with phase_clock("slice-si-ifgm"):
        launches["si_ifgm"] = run_si_ifgm("slice-si-ifgm", si_fn, si_data, si_target, 1)
        launches["si_ifgm_r5"] = run_si_ifgm("slice-si-ifgm-r5", si_fn, si_data, si_target, 5)
    with phase_clock("parity-si-ifgm"):
        phase_parity_si_ifgm(si_fn, si_state, si_data, si_target)
    with phase_clock("profile-si-ifgm"):
        phase_profile("profile-si-ifgm", si_fn, si_data, si_target, si_ifgm_attack(si_fn, 1, 10), "SI iFGM 10 steps")
    siq_fn, siq_state = make_victim("PointNet", "cuda", siq_data, ("dropout",))
    siq_target = victim_labels(siq_fn, siq_data, siq_labels, "slice-si-query")
    with phase_clock("slice-si-query"):
        launches["si_query"], _ = run_query("slice-si-query", "si-query", siq_fn, siq_data, siq_target)
    with phase_clock("slice-simba"):
        launches["simba"], _ = run_query("slice-simba", "simba", siq_fn, siq_data[:SIMBA_B], siq_target[:SIMBA_B])
    with phase_clock("slice-simbapp"):
        launches["simbapp"], _ = run_query("slice-simbapp", "simbapp", siq_fn, siq_data[:SIMBA_B],
                                           siq_target[:SIMBA_B])
    with phase_clock("parity-query"):
        phase_parity_query("si-query", siq_fn, siq_state, siq_data, siq_target, 2, N, "parity-si-query")
        phase_parity_query("simba", siq_fn, siq_state, siq_data, siq_target, 4, 200, "parity-simba")
        phase_parity_query("simbapp", siq_fn, siq_state, siq_data, siq_target, 4, 200, "parity-simbapp")
    return launches, knn


# The defenses (--defense sor|srs|dupnet, attacks/evaluation.py::with_defense) on PointNet.  DUP-Net behind bench.py's
# si_query cell (make_synthetic_clouds(8, 4, 1024, seed=14), B=32, eps 0.18, step 0.32), PU-Net at its published widths
# (npoint = N = 1024, up_ratio 4, set abstractions 3-32-32-64 ... 259-256-256-512 over K=32) on weights drawn from
# DUP_SEED; C&W through DUP-Net on the first DUP_CW_B of those clouds, 1 x DUP_CW_ITER (cut from 1 x 200); C&W behind
# SOR and SRS on the headline's clouds (B=64), 1 x DEF_ITER (cut from 1 x 200).  SRS's draw is seeded with DEF_KEY, as
# the CLI's with --seed 0.
DUP_UP, DUP_SEED, DUP_CW_B, DUP_CW_ITER, DEF_ITER, DEF_KEY = 4, 21, 16, 20, 100, 7
# the launches of one DUP-Net + PointNet forward (SOR's kNN, PU-Net's four FPS and four group chains, the victim's two
# chains) and of its backward (the four group chains', the victim's two)
DUP_FWD = {"knn": 1, "fps": 4, "group_max_fwd": 4, "chain_fwd": 2}
DUP_BWD = {"group_max_bwd": 4, "chain_bwd": 2}
DEF_FWD = {"sor": {"knn": 1, "chain_fwd": 2}, "srs": {"chain_fwd": 2}}
DUP_PARITY_B = 2  # clouds of the card-against-CPU readings through DUP-Net (the CPU runs PU-Net's plain chains)
DUP_PARITY_QUERIES = 32  # SI-query's parity takes clouds the card's run flipped in fewer queries than this
# SI-query through DUP-Net: the counted run (also the warm-up), then DUP_SIQ_REPS fenced timed runs, cut from 3: 4 of
# the 32 clouds never flip behind the seeded upsampler, so every run goes all N = 1024 loop iterations (about 50 s)
DUP_SIQ_REPS = 1


def short_runs(queries, below):
    """The clouds whose ``queries`` lie under ``below``, most queries first
    (ties to the lower index)."""
    import torch

    q = queries.cpu().long()
    cand = (q < below).nonzero().flatten()
    return cand[torch.sort(-q[cand], stable=True).indices].tolist()


def punet_state(seed=DUP_SEED):
    """A PU-Net state dict at the published widths (npoint N, up_ratio
    DUP_UP), its weights drawn from ``seed`` (PyTorch's default draw)."""
    import torch

    from pointcloudattack_tpu_torch.models.punet import PUNet

    model = PUNet(npoint=N, up_ratio=DUP_UP)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def defended(fn, defense, pu_state=None):
    """``fn`` behind ``defense`` as the CLI puts it there (``with_defense``,
    SRS's key DEF_KEY, DUP-Net to N points on ``pu_state``); ``fn`` the
    identity gives the defended clouds."""
    from pointcloudattack_tpu_torch.attacks.evaluation import with_defense

    return with_defense(fn, defense, key=DEF_KEY, npoint=N, dup_variables=pu_state)


def defended_victim(defense, data, labels, tag, pu_state=None):
    """PointNet behind ``defense``, its BatchNorm statistics taken from the
    defended clouds (``make_victim``): ``(model_fn, defended model_fn,
    state, target)``, the target its clean predictions through the
    defense."""
    import torch

    with torch.no_grad():
        clouds = defended(lambda x: x, defense, pu_state)(data)
    fn, state = make_victim("PointNet", "cuda", clouds, ("dropout",))
    dfn = defended(fn, defense, pu_state)
    return fn, dfn, state, victim_labels(dfn, data, labels, tag)


def phase_kernels_punet(data, pu_state):
    """Row 2's multi-layer chain + max at PU-Net's four set abstractions and
    FPS at its four samplings, on the rows and clouds of one DUP-Net forward
    over ``data`` (SI-query's B=32): the forward and the max backward held
    to their plain versions (``check_group``: y within Y_TOL, the argmax
    equal but at near ties, dx within DX_TOL, two backwards bit-equal),
    FPS bit for bit (npoint = N at the first), each timed beside its plain
    version, its device time and its bound; the tile ``_pick_tm`` takes for
    the widest backward; SOR's kNN (row 9, k=3) as phase 11 holds it; and
    the peak memory of one forward.  Returns the records of rows 2, 10 and
    9 at these shapes."""
    import ctypes

    import numpy as np
    import torch

    from pointcloudattack_tpu_torch.models import punet
    from pointcloudattack_tpu_torch.ops import _build
    from pointcloudattack_tpu_torch.ops import fps as fps_mod
    from pointcloudattack_tpu_torch.ops import group_chain as gch
    from pointcloudattack_tpu_torch.ops import grouping

    dup = defended(lambda x: x, "dupnet", pu_state)
    with torch.no_grad():
        dup(data[:1])  # PU-Net onto the card
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with op_trace(((punet, "mlp_chain_groupmax"), (grouping, "farthest_point_sample")), inputs=True) as rec:
            up = dup(data)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    if tuple(up.shape) != (data.shape[0], DUP_UP * N, 3) or not bool(torch.isfinite(up).all()):
        raise AssertionError(f"[kernels-punet] DUP-Net gave {tuple(up.shape)}, finite {bool(torch.isfinite(up).all())}")
    log(f"[kernels-punet] one DUP-Net forward over {tuple(data.shape)} -> {tuple(up.shape)}: peak memory "
        f"{peak:.1f} MiB above the {base / 2**20:.1f} MiB held before it")
    out = {"group_max_fwd": {}, "group_max_bwd": {}, "fps": {}, "peak_mib": peak}
    lib = _build.load_library()
    groups = [args for name, args in rec if name == "punet.mlp_chain_groupmax"]
    samplings = [args for name, args in rec if name == "grouping.farthest_point_sample"]
    for i, (x, layers) in enumerate(groups):
        b, ng, k, c0 = x.shape
        dims = [c0] + [layer[0].shape[1] for layer in layers]
        name = f"sa{i} {tuple(x.shape)} -> {dims[1:]}"
        dy = torch.from_numpy(np.random.RandomState(120 + i).randn(b, ng, dims[-1]).astype(np.float32)).cuda()
        errs, am, g, carry = check_group(f"sa{i}", "max", x, layers, dy, slope=0.0, tag="kernels-punet")
        ms, b_fwd, b_bwd = time_group(f"sa{i}", "max", x, layers, am, g, carry, slope=0.0, tag="kernels-punet")
        arr = (ctypes.c_int * len(dims))(*dims)
        tiles = {d: gch._pick_tm(lib, arr, len(layers), k, d == "bwd") for d in ("fwd", "bwd")}
        smem = {d: lib.pca_group_smem(len(layers), ctypes.cast(arr, ctypes.c_void_p), k, tiles[d], int(d == "bwd"))
                for d in tiles}
        log(f"[kernels-punet] sa{i} chain {dims} K={k}: _pick_tm takes TM={tiles['fwd']} forward ({smem['fwd']} B of "
            f"shared memory a block), TM={tiles['bwd']} backward ({smem['bwd']} B of the "
            f"{lib.pca_chain_max_smem()} a block may hold)")
        for key, d, err, bnd, rows in (("group_max_fwd", "fwd", errs["y"], b_fwd, b * ng * k),
                                       ("group_max_bwd", "bwd", errs["dx"], b_bwd, carry)):
            out[key][f"punet {name}"] = {
                "ms": ms[d], "plain_ms": ms[f"{d}_plain"], "device_ms": sum(ms[f"{d}_device"].values()) or None,
                "bound_ms": bnd[0], "bound_by": bnd[1], "bound_rows": rows, "max_abs_err": err, "tm": tiles[d]}
    if len(groups) != 4 or len(samplings) != 4:
        raise AssertionError(f"[kernels-punet] one forward ran {len(groups)} group chains and {len(samplings)} FPS, "
                             "not 4 and 4")
    for i, (xyz, npoint) in enumerate(samplings):
        b, n, _ = xyz.shape
        err = check_fps("kernels-punet", f"sa{i}", xyz, npoint)
        zero = torch.zeros(b, dtype=torch.int32, device=xyz.device)
        ms = time_pairs({"plain": lambda: fps_mod.fps_plain(xyz, npoint, zero),
                         "kernel": lambda: fps_mod.farthest_point_sample(xyz, npoint)}, reps=3)
        dev = sum(v for kn, v in device_ms(lambda: fps_mod.farthest_point_sample(xyz, npoint)).items()
                  if kn.startswith("fps_kernel")) or None
        t, by = fps_bound(b, n, npoint)
        out["fps"][f"punet sa{i} [{b},{n},3] -> {npoint}"] = {
            "ms": ms["kernel"], "plain_ms": ms["plain"], "device_ms": dev, "bound_ms": t, "bound_by": by,
            "max_abs_err": err}
        log(f"[kernels-punet] fps sa{i} [{b},{n},3] -> {npoint}: kernel {ms['kernel']:.4f} ms, device "
            f"{'not measured' if dev is None else f'{dev:.4f} ms'}, plain {ms['plain']:.4f} ms, bound {t:.5f} by {by}")
    out["knn"] = {f"sor neighbours {tuple(data.shape)} k=3": time_knn("kernels-punet", "SOR's neighbours", data, 3)}
    torch.cuda.empty_cache()
    return out


def dupnet_hooks():
    """``replay`` hooks for the defenses' choices: SOR's keep mask ("sor",
    ``defense/sor.py::sor_keep``: a value within rounding of the threshold
    may fall on either side; ``gap`` each value's distance to the CPU's
    threshold) and its neighbours ("sor_knn", ``knn_hooks``), SRS's draw
    ("srs", ``srs_draw``: the CPU's generator draws other numbers; ``off``
    0), and PU-Net's: the FPS picks ("fps") and ball slots ("slots") of its
    set abstractions (bit-equal by design: ``off`` 1 for each cloud where
    the CPU's own differ), each group chain's max picks and hidden signs
    ("punet_group": the picks from the op's own forward run again, which
    must give its bits, the signs from ``hidden_sides``; the CPU runs the
    chain in plain differentiable ops on them, as ``pick_hooks``' chain
    hooks do), the 3-NN picks of its feature propagations ("nn3": ``gap``
    the 4th nearest's distance over the 3rd's, ``off`` the taken distances'
    largest difference from the CPU's own) and the signs of every ReLU's
    input ("punet_relu")."""
    import torch

    from pointcloudattack_tpu_torch.defense import sor, srs
    from pointcloudattack_tpu_torch.models import punet
    from pointcloudattack_tpu_torch.ops import group_chain as gch
    from pointcloudattack_tpu_torch.ops import grouping
    from pointcloudattack_tpu_torch.ops import interpolate as interp
    from pointcloudattack_tpu_torch.ops.pairwise import pairwise_sqdist

    def same(orig, *args, **kw):
        out = orig(*args, **kw)
        return out, out

    def keep_cpu(orig, keep, value, alpha):
        thr = value.mean(dim=-1, keepdim=True) + alpha * value.std(dim=-1, keepdim=True, unbiased=True)
        gap = (value - thr).abs()
        return keep, gap, torch.where(keep != (value <= thr), gap, 0.0)

    def draw_cpu(orig, idx, pc, keep, generator=None):
        return idx, None, torch.zeros(pc.shape[0])

    def fps_cpu(orig, idx, xyz, npoint, start=None):
        return idx, None, (orig(xyz, npoint, start) != idx).any(-1, keepdim=True).float()

    def slots_cpu(orig, idx, radius, nsample, xyz, new_xyz, sqr=None):
        own = orig(radius, nsample, xyz, new_xyz, sqr)
        return idx, None, (own != idx).flatten(1).any(1, keepdim=True).float()

    def group_card(orig, x, layers, slope=0.0):
        y = orig(x, layers, slope)
        with torch.no_grad():
            det = [tuple(t.detach().contiguous() for t in layer) for layer in layers]
            y2, am = gch.chain_groupmax_fwd(x.detach().contiguous(), det, slope)
            if not torch.equal(y2, y.detach()):
                raise AssertionError(f"PU-Net's group chain gave other bits the second time in "
                                     f"{int((y2 != y.detach()).sum())} of {y.numel()} outputs")
            _, sides = hidden_sides(x, det, slope)
        return y, (am, *sides)

    def group_cpu(orig, choice, x, layers, slope=0.0):
        pick, *sides = choice
        z, gaps, offs = signed_chain(x.float(), layers, slope, sides)
        (y, _), gap, off = pool_at(z, pick, 2)
        b = z.shape[0]
        return y, torch.cat([gap.reshape(b, -1), *gaps], 1), torch.cat([off.reshape(b, -1), *offs], 1)

    def nn_card(orig, dst, src):
        d, idx = orig(dst, src)
        return (d, idx), idx

    def nn_cpu(orig, idx, dst, src):
        dall = pairwise_sqdist(dst, src)
        d = dall.gather(-1, idx.long())
        own = torch.sort(dall.detach(), dim=-1, stable=True).values
        gap = own[..., 3] - own[..., 2] if own.shape[-1] > 3 else own[..., 0].abs() + float("inf")
        return (d, idx), gap, (d.detach() - own[..., :3]).abs().amax(-1)

    def sign_card(orig, x):
        return orig(x), x.detach() > 0

    def sign_cpu(orig, pos, x):
        xd = x.detach()
        return torch.where(pos, x, 0.0 * x), xd.abs(), torch.where(pos != (xd > 0), xd.abs(), 0.0)

    return {"sor": (sor, "sor_keep", same, keep_cpu), "sor_knn": knn_hooks(sor)["knn"],
            "srs": (srs, "srs_draw", same, draw_cpu),
            "fps": (grouping, "farthest_point_sample", same, fps_cpu),
            "slots": (grouping, "query_ball_point", same, slots_cpu),
            "punet_group": (punet, "mlp_chain_groupmax", group_card, group_cpu),
            "nn3": (interp, "three_nn", nn_card, nn_cpu), "punet_relu": (punet, "relu", sign_card, sign_cpu)}


def victim_hooks():
    """``replay`` hooks for PointNet behind a defense: its chain's picks and
    hidden signs (``pick_hooks``' "chain"), its ReLUs' signs
    (``relu_hooks``) and the defenses' choices (``dupnet_hooks``)."""
    return {"chain": pick_hooks()["chain"], **relu_hooks(), **dupnet_hooks()}


def phase_parity_dupnet(fn, state, pu_state, data, target, sor_srs, short):
    """Card against CPU through the defenses, the CPU taking the card's
    choices (``victim_hooks``): DUP-Net's upsampled clouds within 1e-4 at
    B=4; SI-query through DUP-Net on the clouds ``short``
    (``phase_parity_query``: queries, ``pred`` and ``success`` identical,
    clouds within PART_ATOL); C&W's
    first-step gradient through DUP-Net, and through SOR and SRS on the
    headline's victim (``sor_srs``: defense -> (model_fn, state, data,
    target)), at two perturbed copies of the clean clouds (at the clean
    clouds the L2 term's gradient is 0 / 0), held by
    ``hold_grad_parity`` (1e-5 relative L2 at every (input, cloud) whose
    log-probs do not tie)."""
    import numpy as np
    import torch

    from pointcloudattack_tpu_torch import models
    from pointcloudattack_tpu_torch.utils.apply import make_model_fn

    def cpu_victim(st):
        return make_model_fn(models.make_model("PointNet", NUM_CLASSES), st, "cpu")

    b = 4
    with replay(dupnet_hooks()) as taken:
        up_card = defended(lambda x: x, "dupnet", pu_state)(data[:b])
        up_cpu = defended(lambda x: x, "dupnet", pu_state)(data[:b].cpu())
    diff = (up_card.cpu() - up_cpu).abs().flatten(1).amax(1)
    log(f"[parity-dupnet] DUP-Net's upsampled clouds {tuple(up_card.shape)}, card vs CPU: max |diff| per cloud "
        f"{[float(f'{v:.3g}') for v in diff]} (bound 1e-4), the CPU taking the card's {choice_line(taken)}")
    if float(diff.max()) > 1e-4:
        raise AssertionError(f"[parity-dupnet] the upsampled clouds differ by {float(diff.max()):.3e} > 1e-4")
    cpu_dfn = defended(cpu_victim(state), "dupnet", pu_state)
    if not short:
        raise AssertionError(f"[parity-dupnet] no cloud flipped in fewer than {DUP_PARITY_QUERIES} queries")
    log(f"[parity-dupnet] SI-query on clouds {short}, which the card's counted run flipped in fewer than "
        f"{DUP_PARITY_QUERIES} queries")
    phase_parity_query("si-query", fn, state, data[short], target[short], len(short), N, "parity-dupnet-si-query",
                       cpu_fn=cpu_dfn, hooks=victim_hooks())
    rng = np.random.RandomState(17)
    for defense, (dfn, st, x, t) in {"dupnet": (fn, state, data, target), **sor_srs}.items():
        bb = DUP_PARITY_B if defense == "dupnet" else 4
        ori = x[:bb]
        advs = [ori + torch.from_numpy((rng.randn(*ori.shape) * 0.01).astype(np.float32)).cuda() for _ in range(2)]
        cpu_fn = defended(cpu_victim(st), defense, pu_state if defense == "dupnet" else None)
        hold_grad_parity(f"parity-{defense}", [grad_parity(dfn, cpu_fn, a, ori, t[:bb], hooks=victim_hooks())
                                               for a in advs])


def phase_cli_defense(pu_state):
    """The CLI on the card, one process each, all started together: SI-query
    behind DUP-Net on a PU-Net state dict written to a temporary file, C&W
    behind SOR and behind SRS, C&W with a transfer panel of PointNet and
    DGCNN, and DUP-Net without ``--defense_checkpoint``, which must exit
    non-zero with the JAX CLI's message.  Each other run must exit 0 with
    its ASR line and summary (the transfer ASR of both members in it)."""
    import tempfile

    import torch

    common = ["--model", "PointNet", "--num_points", str(N), "--num_classes", str(NUM_CLASSES), "--seed", "0"]
    runs = {"si-query dupnet": ["si-query", "--defense", "dupnet", "--budget", "0.18", "--step_size", "0.32",
                                "--num_samples", "8"],
            "cw sor": ["cw", "--defense", "sor", "--binary_step", "1", "--num_iter", "20", "--num_samples", "16"],
            "cw srs": ["cw", "--defense", "srs", "--binary_step", "1", "--num_iter", "20", "--num_samples", "16"],
            "cw transfer": ["cw", "--binary_step", "1", "--num_iter", "10", "--num_samples", "16", "--transfer_test",
                            "--trans_model", "PointNet,DGCNN"],
            "dupnet without a checkpoint": ["cw", "--defense", "dupnet", "--num_samples", "2"]}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "punet.pth")
        torch.save(pu_state, ckpt)
        runs["si-query dupnet"] += ["--defense_checkpoint", ckpt]
        procs = {}
        try:
            for i, (name, argv) in enumerate(runs.items()):
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "pointcloudattack_tpu_torch.cli", "attack", *argv, *common,
                     "--output_dir", str(Path(tmp) / str(i))], cwd=ROOT, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)
            done = {name: (p.communicate(timeout=600), p.returncode) for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (name, ((out, err), rc)) in enumerate(done.items()):
            family = runs[name][0]
            tail = " | ".join(line for line in out.strip().splitlines()[-4:])
            log(f"[cli-defense] {name}: exit {rc}; {tail or err.strip().splitlines()[-1:]}")
            if name == "dupnet without a checkpoint":
                if rc == 0 or "--defense dupnet requires --defense_checkpoint" not in err:
                    raise AssertionError(f"[cli-defense] {name}: exit {rc}, stderr {err[-400:]!r}")
                continue
            summary = Path(tmp) / str(i) / f"attack_{family}_summary.json"
            if rc != 0 or f"attack {family}: ASR" not in out or not summary.is_file():
                raise AssertionError(f"[cli-defense] {name}: exit {rc}, stdout {out[-400:]!r}, stderr {err[-800:]!r}")
            summ = json.loads(summary.read_text())
            if not summ["device"].startswith("cuda"):
                raise AssertionError(f"[cli-defense] {name} ran on {summ['device']}")
            if name == "cw transfer" and sorted(summ.get("transfer_asr", {})) != ["DGCNN", "PointNet"]:
                raise AssertionError(f"[cli-defense] {name}: transfer ASR {summ.get('transfer_asr')}")


def phase_profile_dupnet(dfn, data, target, queries):
    """torch.profiler over SI-query through DUP-Net, the whole attack at
    B=32: the normals, the white-box backward, the query loop's probes,
    acceptance updates and stop-flag reads, the last forward.  Its clouds
    are those the counted run flipped within one QUERY_CHUNK of loop
    iterations (fewer than DUP_PARITY_QUERIES queries), cycled to the
    batch, so that the loop stops at its first stop-flag read; a cloud that
    never flips would hold it for all N iterations."""
    import torch

    from pointcloudattack_tpu_torch.attacks.siadv import QUERY_CHUNK

    quick = short_runs(queries, DUP_PARITY_QUERIES)
    if not quick:
        raise AssertionError(f"[profile-dupnet] no cloud flipped in fewer than {DUP_PARITY_QUERIES} queries")
    pick = torch.tensor(quick, device=data.device)[torch.arange(data.shape[0], device=data.device) % len(quick)]
    attack, iters = query_attack("si-query", dfn, N), []

    def window(d, t):
        iters.append(attack(d, t).iterations)

    phase_profile("profile-dupnet", dfn, data[pick], target[pick], window,
                  f"SI-query through DUP-Net on the {len(quick)} clouds flipped within {QUERY_CHUNK} loop "
                  "iterations, cycled,")
    log(f"[profile-dupnet] the profiled run went {iters[-1]} loop iterations ({2 * iters[-1] + 3} DUP-Net forwards, "
        "1 backward)")


def dupnet_path():
    """The defenses on PointNet: row 2's multi-layer kernels and FPS at
    PU-Net's shapes, SI-query behind DUP-Net at the si_query cell (counted,
    timed, profiled), C&W through DUP-Net, C&W behind SOR and behind SRS,
    card against CPU through each, and the CLI's defense and transfer runs.
    Returns the launch counts of each path and the kernel records at
    PU-Net's shapes."""
    siq_data, siq_labels = synthetic_data(8, 4, SIQ_DATA, "cuda")
    pu_state = punet_state()
    with phase_clock("kernels-punet"):
        kp = phase_kernels_punet(siq_data, pu_state)
    launches = {}
    fn, dfn, state, target = defended_victim("dupnet", siq_data, siq_labels, "slice-dupnet", pu_state)
    with phase_clock("slice-dupnet"):
        launches["si_query_dupnet"], queries = run_query("slice-dupnet", "si-query", dfn, siq_data, target,
                                                         reps=DUP_SIQ_REPS, max_queries=N, per_fwd=DUP_FWD,
                                                         per_bwd=DUP_BWD)
    with phase_clock("profile-dupnet"):
        phase_profile_dupnet(dfn, siq_data, target, queries)
    with phase_clock("slice-cw-dupnet"):
        launches["cw_dupnet"] = run_attack("slice-cw-dupnet", dfn, siq_data[:DUP_CW_B], target[:DUP_CW_B],
                                           DUP_CW_ITER, DUP_FWD, DUP_BWD)
    clouds, labels = synthetic_data(NUM_CLASSES, 2, 0, "cuda")
    sor_srs = {}
    for defense in ("sor", "srs"):
        _, d_fn, d_state, d_target = defended_victim(defense, clouds[:B], labels[:B], f"slice-{defense}")
        with phase_clock(f"slice-{defense}"):
            launches[f"cw_{defense}"] = run_attack(f"slice-{defense}", d_fn, clouds[:B], d_target, DEF_ITER,
                                                   DEF_FWD[defense], {"chain_bwd": 2})
        sor_srs[defense] = (d_fn, d_state, clouds[:B], d_target)
    # SI-query card against CPU on the two clouds that took the most queries under DUP_PARITY_QUERIES on the card
    # (the CPU runs PU-Net's plain chains, and a cloud that never flips runs all N iterations)
    short = short_runs(queries, DUP_PARITY_QUERIES)[:DUP_PARITY_B]
    with phase_clock("parity-dupnet"):
        phase_parity_dupnet(dfn, state, pu_state, siq_data, target, sor_srs, short)
    with phase_clock("cli-defense"):
        phase_cli_defense(pu_state)
    return launches, kp


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
    pn2, sa3 = phase_kernels_pn2()
    with phase_clock("kernels-ballq"):
        ballq, ballq_shapes = phase_kernels_ballq()
    clouds, labels = synthetic_data(NUM_CLASSES, 2, 0, "cuda")
    model_fn, state = make_victim("PointNet", "cuda", clouds, ("dropout",))
    data = clouds[:B]
    target = victim_labels(model_fn, data, labels[:B])
    launches = phase_slice(model_fn, data, target)
    phase_parity(model_fn, state, data, target)
    phase_profile("profile", model_fn, data, target)

    ssg = pn2_path("PointNet++Ssg")
    first_step_spread("slice-ssg", ssg[0], ssg[2], ssg[3])
    msg = pn2_path("PointNet++Msg")
    first_step_spread("slice-msg", msg[0], msg[2], msg[3])
    attack_parity("parity-ssg", "PointNet++Ssg", ssg[0], ssg[1], ssg[2], ssg[3], 4, may_part=True)
    phase_parity_msg(*msg[:4])
    phase_profile("profile-ssg", ssg[0], ssg[2], ssg[3])
    phase_profile("profile-msg", msg[0], msg[2], msg[3])

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
        knn_first_steps("slice-knn", knn_fn, knn_data, knn_target)
    with phase_clock("parity-knn"):
        phase_parity_knn(knn_fn, knn_state, knn_data, knn_target)
    with phase_clock("slice-dgcnn"):
        dg_launches = run_attack("slice-dgcnn", dg_fn, dg_data, dg_target, DG_ITER, *DG_LAUNCHES)
        dgcnn_first_steps("slice-dgcnn", dg_fn, dg_data, dg_target)
    with phase_clock("slice-dgcnn-routes"):
        dgcnn_routes(dg_state, dg_data, dg_target, dg_fn)
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
        geoa3_first_steps("slice-geoa3", geo_fn, geo_data, geo_target)
    with phase_clock("parity-geoa3"):
        phase_parity_geoa3(geo_fn, geo_state, geo_data, geo_target)
    with phase_clock("profile-geoa3"):
        from pointcloudattack_tpu_torch.attacks.geoa3 import GeoA3Config, build_geoa3_attack

        phase_profile("profile-geoa3", geo_fn, geo_data, geo_target,
                      build_geoa3_attack(geo_fn, GeoA3Config(binary_max_steps=1, iter_max_steps=10)), "GeoA3 1x10")
    # the rest of GeoA3 on the same cell: the cached curvature set, the partial mode, the jitter
    with phase_clock("slice-geoa3-r4"):
        geo_r4 = run_geoa3("slice-geoa3-r4", geo_fn, geo_data, geo_target, {"chain_fwd": 2}, {"chain_bwd": 2},
                           refresh=GEO_REFRESH)
        geoa3_first_steps("slice-geoa3-r4", geo_fn, geo_data, geo_target, cached=True)
    with phase_clock("slice-geoa3-partial"):
        geo_partial = run_geoa3_partial("slice-geoa3-partial", geo_fn, geo_data, geo_target, {"chain_fwd": 2},
                                        {"chain_bwd": 2})
    with phase_clock("parity-geoa3-refresh"):
        phase_parity_geoa3(geo_fn, geo_state, geo_data, geo_target, "parity-geoa3-refresh",
                           curv_knn_refresh=GEO_REFRESH)
        phase_parity_geoa3(geo_fn, geo_state, geo_data, geo_target, "parity-geoa3-refresh-jitter",
                           curv_knn_refresh=GEO_REFRESH, use_jitter=True, jitter_refresh_iters=4)
    with phase_clock("profile-geoa3-r4"):
        phase_profile("profile-geoa3-r4", geo_fn, geo_data, geo_target,
                      build_geoa3_attack(geo_fn, GeoA3Config(binary_max_steps=1, iter_max_steps=10,
                                                             curv_knn_refresh=GEO_REFRESH)),
                      f"GeoA3 1x10 curv_knn_refresh {GEO_REFRESH}")
    # CurveNet (bench.py's cw_curvenet; GeoA3 on it, BASELINE config 4): its kernels, then its paths
    with phase_clock("kernels-curvenet"):
        cnk = phase_kernels_curvenet()
    with phase_clock("kernels-gather-curvenet"):
        cng = phase_kernels_gather_curvenet()
    cn_cw, cn_geo, cn_gather, cn_knn = curvenet_path()
    # AOF/TAOF and the SIadv family (BASELINE config 5) on PointNet
    c5, c5_knn = config5_path()
    # the defenses: SOR, SRS and DUP-Net (SOR, then PU-Net) in front of PointNet
    dn_launches, dn = dupnet_path()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pointcloudattack_tpu"))
    if loaded:
        raise AssertionError(f"the JAX side was imported: {loaded}")

    by_path = {"pointnet": {"chain_fwd": launches["fwd"], "chain_bwd": launches["bwd"]},
               "ssg": ssg[4], "msg": msg[4], "dgcnn": dg_launches, "knn": knn1, "knn_r5": knn5,
               "knn_ssg": knn_ssg, "geoa3": geo_launches, "geoa3_r4": geo_r4, "geoa3_partial": geo_partial,
               "curvenet": cn_cw, "geoa3_curvenet": cn_geo, "curvenet_gather": cn_gather, **c5, **dn_launches}

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
    gather_at = {"mean_fwd": cn_at["mean"] + ", gather route (pre_act, LeakyReLU 0.2)",
                 "mean_bwd": cn_at["mean"] + ", gather route (pre_act, LeakyReLU 0.2)"}

    spine = k["spine B=64"]
    chain_shapes = {**k, **sa3}

    def chain_extra(d):
        """Row 1's other shapes, its forward's FP32 bound beside the
        tensor-core one, and each kernel's device time under the profiler."""
        return {"bound_fp32_ms": spine["bound_fwd_fp32"][0] if d == "fwd" else None,
                "device_ms": spine[f"device_{d}"],
                "shapes": {label: {"ms": r[d], "plain_ms": r[f"{d}_plain"], "bound_ms": r[f"bound_{d}"][0],
                                   "bound_fp32_ms": r["bound_fwd_fp32"][0] if d == "fwd" else None,
                                   "device_ms": r[f"device_{d}"], "max_abs_err": r["err_y" if d == "fwd" else "err_dx"]}
                           for label, r in chain_shapes.items()}}

    record = {"kernels": [
        entry("chain_maxpool_fwd", "chain_fwd", KERNEL_SRC, TPU_FWD, launches["fwd"], spine["err_y"],
              spine["fwd"], spine["fwd_plain"], spine["bound_fwd"], "PointNet spine B=64 N=1024 3-64-128-1024",
              spine["rows_fwd"], **chain_extra("fwd")),
        entry("chain_maxpool_bwd", "chain_bwd", KERNEL_SRC, TPU_BWD, launches["bwd"], spine["err_dx"],
              spine["bwd"], spine["bwd_plain"], spine["bound_bwd"], "PointNet spine B=64 N=1024 3-64-128-1024",
              spine["rows_bwd"], **chain_extra("bwd")),
        entry("fps", "fps", FPS_SRC, TPU_FPS, ssg[4]["fps"], max(pn2["fps"]["err"], *(r["max_abs_err"] for r in
              dn["fps"].values())), pn2["fps"]["ms"], pn2["fps"]["plain_ms"], summed_bound(pn2["fps"]), ssg_at,
              device_ms=pn2["fps"]["device_ms"], shapes={**pn2["fps"]["shapes"], **dn["fps"]}),
        *(entry(f"gather_hoist_{key}", f"hoist_{key}", HOIST_SRC, TPU_GATHER_FWD if key.endswith("fwd") else
                TPU_GATHER_BWD, dg_launches[f"hoist_{key}"], dg[key]["err"], dg[key]["ms"], dg[key]["plain_ms"],
                summed_bound(dg[key]), dg_at, library_ms=dg[key].get("library_ms"))
          for key in HOIST_KEYS),
        entry("knn", "knn", KNN_SRC, TPU_KNN, dg_launches["knn"],
              max(dg["knn"]["err"], geo["knn_geoa3"]["err"],
                  *(r["err"] for r in (*cn_knn.values(), *c5_knn.values(), *dn["knn"].values()))),
              dg["knn"]["ms"],
              dg["knn"]["plain_ms"], summed_bound(dg["knn"]), dg_at,
              shapes={**dg["knn"]["shapes"], f"geoa3 cached set {tuple(geo_data.shape)} k={GEO_K + 1}": geo["knn_geoa3"],
                      **cn_knn, **c5_knn, **dn["knn"]}),
        entry("min_sqdist_rows", "min_rows", CHAMFER_SRC, TPU_CHAMFER, knn1["min_rows"], cham["err"], cham["ms"],
              cham["plain_ms"], cham["bound"], f"B={B} N=M={N}, one KNN iteration's Chamfer on PointNet",
              device_ms=cham["device_ms"], bound_issued_ms=cham["bound_issued"][0], shapes=cham["shapes"]),
        *(entry(name, key, src, tpu, geo_launches[key], geo[key]["err"], geo[key]["ms"], geo[key]["plain_ms"],
                summed_bound(geo[key]), geo_at, device_ms=geo[key]["device_ms"])
          for name, key, src, tpu in (("kappa_knn_mean_fwd", "kappa_fwd", KAPPA_SRC, TPU_KAPPA_FWD),
                                      ("kappa_knn_mean_bwd", "kappa_bwd", KAPPA_SRC, TPU_KAPPA_BWD),
                                      ("min_sqdist_both_fwd", "both_fwd", BOTH_SRC, TPU_BOTH_FWD),
                                      ("min_sqdist_both_bwd", "both_bwd", BOTH_SRC, TPU_BOTH_BWD))),
        *(entry(name, key, KAPPA_SRC, tpu, geo_r4[key], geo[key]["err"], geo[key]["ms"], geo[key]["plain_ms"],
                summed_bound(geo[key]), f"one GeoA3 iteration's call on PointNet at curv_knn_refresh {GEO_REFRESH} "
                f"(B=8, N=1024, k={GEO_K}, a stale set)",
                device_ms=geo[key]["device_ms"],
                **({"launch_floor_ms": geo[key]["launch_floor_ms"]} if "launch_floor_ms" in geo[key] else {}))
          for name, key, tpu in (("kappa_knn_mean_from_idx_fwd", "kappa_idx_fwd", TPU_KAPPA_IDX_FWD),
                                 ("kappa_knn_mean_from_idx_bwd", "kappa_idx_bwd", TPU_KAPPA_IDX_BWD))),
        *(entry(name, key, GROUP_SRC, tpu, cn_cw[key],
                max([cnk[key]["err"], *(r["max_abs_err"] for r in dn.get(key, {}).values())]), cnk[key]["ms"],
                cnk[key]["plain_ms"], summed_bound(cnk[key]), cn_at[pool], cnk[key]["rows"],
                **{x: cnk[key][x] for x in ("device_ms",) if x in cnk[key]},
                **({"shapes": {**cnk[key].get("shapes", {}), **dn.get(key, {})}}
                   if "shapes" in cnk[key] or key in dn else {}))
          for name, key, tpu, pool in (("chain_groupmax_fwd", "group_max_fwd", TPU_GROUP_FWD, "max"),
                                       ("chain_groupmax_bwd", "group_max_bwd", TPU_GROUP_BWD, "max"),
                                       ("chain_groupmean_fwd", "group_mean_fwd", TPU_GROUP_MEAN_FWD, "mean"),
                                       ("chain_groupmean_bwd", "group_mean_bwd", TPU_GROUP_BWD, "mean"))),
        *(entry(name, key, GATHER_SRC, tpu, cn_gather[key], cng[r]["err"], cng[r]["ms"], cng[r]["plain_ms"],
                summed_bound(cng[r]), gather_at[r], cng[r]["rows"])
          for name, key, tpu, r in (("gather_chain_groupmean_fwd", "gather_mean_fwd", TPU_GATHER_FWD, "mean_fwd"),
                                    ("gather_chain_groupmean_bwd", "gather_mean_bwd", TPU_GATHER_BWD, "mean_bwd"))),
        *(entry(f"ball_hoist_{key}", f"ball_{key}", BALL_SRC, TPU_GATHER_FWD if key.endswith("fwd") else
                TPU_GATHER_BWD, ssg[4][f"ball_{key}"], ballq[key]["err"], ballq[key]["ms"], ballq[key]["plain_ms"],
                summed_bound(ballq[key]), ssg_at + ", ball route; ms the kernel's device time",
                library_ms=ballq[key].get("library_ms"),
                shapes={name: {"ms": v["stages"][key][0], "plain_ms": v["stages"][key][1],
                               "library_ms": v["stages"][key][2], "bound_ms": v["stages"][key][3]}
                        for name, v in ballq_shapes.items()},
                **({"route_ms": {name: {**v["route"], **{b: v[b] for b in ("bound_fwd", "bound_fwd_fp32", "bound_bwd",
                                                                          "bound_bwd_fp32", "winning_rows")}}
                                 for name, v in ballq_shapes.items()}}
                   if key == "stack_fwd" else {}))
          for key in BALL_KEYS),
    ]}
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
