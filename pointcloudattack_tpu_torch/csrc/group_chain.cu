// Per-point Dense -> eval-BatchNorm -> LeakyReLU chain over grouped rows
// [B, G, K, C0], with a max or a mean over each group's K rows, and its
// input gradient, for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by pointcloudattack_tpu_torch/ops/group_chain.py.
//
// Replaces the TPU kernels of pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:
//   max  forward  _group_fwd_pallas (pallas_call at :439, body _group_fwd_kernel)
//   mean forward  _group_mean_fwd_pallas (pallas_call at :470, _group_mean_fwd_kernel)
//   backward      _group_bwd_pallas (pallas_call at :522, _group_bwd_kernel and
//                 _group_mean_bwd_kernel)
// reached through mlp_chain_groupmax and mlp_chain_groupmean.  Every row
// runs z_l = (h_l @ w_l + b_l - mean_l) * mul_l + beta_l with
// h_l+1 = max(z, slope * z) between layers.  Max: no activation after the
// last layer, y [B, G, C_L] the max over K and am [B, G, C_L] int32 the
// lowest k attaining it.  Mean: every layer activated, y the sum of the K
// rows in ascending k, divided by K.  The backward takes g = dy * mul_L
// (max) or dy * mul_L / K (mean) and returns dx [B, G, K, C0].
//
// What bounds it on this card.  CurveNet's LPFAs (B=8, K=20) run one layer
// each, C0 -> C over B * G * K rows: about C / 2 flops a byte of input rows
// forward, against the card's f32 ridge of 20 (67 TFLOP/s over 3.35
// TB/s).  So bytes bound the 9 -> 32 max and the 16- and 32-wide means
// (8 to 16 flops a byte), and operations bound the 64- and 128-wide means
// (32 and 64 flops a byte), forward and backward alike.  The max's
// backward at one layer reads no rows: dx = g on the argmax rows times
// W^T, so it moves only g, am and dx.  The unfused version writes each
// layer's [B, G, K, C] map and reads it back for the BatchNorm, the
// activation and the pool; this kernel reads the rows once and writes only
// the pooled output (and dx).
//
// PU-Net's set abstractions (B=32, K=32: 3-32-32-64 over 1,048,576 rows up
// to 259-256-256-512 over 131,072) run the multi-layer max, bound by
// operations: sa3's forward is 68.9 GFLOP against 136 MB of rows (about
// 500 flops a byte), 1.03 ms at the FP32 peak, 0.42 ms as 3xTF32 on the
// tensor cores.  Its backward has work only on the rows that win a column
// (24% to 66% of them).
//
// What the design does about it.
//   * The multi-layer max (every max chain the one-layer kernels do not
//     take, K a power of two up to 64; ops/group_chain.py::max_route) runs
//     group_mfwd_kernel and, backward, group_mlists_kernel,
//     group_mscan_kernel and group_mrows_kernel, their products as 3xTF32
//     mma.sync m16n8k8 (chain_common.cuh's split_tf32 / mma_tf32; a first
//     layer of fewer than 8 inputs on FP32 FMA).  A block holds a tile of
//     T rows (128 where no product is wider than 64, else 64, else 32;
//     mx_plan) in two [T][S] activation buffers, S the widest input padded
//     to 8, plus 4: the weights stream through L2 once a tile, in steps of
//     32 depth rows x 128 columns through a ring of 2-3 stages filled by
//     cp.async; a warp takes 16 or 32 rows x 32 columns of a chunk; two
//     blocks of 8 warps share an SM where their shared memory fits, else
//     one block of 16 warps.  The forward's blocks stay resident and take
//     tiles of whole groups in turn, the ring running on from one tile to
//     the next and the next tile's rows copied in (4-byte copies: a row of
//     67, 131 or 259 floats is not 16-byte aligned) behind the last layer,
//     into the buffer it leaves free.  The hidden layers are one function,
//     mx_hidden, which the backward's recompute calls too, so its masks
//     are the forward's signs bit for bit (a row's bits do not depend on
//     the other rows of its tile: the depth order and the order of the
//     three products are fixed).  The last layer's epilogue applies the
//     BatchNorm and reduces each group's K rows from the accumulators:
//     (value, k) as one 64-bit key (mx_key), merged by max over the
//     thread's rows, then the lanes (a butterfly: K is a power of two),
//     then the warps of a group through shared memory, so a tie keeps the
//     lowest k in any order; z never leaves the registers.  Backward: the
//     lists (a warp a group: the winning rows as bits, ORed over the lanes,
//     each placed by a popcount; no atomics), their offsets (one block's
//     scan), then resident blocks over tiles of listed rows: the rows by
//     4-byte copies, the hidden layers again with their masks as bits, the
//     one-hot cotangent through W_L^T as a dense 3xTF32 product over the
//     listed rows (its A fragments formed from each row's (am, g) entries,
//     which the ring brings in beside W), then back through the masks and
//     mul factors, W read as stored and transposed in the fragment loads;
//     every other row's dx is a memset's 0, each listed row's written once.
//     A sparse expansion on the CUDA cores (a ballot over each step's am
//     entries) lost to the dense product at every PU-Net shape on an H100
//     (PERF.md, row 2, with where the forward's time goes).
//   * The multi-layer mean (and a max shape the kernels above do not take)
//     run group_fwd_kernel and group_bwd_kernel.  The rows of a group are
//     contiguous, so a block takes
//     whole groups: a tile of T = 8 * TM rows holds gpb = floor(T / K) groups
//     (3 at K = 20 and T = 64: 60 rows of 64 at work), and a ragged G masks
//     the last tile's missing groups.  K <= T.  The chain is
//     chain_common.cuh's register-tiled f32 layer pass, with its slope.  The
//     last layer's epilogue writes the tile's z (max) or activation (mean) to
//     a shared [C_L][T + 1] buffer, and one thread per (group, column) scans
//     the group's K rows in ascending k: a strict '>' keeps the lowest k
//     among ties (the TPU kernel's min-iota), and the mean sums in ascending
//     k, then divides by K as jnp.mean does.  Backward: recompute the hidden
//     layers (their signs are the masks); max puts g on each column's argmax
//     row, mean recomputes the last layer and puts act'(z_L) * g on every
//     row; then chain_common.cuh's dense backward takes the [C_L][T]
//     cotangent through W_L^T and the hidden layers.  Each row's dx is its
//     own: no atomics, deterministic.
//   * One layer (CurveNet's LPFAs: the initial 9 -> 32 max, eight residual
//     means 16 to 128 wide) has kernels of its own.  Clock probes of the
//     chain kernels at those shapes (H100, 700 W) found 125-128 registers
//     and 2 blocks an SM, rows loaded by scalar loads that nothing overlaps
//     (39-47% of a forward block below 128 wide), the weights restaged
//     through a 16-deep tile with barriers, 60 of 64 tile rows at work, and
//     the max backward's one-hot [C_L][T] tile taking half its block.  The
//     one-layer kernels keep their blocks resident over tiles, with W and
//     the BatchNorm vectors staged once a block, and share one recompute,
//     lpfa_z: fmaf over the input channels in ascending order from 0, then
//     group_fwd_kernel's epilogue, register-tiled 4 rows x 4 columns a
//     thread on the CUDA cores, its lanes split between rows and columns by
//     the width so that every lane works at 16 wide.  The forward and the
//     mean backward both take z from it, so the backward's masks are the
//     forward's signs bit for bit (a unit near 0 could otherwise take the
//     other slope).
//   * The one-layer forward (group_fwd1_kernel, either pool): a tile is
//     as many whole groups as fit in kF1Rows rows or one sweep of the row
//     lanes, whichever is more (120 rows at K = 20 at 32 wide); the next
//     tile's rows come in by cp.async into a second buffer while this one's
//     z goes to a shared [tr][sc] tile, and one thread a (group, column)
//     pools it as above.
//   * The one-layer mean backward (group_mean1_bwd_kernel): dx_r =
//     (mask(z_r) * g[r / K]) W^T.  Its bound is bytes at 16 and 32 widths (x
//     read and dx written once: 0.0064 and 0.0128 ms at 163,840 rows) and
//     operations at 64 and 128 (2 C^2 flops a row in FP32 for the
//     recompute, three TF32 products of 2 C^2 for the product back: 0.0070
//     ms).  It tiles the rows without regard to groups (the tile's g rows in
//     shared memory) and copies the next tile's rows in while this one's
//     product back runs.  The product back, dx = cot W^T, has two forms,
//     timed side by side on the same inputs by chip_smoke.py's
//     [kernels-curvenet] on an H100 (700 W): 3xTF32 mma.sync, 0.032-0.033
//     ms a launch at 64 and 128 wide against 0.036-0.037 for FP32 register
//     tiles laid out as the recompute's, and FP32, 0.0167 ms at 16 wide
//     against 0.0195-0.0197, where an m16n8k8 job holds 2 of its 4 n8 tiles
//     and 2 k-steps.  The wrapper takes FP32 up to 16 wide and 3xTF32 past
//     it (ops/group_chain.py::mean1_tc); either keeps dx within f32 rounding
//     of the plain product (DX_TOL).  Within a k-step each of the three TF32
//     products runs over the warp's n8 tiles in turn, so that no mma waits
//     on the one before it.
//   * The one-layer max backward (group_max1_bwd_kernel) reads no rows:
//     dx[n, k, :] sums g[n, c] W[:, c] over the columns c whose winner is
//     row k, so it moves only am, g and dx (256 bytes in and 720 out a
//     group at 9 -> 32, K = 20).  A warp takes a few groups at a time, a
//     lane a (group, channel), and walks the columns in ascending order,
//     adding into the winner's row of a zeroed dx tile in shared memory; the
//     tile leaves by coalesced stores.  Each output is one lane's sum in a
//     fixed order: no atomics, two backwards bit-equal.

#include "chain_common.cuh"

#include <algorithm>

namespace {

using namespace pca;

// Dynamic shared memory of one forward block: two activation buffers of
// the widest layer input, the padded [C_L][T + 1] last-layer buffer and the
// weight tile.
size_t fwd_smem(int L, const int* dims, int tm) {
  const size_t T = 8 * (size_t)tm;
  int maxw = dims[0];
  for (int l = 1; l < L; ++l) maxw = dims[l] > maxw ? dims[l] : maxw;
  return 2 * align16(sizeof(float) * maxw * T) + align16(sizeof(float) * dims[L] * (T + 1)) +
         align16(sizeof(float) * kKTile * kChunk);
}

size_t group_smem(int L, const int* dims, int K, int tm, int bwd) {
  if (!bwd) return fwd_smem(L, dims, tm);
  // the gather kernel's dense backward layout, gpb groups of (argmax, g)
  return chain_smem_bytes(L, dims, tm, 1, (8 * tm) / K, true);
}

// The tile rows [0, rows) of block bx, cloud b, into the shared [C0][T]
// tile xT; rows past them are 0.
template <int TM>
__device__ __forceinline__ void load_rows_tile(const float* __restrict__ x, int C0, size_t row0,
                                               int rows, float* xT) {
  const float* xb = x + row0 * C0;
  fill_tile<TM>(C0, [&](int r, int col) { return r < rows ? xb[(size_t)r * C0 + col] : 0.f; }, xT);
}

template <int TM, bool kMean>
__global__ void __launch_bounds__(kThreads, 2)
    group_fwd_kernel(const float* __restrict__ x, int G, int K, int gpb, Chain ch,
                     float* __restrict__ y, int* __restrict__ am) {
  constexpr int T = 8 * TM, TP = T + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bx = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = ch.L, C0 = ch.dims[0], CL = ch.dims[L];
  const int g0 = bx * gpb, ng = min(gpb, G - g0), rows = ng * K;

  int maxw = C0;
  for (int l = 1; l < L; ++l) maxw = max(maxw, ch.dims[l]);
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + align16(sizeof(float) * maxw * T) / sizeof(float);
  float* zs = nxt + align16(sizeof(float) * maxw * T) / sizeof(float);
  float* wtile = zs + align16(sizeof(float) * CL * TP) / sizeof(float);

  load_rows_tile<TM>(x, C0, ((size_t)b * G + g0) * K, rows, cur);
  for (int l = 0; l < L - 1; ++l) {
    hidden_layer<TM>(ch, l, cur, nxt, wtile);
    float* t = cur; cur = nxt; nxt = t;
  }
  const int l = L - 1;
  layer_pass<TM>(cur, ch.dims[l], ch.w[l], CL, wtile, [&](int c0, auto& acc) {
    constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + chunk_col<TN>(lane, j);
      if (c >= CL) continue;
      const float bb = ch.b[l][c], mm = ch.mean[l][c], mu = ch.mul[l][c], be = ch.beta[l][c];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float z = (acc[i][j] + bb - mm) * mu + be;
        zs[c * TP + warp * TM + i] = kMean ? act_fwd(z, ch.slope) : z;
      }
    }
  });
  __syncthreads();
  // one thread per (group, column): consecutive threads take consecutive
  // columns, whose rows lie in distinct banks
  for (int e = threadIdx.x; e < ng * CL; e += kThreads) {
    const int s = e / CL, c = e % CL;
    const float* col = zs + c * TP + s * K;
    const size_t o = ((size_t)b * G + g0 + s) * CL + c;
    if constexpr (kMean) {
      float sum = col[0];
      for (int k = 1; k < K; ++k) sum += col[k];
      y[o] = sum / (float)K;
    } else {
      float best = col[0];
      int arg = 0;
      for (int k = 1; k < K; ++k)
        if (col[k] > best) { best = col[k]; arg = k; }
      y[o] = best;
      am[o] = arg;
    }
  }
}

template <int TM, bool kMean>
__global__ void __launch_bounds__(kThreads)
    group_bwd_kernel(const float* __restrict__ x, int G, int K, int gpb, Chain ch,
                     const int* __restrict__ am, const float* __restrict__ g,
                     float* __restrict__ dx) {
  constexpr int T = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bx = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = ch.L, C0 = ch.dims[0], CL = ch.dims[L];
  const int g0 = bx * gpb, ng = min(gpb, G - g0), rows = ng * K;
  const size_t row0 = ((size_t)b * G + g0) * K;

  // act[0] = rows, act[l] = h_l (the activated output of layer l-1), l < L
  float* act[kMaxLayers];
  float* p = reinterpret_cast<float*>(smem);
  int maxg = 1;
  for (int l = 0; l < L; ++l) {
    act[l] = p;
    p += align16(sizeof(float) * ch.dims[l] * T) / sizeof(float);
    if (l > 0) maxg = max(maxg, ch.dims[l]);
  }
  float* gin = p;
  float* gout = gin + align16(sizeof(float) * maxg * T) / sizeof(float);  // also the [CL][T] cotangent
  float* wtile = gout + align16(sizeof(float) * max(maxg, CL) * T) / sizeof(float);
  int* am_s = reinterpret_cast<int*>(wtile + kKTile * kChunk);
  float* g_s = reinterpret_cast<float*>(am_s) + align16(gpb * CL * sizeof(int)) / sizeof(float);

  // the max's one-layer backward reads no rows: act[0] only receives dx
  if (kMean || L > 1) load_rows_tile<TM>(x, C0, row0, rows, act[0]);
  for (int e = threadIdx.x; e < ng * CL; e += kThreads) {
    const size_t o = ((size_t)b * G + g0) * CL + e;
    if (!kMean) am_s[e] = am[o];
    g_s[e] = g[o];
  }
  for (int l = 0; l < L - 1; ++l) hidden_layer<TM>(ch, l, act[l], act[l + 1], wtile);
  __syncthreads();

  if constexpr (kMean) {
    // recompute the last layer: every row's cotangent is act'(z_L) * g
    const int l = L - 1;
    layer_pass<TM>(act[l], ch.dims[l], ch.w[l], CL, wtile, [&](int c0, auto& acc) {
      constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + chunk_col<TN>(lane, j);
        if (c >= CL) continue;
        const float bb = ch.b[l][c], mm = ch.mean[l][c], mu = ch.mul[l][c], be = ch.beta[l][c];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = warp * TM + i;
          const float z = (acc[i][j] + bb - mm) * mu + be;
          gout[c * T + r] = r < rows ? act_bwd_mul(z, g_s[(r / K) * CL + c], 1.f, ch.slope) : 0.f;
        }
      }
    });
  } else {
    for_tile<TM>(CL, [&](int r, int c) {
      const int s = r / K;
      gout[c * T + r] = (r < rows && am_s[s * CL + c] == r - s * K) ? g_s[s * CL + c] : 0.f;
    });
  }
  float* drow = act[0];  // the row cotangent replaces the rows, column by column
  chain_bwd_dense<TM>(ch, act, gin, gout, wtile, [&](int r, int k, float v) { drow[k * T + r] = v; });
  __syncthreads();
  float* db = dx + row0 * C0;
  for_tile<TM>(C0, [&](int r, int col) {
    if (r < rows) db[(size_t)r * C0 + col] = drow[col * T + r];
  });
}

// ---------------------------------------------------------------------------
// The one-layer kernels (CurveNet's LPFAs): the forward of either pool, the
// mean backward and the max backward
// ---------------------------------------------------------------------------

constexpr int kMbWarps = 8;  // warps of a block
constexpr int kMbTM = 4;     // rows of a thread in the recompute
constexpr int kMbTN = 4;     // adjacent columns of a thread in the recompute (a float4 of W)
constexpr int kMbNB = 4;     // n8 tiles of a warp's job in the product back

// Lanes across the recompute's columns: 4 adjacent columns a lane, at most
// 32 lanes (wider layers take chunks of 128 columns).
inline int mean1_lanes(int C) {
  int lc = 1;
  while (lc < 32 && 4 * lc < C) lc <<= 1;
  return lc;
}

// A row stride for C floats: past C rounded up to 8 (the product's depth
// step, the pad zero), 4 more, so that 8 consecutive rows' float4s, and an
// mma fragment's 8 rows x 4 columns, fall in distinct banks.
inline int mean1_stride(int C) { return ((C + 7) & ~7) + 4; }

// Rows [row0, row0 + tr) of x [R, C0] into xs ([tr][sx]; 0 past row R), by
// copies in flight (committed by the caller): 16 bytes a copy where vec
// (C0 % 4 == 0 and x 16-byte aligned), else 4.
__device__ __forceinline__ void load_rows_async(const float* __restrict__ x, size_t R, int C0, int sx, size_t row0,
                                                int tr, int vec, float* xs) {
  const size_t left = R - row0;
  const int rows = left < (size_t)tr ? (int)left : tr;
  const float* xb = x + row0 * C0;
  // element e = r * per + q of the tile, stepped by the block without a division per element
  const int per = vec ? C0 >> 2 : C0, w = vec ? 4 : 1, nt = blockDim.x;
  const int dr = nt / per, dq = nt - dr * per;
  int r = threadIdx.x / per, q = threadIdx.x - r * per;
  for (; r < tr; r += dr, q += dq) {
    if (q >= per) { q -= per; ++r; }
    if (r >= tr) break;
    const bool ok = r < rows;
    const float* src = ok ? xb + (size_t)r * C0 + w * q : xb;
    if (vec) cp_async16(xs + r * sx + 4 * q, src, ok ? 16 : 0);
    else cp_async4(xs + r * sx + q, src, ok ? 4 : 0);
  }
}

// W [C0, CL] into ws ([C0][sw], 0 past CL) and b, mean, mul, beta into bn
// ([4][sw]), by copies in flight (committed by the caller).
__device__ __forceinline__ void stage_layer(const float* __restrict__ w, const float* const (&vecs)[4], int C0, int CL,
                                            int sw, float* ws, float* bn) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (CL % 4 == 0 && (reinterpret_cast<size_t>(w) & 15) == 0) {
    const int per = CL >> 2;
    for (int e = tid; e < C0 * per; e += nt) {
      const int k = e / per, q = e - k * per;
      cp_async16(ws + k * sw + 4 * q, w + (size_t)k * CL + 4 * q, 16);
    }
  } else {
    for (int e = tid; e < C0 * CL; e += nt) {
      const int k = e / CL;
      cp_async4(ws + k * sw + (e - k * CL), w + e, 4);
    }
  }
  for (int e = tid; e < C0 * (sw - CL); e += nt) {
    const int k = e / (sw - CL);
    ws[k * sw + CL + (e - k * (sw - CL))] = 0.f;
  }
  for (int e = tid; e < 4 * CL; e += nt) {
    const int v = e / CL;  // a select, not an index: an indexed parameter array would go to local memory
    const float* src = v == 0 ? vecs[0] : v == 1 ? vecs[1] : v == 2 ? vecs[2] : vecs[3];
    cp_async4(bn + v * sw + (e - v * CL), src + (e - v * CL), 4);
  }
}

// The one-layer chain's pre-activations, the recompute that the forward
// and the mean backward share so that the backward's masks are the
// forward's signs bit for bit: z[i][j] of tile row rb + LR * i (clamped to
// the tile's last row, tr - 1) and column cq + j, from the rows in xs
// ([tr][sx]), W in ws ([C0][sw]) and b, mean, mul, beta in bn ([4][sw]).
// fmaf over the input channels in ascending order from 0, then the
// BatchNorm epilogue as group_fwd_kernel writes it; it must stay on the
// CUDA cores.  A thread's TM rows are interleaved with the other row
// lanes' (float4 reads of x along the channels), its 4 columns adjacent
// (one float4 of W a channel).
template <int TM>
__device__ __forceinline__ void lpfa_z(const float* xs, int sx, const float* ws, int sw, const float* bn, int C0,
                                       int rb, int LR, int tr, int cq, float (&z)[TM][kMbTN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kMbTN; ++j) z[i][j] = 0.f;
  int k = 0;
#pragma unroll 2  // the next channels' loads issue under this step's FMAs; each z keeps its order
  for (; k + 4 <= C0; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) wv[u] = *reinterpret_cast<const float4*>(ws + (k + u) * sw + cq);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + min(rb + LR * i, tr - 1) * sx + k);
      const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        z[i][0] = fmaf(xk[u], wv[u].x, z[i][0]);
        z[i][1] = fmaf(xk[u], wv[u].y, z[i][1]);
        z[i][2] = fmaf(xk[u], wv[u].z, z[i][2]);
        z[i][3] = fmaf(xk[u], wv[u].w, z[i][3]);
      }
    }
  }
  for (; k < C0; ++k) {
    const float4 wv = *reinterpret_cast<const float4*>(ws + k * sw + cq);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float xv = xs[min(rb + LR * i, tr - 1) * sx + k];
      z[i][0] = fmaf(xv, wv.x, z[i][0]);
      z[i][1] = fmaf(xv, wv.y, z[i][1]);
      z[i][2] = fmaf(xv, wv.z, z[i][2]);
      z[i][3] = fmaf(xv, wv.w, z[i][3]);
    }
  }
  const float4 bb = *reinterpret_cast<const float4*>(bn + cq);
  const float4 mm = *reinterpret_cast<const float4*>(bn + sw + cq);
  const float4 mu = *reinterpret_cast<const float4*>(bn + 2 * sw + cq);
  const float4 be = *reinterpret_cast<const float4*>(bn + 3 * sw + cq);
  const float bbv[4] = {bb.x, bb.y, bb.z, bb.w}, mmv[4] = {mm.x, mm.y, mm.z, mm.w};
  const float muv[4] = {mu.x, mu.y, mu.z, mu.w}, bev[4] = {be.x, be.y, be.z, be.w};
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kMbTN; ++j) z[i][j] = (z[i][j] + bbv[j] - mmv[j]) * muv[j] + bev[j];  // group_fwd_kernel's
}

// --- the forward -----------------------------------------------------------

struct Fwd1 {
  const float* x;           // [NG * K, C0]
  const float* w;           // [C0, CL] row-major
  const float* vecs[4];     // b, mean, mul, beta [CL]
  float* y;                 // [NG, CL]
  int* am;                  // [NG, CL] (max)
  size_t NG;                // B * G groups
  int K, C0, CL;
  int lc;                   // lanes across the recompute's columns (mean1_lanes)
  int nw;                   // warps of a block
  int gpt;                  // groups of a tile
  int tr;                   // rows of a tile, gpt * K
  int sx, sc, sw;           // row strides of the x tiles, the z tile and W
  int vec;                  // 16-byte copies of x
  float slope;
};

// The one-layer forward's knobs, each chosen by an A/B on an H100 (the
// arms are in PERF.md, row 3): a tile of as many whole groups as fit in
// kF1Rows rows or one sweep of the block's row lanes, whichever is more; 16
// warps a block where W staged passes kFwd1WideW bytes (128 wide), so that
// they share one copy, else 8; kF1TM rows a thread in the recompute;
// kF1Pool loads of a group's rows in flight in the pool.
constexpr int kF1Rows = 64;
constexpr size_t kFwd1WideW = 32768;
constexpr int kF1TM = 4;
constexpr int kF1Pool = 4;

// Shared memory of a forward block: W, the BatchNorm vectors, the z tile
// and two x tiles.
inline size_t fwd1_smem(const Fwd1& p) {
  return align16(sizeof(float) * (size_t)p.C0 * p.sw) + align16(sizeof(float) * 4 * (size_t)p.sw) +
         align16(sizeof(float) * (size_t)p.tr * p.sc) + 2 * align16(sizeof(float) * (size_t)p.tr * p.sx);
}

// The tile: as many whole groups as fit in max(kF1Rows, one sweep of the
// block's row lanes) rows (at least one), halved while the block's shared
// memory would pass the card's limit.
inline Fwd1 fwd1_shape(size_t NG, int K, int C0, int CL) {
  Fwd1 p = {};
  p.NG = NG;
  p.K = K;
  p.C0 = C0;
  p.CL = CL;
  p.lc = mean1_lanes(CL);
  p.sx = mean1_stride(C0);
  p.sc = p.sw = mean1_stride(CL);
  p.nw = sizeof(float) * (size_t)C0 * p.sw > kFwd1WideW ? 2 * kMbWarps : kMbWarps;
  const int sweep = p.nw * kF1TM * (32 / p.lc);
  p.gpt = std::max(1, std::max(sweep, kF1Rows) / K);
  if ((size_t)p.gpt > NG) p.gpt = (int)NG;
  for (;; p.gpt = std::max(1, p.gpt / 2)) {
    p.tr = p.gpt * K;
    if (p.gpt == 1 || fwd1_smem(p) <= kMaxSmem) break;
  }
  return p;
}

// y [NG, CL] of the one-layer chain over groups of K rows: the mean of the
// activated rows (kMean) or the max of z with its lowest argmax.  The
// blocks stay resident and take tiles of gpt whole groups in turn; W and
// the BatchNorm vectors come in once a block, and the next tile's rows are
// copied in (cp.async) while this one is worked.
//   1. z of every tile row (lpfa_z), activated for the mean, into the
//      shared [tr][sc] tile.
//   2. One thread a (group, column) scans the group's K rows in ascending
//      k: the mean sums them, then divides by K; the max keeps the lowest k
//      under a strict '>' (the TPU kernel's min-iota).
template <bool kMean>
__global__ void __launch_bounds__(2 * kMbWarps * 32) group_fwd1_kernel(Fwd1 p, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = p.nw;
  const int C0 = p.C0, CL = p.CL, K = p.K, tr = p.tr;
  float* ws = reinterpret_cast<float*>(smem);                                     // [C0][sw]
  float* bn = ws + align16(sizeof(float) * (size_t)C0 * p.sw) / sizeof(float);   // [4][sw]
  float* zs = bn + align16(sizeof(float) * 4 * (size_t)p.sw) / sizeof(float);    // [tr][sc]
  float* xs0 = zs + align16(sizeof(float) * (size_t)tr * p.sc) / sizeof(float);  // [2][tr][sx]
  const size_t xstep = align16(sizeof(float) * (size_t)tr * p.sx) / sizeof(float);
  const size_t R = p.NG * K;

  stage_layer(p.w, p.vecs, C0, CL, p.sw, ws, bn);
  load_rows_async(p.x, R, C0, p.sx, (size_t)blockIdx.x * tr, tr, p.vec, xs0);
  cp_async_commit();

  const int lc = lane & (p.lc - 1), lr = lane / p.lc, LR = 32 / p.lc;
  int buf = 0;
  for (size_t t = blockIdx.x; t < (size_t)tiles; t += gridDim.x, buf ^= 1) {
    cp_async_wait<0>();  // this tile's rows have landed
    __syncthreads();     // and every thread is done with the other buffer and with zs
    if (t + gridDim.x < (size_t)tiles)
      load_rows_async(p.x, R, C0, p.sx, (t + gridDim.x) * tr, tr, p.vec, xs0 + (buf ^ 1) * xstep);
    cp_async_commit();
    const float* xs = xs0 + buf * xstep;
    const size_t g0 = t * p.gpt;
    const int ng = p.NG - g0 < (size_t)p.gpt ? (int)(p.NG - g0) : p.gpt, rows = ng * K;

    // 1. z (activated for the mean) of every row
    for (int s0 = 0; s0 < rows; s0 += nw * LR * kF1TM) {
      const int rb = s0 + warp * LR * kF1TM + lr;  // this thread's rows rb + LR * i
      for (int c0 = 0; c0 < CL; c0 += kMbTN * p.lc) {
        const int cq = min(c0 + kMbTN * lc, p.sw - 4);  // past CL: computed, never stored
        const int cols = min(kMbTN, CL - (c0 + kMbTN * lc));
        float z[kF1TM][kMbTN];
        lpfa_z<kF1TM>(xs, p.sx, ws, p.sw, bn, C0, rb, LR, tr, cq, z);
#pragma unroll
        for (int i = 0; i < kF1TM; ++i) {
          const int r = rb + LR * i;
          if (r >= rows) break;
          float v[kMbTN];
#pragma unroll
          for (int j = 0; j < kMbTN; ++j) v[j] = kMean ? act_fwd(z[i][j], p.slope) : z[i][j];
          if (cols == kMbTN) {
            *reinterpret_cast<float4*>(zs + r * p.sc + cq) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int j = 0; j < kMbTN; ++j)
              if (j < cols) zs[r * p.sc + cq + j] = v[j];
          }
        }
      }
    }
    __syncthreads();

    // 2. the pool: consecutive threads take consecutive columns (distinct banks)
    for (int e = tid; e < ng * CL; e += nw * 32) {
      const int s = e / CL, c = e - s * CL;
      const float* col = zs + s * K * p.sc + c;
      const size_t o = (g0 + s) * CL + c;
      float acc = col[0];
      int arg = 0;
      int k = 1;
      for (; k + kF1Pool <= K; k += kF1Pool) {  // kF1Pool loads in flight, then those rows in ascending k
        float v[kF1Pool];
#pragma unroll
        for (int u = 0; u < kF1Pool; ++u) v[u] = col[(k + u) * p.sc];
#pragma unroll
        for (int u = 0; u < kF1Pool; ++u) {
          if constexpr (kMean) acc += v[u];
          else if (v[u] > acc) { acc = v[u]; arg = k + u; }
        }
      }
      for (; k < K; ++k) {
        const float v = col[k * p.sc];
        if constexpr (kMean) acc += v;
        else if (v > acc) { acc = v; arg = k; }
      }
      if constexpr (kMean) {
        p.y[o] = acc / (float)K;
      } else {
        p.y[o] = acc;
        p.am[o] = arg;
      }
    }
    // the next tile's z overwrites zs only past the barrier at the loop's top
  }
  cp_async_wait<0>();
}

// --- the mean backward -----------------------------------------------------

struct MeanBwd {
  const float* x;        // [R, C0]
  const float* w;        // [C0, CL] row-major
  const float* vecs[4];  // b, mean, mul, beta [CL]
  const float* g;        // [R / K, CL]
  float* dx;             // [R, C0]
  size_t R;              // B * G * K rows
  int K, C0, CL;
  int lc;          // lanes across the recompute's columns: a power of 2 up to 32
  int lb;          // lanes across the FP32 product back's outputs, likewise
  int tr;          // rows of a tile
  int sx, sc, sw;  // row strides of the x tiles, the cotangent tile and W
  int ng;          // g rows a tile can touch
  int vec;         // C0 % 4 == 0 and x 16-byte aligned: 16-byte copies
  float slope;
};

// Shared memory of a block: W, the BatchNorm vectors, the cotangent tile,
// the x tile and the g rows.
inline size_t mean1_smem(const MeanBwd& m) {
  return align16(sizeof(float) * (size_t)m.C0 * m.sw) + align16(sizeof(float) * 4 * (size_t)m.sw) +
         align16(sizeof(float) * (size_t)m.tr * m.sc) + align16(sizeof(float) * (size_t)m.tr * m.sx) +
         align16(sizeof(float) * (size_t)m.ng * m.CL);
}

// The tile: as many rows as the recompute's row lanes cover in one sweep of
// the block (32 at 128 wide, 256 at 16), halved while the block's shared
// memory would pass the card's limit.
inline MeanBwd mean1_shape(size_t R, int K, int C0, int CL) {
  MeanBwd m = {};
  m.R = R;
  m.K = K;
  m.C0 = C0;
  m.CL = CL;
  m.lc = mean1_lanes(CL);
  m.lb = mean1_lanes(C0);
  m.sx = mean1_stride(C0);
  m.sc = mean1_stride(CL);
  m.sw = mean1_stride(CL);
  for (m.tr = kMbWarps * kMbTM * (32 / m.lc);; m.tr /= 2) {
    m.ng = (m.tr - 1) / K + 2;
    if (m.tr == 16 || mean1_smem(m) <= kMaxSmem) break;
  }
  return m;
}

// Tile t's g rows into gs, by 4-byte copies in flight (committed by the
// caller).
__device__ __forceinline__ void mean1_load_g(const MeanBwd& p, size_t t, float* gs) {
  const size_t row0 = t * p.tr, left = p.R - row0;
  const int rows = left < (size_t)p.tr ? (int)left : p.tr;
  const size_t gfirst = row0 / p.K;
  const int n = (int)((row0 + rows - 1) / p.K - gfirst + 1) * p.CL;
  for (int e = threadIdx.x; e < n; e += kMbWarps * 32) cp_async4(gs + e, p.g + gfirst * p.CL + e, 4);
}

// dx [R, C0] of the one-layer mean for g = dy * mul / K: for each row r of
// group r / K, cot_r = act_bwd_mul(z_r, g[r / K], 1, slope) and dx_r =
// cot_r W^T.  The blocks stay resident and take tiles of tr rows in turn,
// whatever the groups, the next tile's rows and g rows copied in (cp.async)
// while this one's product back runs; W, once a block, sits in shared
// memory.
//   1. The recompute: z from lpfa_z, the forward's own arithmetic, so the
//      masks are the forward's signs bit for bit; the cotangent tile goes
//      to shared memory.
//   2. The product back, dx = cot W^T.  kTc: as 3xTF32 mma.sync m16n8k8
//      (chain_common.cuh's split_tf32 / mma_tf32): a warp takes 16 rows x
//      up to 32 outputs; W, stored [C0][CL], is the B operand as it lies.
//      Else in FP32 on the CUDA cores, register-tiled as the recompute: 4
//      rows x 4 outputs a thread, float4 reads of the cotangent rows and of
//      W's rows along CL; a lane's 4 outputs are lb apart, so that the lanes
//      read adjacent rows of W (distinct banks) and store adjacent columns.
// Each row's dx is its own: no atomics.
template <bool kTc>
__global__ void __launch_bounds__(kMbWarps * 32) group_mean1_bwd_kernel(MeanBwd p, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = kMbWarps;
  const int C0 = p.C0, CL = p.CL, K = p.K, tr = p.tr;
  float* ws = reinterpret_cast<float*>(smem);                                        // [C0][sw]
  float* bn = ws + align16(sizeof(float) * (size_t)C0 * p.sw) / sizeof(float);      // b, mean, mul, beta [4][sw]
  float* cs = bn + align16(sizeof(float) * 4 * (size_t)p.sw) / sizeof(float);       // [tr][sc]
  float* xs = cs + align16(sizeof(float) * (size_t)tr * p.sc) / sizeof(float);      // [tr][sx]
  float* gs = xs + align16(sizeof(float) * (size_t)tr * p.sx) / sizeof(float);      // [ng][CL]
  const int CL8 = (CL + 7) & ~7;

  // W (0 past CL) and the BatchNorm vectors by copies in flight, with the first tile's
  stage_layer(p.w, p.vecs, C0, CL, p.sw, ws, bn);
  load_rows_async(p.x, p.R, C0, p.sx, (size_t)blockIdx.x * tr, tr, p.vec, xs);
  mean1_load_g(p, blockIdx.x, gs);
  cp_async_commit();
  for (int e = tid; e < tr * (CL8 - CL); e += kMbWarps * 32) {  // the cotangent's pad columns stay 0
    const int r = e / (CL8 - CL);
    cs[r * p.sc + CL + (e - r * (CL8 - CL))] = 0.f;
  }

  for (size_t t = blockIdx.x; t < (size_t)tiles; t += gridDim.x) {
    const size_t row0 = t * tr;
    const size_t left = p.R - row0;
    const int rows = left < (size_t)tr ? (int)left : tr;
    const int rem = (int)(row0 - row0 / K * K);  // row0's place in its group: row r's group is (rem + r) / K
    cp_async_wait<0>();  // this tile's copies have landed
    __syncthreads();

    // 1. z, its mask and the cotangent of every tile row
    {
      const int lc = lane & (p.lc - 1), lr = lane / p.lc, LR = 32 / p.lc;
      for (int s0 = 0; s0 < tr; s0 += nw * LR * kMbTM) {
        const int rb = s0 + warp * LR * kMbTM + lr;  // this thread's rows rb + LR * i
        int grp[kMbTM];  // their g rows in gs
#pragma unroll
        for (int i = 0; i < kMbTM; ++i) grp[i] = (rem + min(rb + LR * i, rows - 1)) / K * CL;
        for (int c0 = 0; c0 < CL; c0 += kMbTN * p.lc) {
          const int cq = min(c0 + kMbTN * lc, p.sw - 4);  // past CL: computed, never stored
          const int cols = min(kMbTN, CL - (c0 + kMbTN * lc));  // <= 0 where cq was clamped
          float z[kMbTM][kMbTN];
          lpfa_z<kMbTM>(xs, p.sx, ws, p.sw, bn, C0, rb, LR, tr, cq, z);
          // each row's four cotangents as one float4 where all four columns exist
#pragma unroll
          for (int i = 0; i < kMbTM; ++i) {
            const int r = rb + LR * i;
            if (r >= tr) break;
            float v[kMbTN];
#pragma unroll
            for (int j = 0; j < kMbTN; ++j)
              v[j] = (r < rows && j < cols) ? act_bwd_mul(z[i][j], gs[grp[i] + cq + j], 1.f, p.slope) : 0.f;
            if (cols == kMbTN) {
              *reinterpret_cast<float4*>(cs + r * p.sc + cq) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
              for (int j = 0; j < kMbTN; ++j)
                if (j < cols) cs[r * p.sc + cq + j] = v[j];
            }
          }
        }
      }
    }
    __syncthreads();  // xs and gs are free: the next tile's rows and g rows come in behind the product back
    if (t + gridDim.x < (size_t)tiles) {
      load_rows_async(p.x, p.R, C0, p.sx, (t + gridDim.x) * tr, tr, p.vec, xs);
      mean1_load_g(p, t + gridDim.x, gs);
    }
    cp_async_commit();

    // 2. dx = cot W^T: warp jobs of 16 rows x kMbNB n8 tiles
    if constexpr (kTc) {
      const int g8 = lane >> 2, t4 = lane & 3;
      const int mt = tr / 16, nt = (C0 + 7) / 8, nb = (nt + kMbNB - 1) / kMbNB;
      for (int job = warp; job < mt * nb; job += nw) {
        const int m0 = (job % mt) * 16, n0 = (job / mt) * kMbNB * 8;
        float acc[kMbNB][4];
#pragma unroll
        for (int j = 0; j < kMbNB; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
        const float* As = cs + (m0 + g8) * p.sc + t4;
        for (int kk = 0; kk < CL8; kk += 8) {
          unsigned ah[4], al[4];
          split_tf32(As[kk], ah[0], al[0]);                  // (row g, k t)
          split_tf32(As[8 * p.sc + kk], ah[1], al[1]);       // (g + 8, t)
          split_tf32(As[kk + 4], ah[2], al[2]);              // (g, t + 4)
          split_tf32(As[8 * p.sc + kk + 4], ah[3], al[3]);   // (g + 8, t + 4)
          // the n8 tiles' three products in turn, so that no mma waits on the one before it
          unsigned bh[kMbNB][2], bl[kMbNB][2];
#pragma unroll
          for (int j = 0; j < kMbNB; ++j) {
            if (n0 + 8 * j >= C0) break;  // the whole warp
            const float* Bs = ws + min(n0 + 8 * j + g8, C0 - 1) * p.sw + t4;  // W(n, k) at (k t, n g)
            split_tf32(Bs[kk], bh[j][0], bl[j][0]);
            split_tf32(Bs[kk + 4], bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int j = 0; j < kMbNB; ++j)
            if (n0 + 8 * j < C0) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < kMbNB; ++j)
            if (n0 + 8 * j < C0) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
          for (int j = 0; j < kMbNB; ++j)
            if (n0 + 8 * j < C0) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
        }
#pragma unroll
        for (int j = 0; j < kMbNB; ++j) {
          const int n = n0 + 8 * j + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g and g + 8
            const int r = m0 + g8 + 8 * h;
            if (r >= rows) continue;
            float* d = p.dx + (row0 + r) * C0;
            if (n + 1 < C0 && !(C0 & 1)) {
              *reinterpret_cast<float2*>(d + n) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
            } else {
              if (n < C0) d[n] = acc[j][2 * h];
              if (n + 1 < C0) d[n + 1] = acc[j][2 * h + 1];
            }
          }
        }
      }
    } else {
      const int lb = lane & (p.lb - 1), lr = lane / p.lb, LR = 32 / p.lb, CL4 = (CL + 3) & ~3;
      for (int s0 = 0; s0 < tr; s0 += nw * LR * kMbTM) {
        const int rb = s0 + warp * LR * kMbTM + lr;  // this thread's rows rb + LR * i
        for (int n0 = 0; n0 < C0; n0 += kMbTN * p.lb) {
          const float* wr[kMbTN];  // W's rows of this thread's outputs n0 + lb + p.lb * v
#pragma unroll
          for (int v = 0; v < kMbTN; ++v) wr[v] = ws + min(n0 + lb + p.lb * v, C0 - 1) * p.sw;
          float acc[kMbTM][kMbTN];
#pragma unroll
          for (int i = 0; i < kMbTM; ++i)
#pragma unroll
            for (int v = 0; v < kMbTN; ++v) acc[i][v] = 0.f;
          for (int j = 0; j < CL4; j += 4) {  // the cotangent's and W's columns past CL are 0
            float4 wv[kMbTN];
#pragma unroll
            for (int v = 0; v < kMbTN; ++v) wv[v] = *reinterpret_cast<const float4*>(wr[v] + j);
#pragma unroll
            for (int i = 0; i < kMbTM; ++i) {
              const float4 cv = *reinterpret_cast<const float4*>(cs + min(rb + LR * i, tr - 1) * p.sc + j);
#pragma unroll
              for (int v = 0; v < kMbTN; ++v) {
                acc[i][v] = fmaf(cv.x, wv[v].x, acc[i][v]);
                acc[i][v] = fmaf(cv.y, wv[v].y, acc[i][v]);
                acc[i][v] = fmaf(cv.z, wv[v].z, acc[i][v]);
                acc[i][v] = fmaf(cv.w, wv[v].w, acc[i][v]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kMbTM; ++i) {
            const int r = rb + LR * i;
            if (r >= rows) break;
            float* d = p.dx + (row0 + r) * C0;
#pragma unroll
            for (int v = 0; v < kMbTN; ++v)
              if (n0 + lb + p.lb * v < C0) d[n0 + lb + p.lb * v] = acc[i][v];
          }
        }
      }
    }
    // the next tile's recompute rewrites cs only past the barrier at the loop's top
  }
  cp_async_wait<0>();
}


// --- the max backward ------------------------------------------------------

struct MaxBwd1 {
  const int* am;   // [NG, CL] int32, each column's winning row
  const float* g;  // [NG, CL], dy * mul
  const float* w;  // [C0, CL] row-major
  float* dx;       // [NG, K, C0]
  size_t NG;
  int K, C0, CL;
  int lpg;  // lanes of a group: min(C0, 32), each a channel (and every lpg-th past it)
  int gpw;  // groups of a warp's job: 32 / lpg
  int nw;   // warps of a block
  int vec;  // K * C0 % 4 == 0 and dx 16-byte aligned: float4 stores
};

// Shared memory of a block: W^T, then each warp's (am, g) rows and dx rows.
__host__ __device__ inline size_t max1_warp_floats(const MaxBwd1& m) {
  return 2 * align16(sizeof(float) * (size_t)m.gpw * m.CL) / sizeof(float) +
         align16(sizeof(float) * (size_t)m.gpw * m.K * m.C0) / sizeof(float);
}

inline size_t max1_smem(const MaxBwd1& m) {
  return align16(sizeof(float) * (size_t)m.CL * m.C0) + sizeof(float) * m.nw * max1_warp_floats(m);
}

// 8 warps a block, halved while the block's shared memory would pass the
// card's limit (3 -> 300 wide at K = 33 takes 4).
inline MaxBwd1 max1_shape(size_t NG, int K, int C0, int CL) {
  MaxBwd1 m = {};
  m.NG = NG;
  m.K = K;
  m.C0 = C0;
  m.CL = CL;
  m.lpg = std::min(C0, 32);
  m.gpw = 32 / m.lpg;
  for (m.nw = kMbWarps; m.nw > 1 && max1_smem(m) > kMaxSmem; m.nw /= 2) {}
  return m;
}

// dx [NG, K, C0] of the one-layer max for g = dy * mul: dx[n, k, :] = sum
// over the columns c with am[n, c] = k, in ascending c, of g[n, c] W[:, c];
// 0 on a row that wins no column.  It reads no rows of x: a group's
// cotangent reaches its rows only through W.  A warp takes gpw groups at a
// time (3 at 9 wide: 27 lanes, one a (group, channel)), their am and g
// rows and a zeroed dx tile in its own shared memory, W^T once a block.
// Lane (j, i) walks group j's columns in ascending c and adds g W[i, c]
// into row am[c] of its tile, channel i (and i + 32, ... past 32 wide), so
// each output is one lane's sum in a fixed order: no atomics, two
// backwards bit-equal.  The warp's dx rows are contiguous and leave by
// coalesced (float4) stores.
__global__ void __launch_bounds__(kMbWarps * 32) group_max1_bwd_kernel(MaxBwd1 p, size_t jobs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = p.nw;
  const int K = p.K, C0 = p.C0, CL = p.CL, span = K * C0;
  float* wt = reinterpret_cast<float*>(smem);  // [CL][C0]
  float* mine = wt + align16(sizeof(float) * (size_t)CL * C0) / sizeof(float) + warp * max1_warp_floats(p);
  int* am_s = reinterpret_cast<int*>(mine);                                      // [gpw][CL]
  float* g_s = mine + align16(sizeof(float) * (size_t)p.gpw * CL) / sizeof(float);  // [gpw][CL]
  float* d_s = g_s + align16(sizeof(float) * (size_t)p.gpw * CL) / sizeof(float);   // [gpw][K][C0]

  for (int e = tid; e < C0 * CL; e += nw * 32) {
    const int i = e / CL;
    wt[(e - i * CL) * C0 + i] = p.w[e];
  }
  __syncthreads();

  const int j = lane / p.lpg, i0 = lane - j * p.lpg;  // this lane's group in a job and first channel
  for (size_t job = (size_t)blockIdx.x * nw + warp; job < jobs; job += (size_t)gridDim.x * nw) {
    const size_t n0 = job * p.gpw;
    const int ng = p.NG - n0 < (size_t)p.gpw ? (int)(p.NG - n0) : p.gpw;
    for (int e = lane; e < ng * CL; e += 32) {
      am_s[e] = p.am[n0 * CL + e];
      g_s[e] = p.g[n0 * CL + e];
    }
    for (int e = lane; e < ng * span; e += 32) d_s[e] = 0.f;
    __syncwarp();
    if (j < ng) {
      const int* a = am_s + j * CL;
      const float* gg = g_s + j * CL;
      float* d = d_s + j * span;
      for (int c = 0; c < CL; ++c) {
        const int k = a[c];
        if ((unsigned)k >= (unsigned)K) continue;  // no row of the group: the plain version drops it too
        const float gv = gg[c];
        float* dr = d + k * C0;
        const float* wr = wt + c * C0;
        for (int i = i0; i < C0; i += p.lpg) dr[i] = fmaf(gv, wr[i], dr[i]);
      }
    }
    __syncwarp();
    float* out = p.dx + n0 * span;
    if (p.vec) {
      for (int e = lane; e < ng * span / 4; e += 32)
        reinterpret_cast<float4*>(out)[e] = reinterpret_cast<const float4*>(d_s)[e];
    } else {
      for (int e = lane; e < ng * span; e += 32) out[e] = d_s[e];
    }
    __syncwarp();  // the next job's zeros overwrite d_s
  }
}

// ---------------------------------------------------------------------------
// The multi-layer max (PU-Net's set abstractions): the forward
// (group_mfwd_kernel) and the backward over the winning rows
// (group_mlists_kernel, group_mscan_kernel, group_mrows_kernel), the
// products on the tensor cores as 3xTF32 mma.sync
// ---------------------------------------------------------------------------

constexpr int kMxThreads = 256;              // 8 warps a block (16 where one block fills an SM)
constexpr int kMxNC = 128;                   // output columns of a chunk
constexpr int kMxKC = 32;                    // depth of a ring step
constexpr int kMxLDF = kMxNC + 8;            // a forward stage's row stride ([kMxKC][kMxNC]): 8 (mod 32)
constexpr int kMxLDT = kMxKC + 4;            // a transposed stage's ([kMxNC][kMxKC]) and the (am, g) rows': 4 (mod 32)
constexpr int kMxFwdStage = kMxKC * kMxLDF;  // floats of a forward stage
constexpr int kMxBwdStage = kMxNC * kMxLDT;  // floats of a transposed stage
constexpr int kMxProds = 2 * kMaxLayers;
constexpr int kMxMaxK = 64;

// A product's kind: the first layer on the CUDA cores (fewer than 8 inputs;
// no ring steps), a forward layer (W as the stage holds it, [depth][out]),
// a product back through W^T (W's rows are the outputs), or the last
// layer's one-hot cotangent through W_L^T (A from the (am, g) rows).
enum { kMxFma = 0, kMxFwd = 1, kMxTrans = 2, kMxOneHot = 3 };
// What its epilogue makes: a hidden activation, the group max, a
// cotangent through a mask and mul, or dx.
enum { kMxHidden = 0, kMxMax = 1, kMxCot = 2, kMxDx = 3 };

struct MxProd {
  const float* w;                       // W_l [C_l, C_l+1] row-major, as the layer holds it
  const float *b, *mean, *mul, *beta;   // forward: layer l's; backward: mul of layer l - 1 (the mask's), the rest unused
  int depth, width;                     // the product's depth and output columns
  int kind, out, layer;
  int vec;                              // W's rows by 16-byte copies
  int mword;                            // kMxCot: the first mask word of h_layer in a row's words
  int nchunk, nk;                       // chunks of kMxNC columns, ring steps a chunk
};

struct MxArgs {
  const float* x;   // [NG * K, C0]
  int NG, K, L, C0, CL;
  float slope;
  int T, stages, S, stage_floats, mwords, nprod, nsteps;
  int nt;           // threads a block
  MxProd prod[kMxProds];
  // forward
  float* y;                // [NG, CL]
  int* am_out;             // [NG, CL]
  float* hz[kMaxLayers];   // optional: hidden layer l's pre-activation [NG * K, C_l+1]
  // backward
  const int* am;           // [NG, CL]
  const float* g;          // [NG, CL], dy * mul_L
  int vecg;                // am and g rows by 16-byte copies
  const int* off;          // [NG + 1]
  const int* wrow;         // [NG, wc]
  int wc;
  float* dx;               // [NG * K, C0]
  unsigned* mask_out;      // optional: each listed row's mask words [total, mwords]
};

__host__ __device__ inline int mx_round8(int v) { return (v + 7) & ~7; }

// The BatchNorm of a pre-activation, each step rounded as written: the
// forward and the backward's recompute give the same bits.
__device__ __forceinline__ float mx_bn(float acc, float b, float mean, float mul, float beta) {
  return __fmaf_rn(__fsub_rn(__fadd_rn(acc, b), mean), mul, beta);
}

// (value, row) as one key whose unsigned order is the group max's: the
// value's bits made monotone (a -0 first made +0, so that the two tie as
// the float compare has them), then the row's complement, so that of
// equal values the lower row is the larger key.  The max of keys is the
// largest value at its lowest row, whatever the order of the merges; 0
// is below every key (a row past the tile's).
__device__ __forceinline__ unsigned long long mx_key(float v, int r) {
  unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)~r;
}

__device__ __forceinline__ float mx_key_value(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int mx_key_row(unsigned long long key) { return ~(int)(unsigned)key; }

__device__ __forceinline__ unsigned long long mx_max(unsigned long long a, unsigned long long b) { return a > b ? a : b; }

struct MxSmem {
  float* buf[2];     // activations and cotangents, [T][S] each
  float* ring;       // [stages][stage_floats]
  float* red;        // forward: [T / 16][kMxNC] values, then as many rows
  unsigned* masks;   // backward: [T][mwords]
  int *rbg, *rk, *rrow;  // backward: each tile row's group, k and row of x (-1 past the listed rows)
  MxProd* prod;
};

// The ring's cursors: the next step to put in flight (its product, chunk
// and depth step, and its stage) and the stage of the next step to
// consume, moved on a step at a time.
struct MxRing {
  int left;       // steps still to put in flight: every tile's (forward) or one tile's (rows stage)
  int p, ch, ks;  // the next step in flight
  int in, out;    // the stages of the next step in flight and of the next to consume
};

__device__ __forceinline__ MxSmem mx_carve(const MxArgs& a, unsigned char* smem, bool bwd) {
  MxSmem s;
  float* p = reinterpret_cast<float*>(smem);
  s.prod = reinterpret_cast<MxProd*>(p);
  p += align16(sizeof(MxProd) * kMxProds) / sizeof(float);
  s.buf[0] = p;
  p += align16(sizeof(float) * a.T * a.S) / sizeof(float);
  s.buf[1] = p;
  p += align16(sizeof(float) * a.T * a.S) / sizeof(float);
  s.ring = p;
  p += (size_t)a.stages * a.stage_floats;
  s.red = p;
  s.masks = reinterpret_cast<unsigned*>(p);
  if (!bwd) return s;
  p += align16(sizeof(unsigned) * a.T * a.mwords) / sizeof(float);
  s.rbg = reinterpret_cast<int*>(p);
  s.rk = s.rbg + a.T;
  s.rrow = s.rk + a.T;
  return s;
}

// The products' table into shared memory, each entry by its own constant
// index (an index known only at run time would put the kernel's argument
// in local memory).
__device__ __forceinline__ void mx_copy_prods(const MxArgs& a, MxProd* sp) {
#pragma unroll
  for (int i = 0; i < kMxProds; ++i)
    if ((int)threadIdx.x == i && i < a.nprod) sp[i] = a.prod[i];
}

// The copies of a ring step into the stage st: depth rows k0 .. k0 + 31 of
// product P's weights for the output columns c0 .. c0 + 127, 0 past its
// depth and width, and for the one-hot product each tile row's (am, g)
// entries of those depth columns, 0 past C_L and on rows past the list.
__device__ void mx_issue(const MxArgs& a, const MxSmem& sm, const MxProd& P, int c0, int k0, float* st) {
  const int tid = threadIdx.x;
  if (P.kind == kMxFwd) {  // W[k0 + kk][c0 + n] -> st[kk][n]
    if (P.vec) {
      for (int e = tid; e < kMxKC * kMxNC / 4; e += a.nt) {
        const int kk = e >> 5, q = e & 31, k = k0 + kk, c = c0 + 4 * q;
        const bool ok = k < P.depth && c < P.width;
        cp_async16(st + kk * kMxLDF + 4 * q, ok ? P.w + (size_t)k * P.width + c : P.w, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kMxKC * kMxNC; e += a.nt) {
        const int kk = e >> 7, n = e & 127, k = k0 + kk, c = c0 + n;
        const bool ok = k < P.depth && c < P.width;
        cp_async4(st + kk * kMxLDF + n, ok ? P.w + (size_t)k * P.width + c : P.w, ok ? 4 : 0);
      }
    }
    return;
  }
  // W[c0 + n][k0 + kk] (W's row c0 + n is output c0 + n of the product back) -> st[n][kk]
  if (P.vec) {
    for (int e = tid; e < kMxNC * kMxKC / 4; e += a.nt) {
      const int n = e >> 3, q = e & 7, i = c0 + n, j = k0 + 4 * q;
      const bool ok = i < P.width && j < P.depth;
      cp_async16(st + n * kMxLDT + 4 * q, ok ? P.w + (size_t)i * P.depth + j : P.w, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kMxNC * kMxKC; e += a.nt) {
      const int n = e >> 5, kk = e & 31, i = c0 + n, j = k0 + kk;
      const bool ok = i < P.width && j < P.depth;
      cp_async4(st + n * kMxLDT + kk, ok ? P.w + (size_t)i * P.depth + j : P.w, ok ? 4 : 0);
    }
  }
  if (P.kind != kMxOneHot) return;
  float* gs = st + kMxBwdStage;                               // [T][kMxLDT]
  int* as = reinterpret_cast<int*>(gs + a.T * kMxLDT);        // [T][kMxLDT]
  if (a.vecg) {
    for (int e = tid; e < a.T * kMxKC / 4; e += a.nt) {
      const int r = e >> 3, q = e & 7, bg = sm.rbg[r], c = k0 + 4 * q;
      const bool ok = bg >= 0 && c < a.CL;
      const size_t o = ok ? (size_t)bg * a.CL + c : 0;
      cp_async16(gs + r * kMxLDT + 4 * q, a.g + o, ok ? 16 : 0);
      cp_async16(as + r * kMxLDT + 4 * q, a.am + o, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < a.T * kMxKC; e += a.nt) {
      const int r = e >> 5, kk = e & 31, bg = sm.rbg[r], c = k0 + kk;
      const bool ok = bg >= 0 && c < a.CL;
      const size_t o = ok ? (size_t)bg * a.CL + c : 0;
      cp_async4(gs + r * kMxLDT + kk, a.g + o, ok ? 4 : 0);
      cp_async4(as + r * kMxLDT + kk, a.am + o, ok ? 4 : 0);
    }
  }
}

// Puts the ring's next step in flight, where one is left, and commits its
// group (an empty one past the last step, so that every step commits one).
// Past a tile's last product the cursor comes back to its first.
__device__ __forceinline__ void mx_push(const MxArgs& a, const MxSmem& sm, MxRing& rg) {
  if (rg.left > 0) {
    const MxProd& P = sm.prod[rg.p];
    mx_issue(a, sm, P, rg.ch * kMxNC, rg.ks * kMxKC, sm.ring + rg.in * a.stage_floats);
    --rg.left;
    rg.in = rg.in + 1 == a.stages ? 0 : rg.in + 1;
    if (++rg.ks == P.nk) {
      rg.ks = 0;
      if (++rg.ch == P.nchunk) {
        rg.ch = 0;
        do rg.p = rg.p + 1 == a.nprod ? 0 : rg.p + 1;
        while (sm.prod[rg.p].kind == kMxFma);
      }
    }
  }
  cp_async_commit();
}

// A ring of `steps` steps from the first product with any, its first
// stages - 1 steps put in flight (the caller's copies in flight join the
// first's group).
__device__ __forceinline__ void mx_prologue(const MxArgs& a, const MxSmem& sm, MxRing& rg, int steps) {
  rg = MxRing{steps, sm.prod[0].kind == kMxFma ? 1 : 0, 0, 0, 0, 0};
  for (int s = 0; s < a.stages - 1; ++s) mx_push(a, sm, rg);
}

// Waits for the ring's next step, then puts the step stages - 1 later in
// flight into the stage that the step before used; returns the step's
// stage.
__device__ __forceinline__ const float* mx_step(const MxArgs& a, const MxSmem& sm, MxRing& rg) {
  if (a.stages == 3) cp_async_wait<1>();
  else cp_async_wait<0>();
  __syncthreads();  // the step has landed for every thread, and every thread is done with the one before
  mx_push(a, sm, rg);
  const float* st = sm.ring + rg.out * a.stage_floats;
  rg.out = rg.out + 1 == a.stages ? 0 : rg.out + 1;
  return st;
}

// kn8 depth steps of 8 of one warp's job, MT row tiles of 16 x 4 column
// tiles of 8, rows wr * 16 * MT + [0, 16 * MT), columns wc * 32 + [0, 32):
// acc += A[rows][k0 + ...] B[k0 + ...][columns] as 3xTF32 (a = hi + lo,
// a b ~ lo hi + hi lo + hi hi, in that order on every accumulator).  A is
// the [T][S] buffer, or for the one-hot product the stage's (am, g) rows:
// A[r][c] = g[r][c] where am[r][c] is the row's k (kr), else 0.  B is the
// stage: [depth][column] (kMxFwd) or [column][depth].
template <int MT, int KIND>
__device__ __forceinline__ void mx_mma(const float* st, const float* A, int S, int T, int k0, int kn8, int wr, int wc,
                                       const int (&kr)[MT][2], float (&acc)[MT][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* gs = st + kMxBwdStage;
  const int* as = reinterpret_cast<const int*>(gs + T * kMxLDT);
  auto k8 = [&](int kk) {
    unsigned bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (KIND == kMxFwd) {
        const float* bp = st + (kk + t) * kMxLDF + wc * 32 + 8 * j + g;
        split_tf32(bp[0], bh[j][0], bl[j][0]);
        split_tf32(bp[4 * kMxLDF], bh[j][1], bl[j][1]);
      } else {
        const float* bp = st + (wc * 32 + 8 * j + g) * kMxLDT + kk + t;
        split_tf32(bp[0], bh[j][0], bl[j][0]);
        split_tf32(bp[4], bh[j][1], bl[j][1]);
      }
    }
    unsigned ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wr * 16 * MT + 16 * i + g;
      float av[4];
      if constexpr (KIND == kMxOneHot) {
        const int o = r * kMxLDT + kk + t;
        av[0] = as[o] == kr[i][0] ? gs[o] : 0.f;                                // (row g, k t)
        av[1] = as[o + 8 * kMxLDT] == kr[i][1] ? gs[o + 8 * kMxLDT] : 0.f;      // (g + 8, t)
        av[2] = as[o + 4] == kr[i][0] ? gs[o + 4] : 0.f;                        // (g, t + 4)
        av[3] = as[o + 8 * kMxLDT + 4] == kr[i][1] ? gs[o + 8 * kMxLDT + 4] : 0.f;
      } else {
        const float* ap = A + r * S + k0 + kk + t;
        av[0] = ap[0];
        av[1] = ap[8 * S];
        av[2] = ap[4];
        av[3] = ap[8 * S + 4];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) split_tf32(av[u], ah[i][u], al[i][u]);
    }
    // each product over every (i, j) tile in turn: an accumulator's next mma comes 4 MT mma later
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
  };
  if (kn8 == kMxKC / 8) {  // a whole step: its loads issue ahead of the products
#pragma unroll
    for (int kk = 0; kk < kMxKC; kk += 8) k8(kk);
  } else {
    for (int kk = 0; kk < 8 * kn8; kk += 8) k8(kk);
  }
}

// A tile's mask words of a hidden output h (width C, in buf [T][S]) from
// its signs: bit b of word wd of row r is h[r][32 wd + b] > 0, which holds
// exactly where the pre-activation is above 0.
__device__ __forceinline__ void mx_mask_pass(const MxArgs& a, const MxSmem& sm, const float* h, int C, int word0) {
  const int nw = (C + 31) >> 5;
  for (int e = threadIdx.x; e < a.T * nw; e += a.nt) {
    const int r = e / nw, wd = e - r * nw;
    const float* row = h + r * a.S + 32 * wd;
    const int n = min(32, C - 32 * wd);
    unsigned bits = 0;
    for (int b = 0; b < n; ++b) bits |= (row[b] > 0.f ? 1u : 0u) << b;
    sm.masks[r * a.mwords + word0 + wd] = bits;
  }
}

// Where an epilogue puts its output, the tile it serves, and what a
// product's first step starts besides its products.
struct MxOut {
  float* buf;        // kMxHidden, kMxCot: [T][S]
  int rows;          // forward: the tile's rows (whole groups)
  size_t g0;         // forward: its first group
  const float* mask_h;  // a hidden output whose mask words the product's first step writes (nullptr: none)
  int mask_c, mask_word;
  float* x_dst;      // forward: the buffer the next tile's rows go to (nullptr: none) ...
  size_t x_g0;       // ... its first group
  int x_rows;        // ... and its rows
};

// Rows [g0 K, g0 K + rows) of x into buf ([T][S]) by 4-byte copies in
// flight (a row of x is rarely 16-byte aligned; committed by the caller),
// 0 past them and in the pad columns.
__device__ void mx_load_x(const MxArgs& a, size_t g0, int rows, float* buf) {
  const float* xb = a.x + g0 * a.K * a.C0;
  for (int e = threadIdx.x; e < a.T * a.C0; e += a.nt) {
    const int r = e / a.C0, q = e - r * a.C0;
    cp_async4(buf + r * a.S + q, r < rows ? xb + e : a.x, r < rows ? 4 : 0);
  }
  const int pad = mx_round8(a.C0) - a.C0;
  for (int e = threadIdx.x; e < a.T * pad; e += a.nt) {
    const int r = e / pad;
    buf[r * a.S + a.C0 + (e - r * pad)] = 0.f;
  }
}

// The vectors v (of product P's b, mean, mul, beta: the bits 1, 2, 4, 8 of
// `which`) at a thread's 8 columns cb + 8 j + q of a chunk (entry 2 j +
// q), 0 from column `width` on: all loads issue before any is used, so
// that their latencies overlap.
__device__ __forceinline__ void mx_vec_load(const MxProd& P, int cb, int width, int which, float (&v)[4][8]) {
  const float* src[4] = {P.b, P.mean, P.mul, P.beta};
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int c = cb + 8 * (u >> 1) + (u & 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k][u] = (which >> k & 1) && c < width ? __ldg(src[k] + c) : 0.f;
  }
}

// The epilogue of one chunk (columns c0 .. c0 + 127) of product P from the
// warp's accumulators.  Every thread of the block calls it (the group max
// may hold a barrier); warps without a job (active false) add nothing.
template <int MT, bool kFwd>
__device__ __forceinline__ void mx_epilogue(const MxArgs& a, const MxSmem& sm, const MxProd& P, const MxOut& o,
                                            float (&acc)[MT][4][4], int c0, int wr, int wc, bool active) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, S = a.S;
  const int cb = c0 + wc * 32 + 2 * t;  // column of acc[.][j][q] is cb + 8 j + q
  if (P.out == kMxHidden) {
    if (!active) return;
    const int w8 = mx_round8(P.width);
    float* hz = a.hz[0];
#pragma unroll
    for (int l = 1; l < kMaxLayers; ++l)
      if (P.layer == l) hz = a.hz[l];
    float bn[4][8];
    mx_vec_load(P, cb, P.width, 15, bn);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = cb + 8 * j + q, u = 2 * j + q;
        if (c >= w8) continue;
        const bool ok = c < P.width;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wr * 16 * MT + 16 * i + 8 * h + g;
            const float z = mx_bn(acc[i][j][2 * h + q], bn[0][u], bn[1][u], bn[2][u], bn[3][u]);
            o.buf[r * S + c] = ok ? act_fwd(z, a.slope) : 0.f;
            if (hz && ok && r < o.rows) hz[(o.g0 * a.K + r) * P.width + c] = z;
          }
      }
    return;
  }
  if constexpr (!kFwd) {  // the rows stage: a cotangent or dx
    if (!active) return;
    const int w8 = mx_round8(P.width);
    float mul[4][8];
    if (P.out == kMxCot) mx_vec_load(P, cb, P.width, 4, mul);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = cb + 8 * j + q;
        if (P.out == kMxCot) {
          if (c >= w8) continue;
          const bool ok = c < P.width;
          const float mu = mul[2][2 * j + q];
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wr * 16 * MT + 16 * i + 8 * h + g;
              const bool m = (sm.masks[r * a.mwords + P.mword + (c >> 5)] >> (c & 31)) & 1u;
              const float dh = acc[i][j][2 * h + q];
              o.buf[r * S + c] = ok ? (m ? dh * mu : (a.slope == 0.f ? 0.f : (a.slope * dh) * mu)) : 0.f;
            }
        } else {
          if (c >= a.C0) continue;
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wr * 16 * MT + 16 * i + 8 * h + g, row = sm.rrow[r];
              if (row >= 0) a.dx[(size_t)row * a.C0 + c] = acc[i][j][2 * h + q];
            }
        }
      }
    return;
  } else {
  // the group max: BatchNorm, then the max key (mx_key) over each group's K
  // rows, first over the thread's own rows, then over the lanes, then,
  // where a group spans the warps of several row tiles, over those warps
  // in shared memory
  const int K = a.K, span = 16 * MT;
  unsigned long long* red = reinterpret_cast<unsigned long long*>(sm.red);  // [T / 16][kMxNC]
  float bn[4][8];
  mx_vec_load(P, cb, active ? a.CL : 0, 15, bn);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = cb + 8 * j + q, u = 2 * j + q;
      const bool ok = active && c < a.CL;
      unsigned long long kv[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr * 16 * MT + 16 * i + 8 * h + g;
          kv[i][h] = ok && r < o.rows ? mx_key(mx_bn(acc[i][j][2 * h + q], bn[0][u], bn[1][u], bn[2][u], bn[3][u]), r)
                                      : 0ull;
        }
      // rows r and r ^ d share a group where d < K: the thread's own rows first (h: d = 8; i: 16),
      // then the lanes' (d = 1, 2, 4), so that the shuffles carry one key where a group spans the slots
      if (8 < K) {
#pragma unroll
        for (int i = 0; i < MT; ++i) kv[i][0] = kv[i][1] = mx_max(kv[i][0], kv[i][1]);
      }
      if (MT == 2 && 16 < K) kv[0][0] = kv[0][1] = kv[1][0] = kv[1][1] = mx_max(kv[0][0], kv[MT - 1][0]);
      auto lanes = [&](unsigned long long& key) {  // over the lanes g whose rows share the group
#pragma unroll
        for (int d = 1; d < 8; d <<= 1)
          if (d < K) key = mx_max(key, __shfl_xor_sync(0xffffffffu, key, 4 * d));
      };
      if (K <= 8) {  // each slot its own group
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) lanes(kv[i][h]);
      } else if (K <= 16) {  // a group a row tile i
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          lanes(kv[i][0]);
          kv[i][1] = kv[i][0];
        }
      } else {  // one group over all the thread's rows
        lanes(kv[0][0]);
#pragma unroll
        for (int i = 0; i < MT; ++i) kv[i][0] = kv[i][1] = kv[0][0];
      }
      if (K <= span) {  // whole groups in the warp's rows: the thread with a group's first row writes it
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wr * 16 * MT + 16 * i + 8 * h + g;
            if (ok && r < o.rows && (r & (K - 1)) == 0) {
              const size_t gi = o.g0 + r / K;
              a.y[gi * a.CL + c] = mx_key_value(kv[i][h]);
              a.am_out[gi * a.CL + c] = mx_key_row(kv[i][h]) - (r / K) * K;
            }
          }
      } else if (ok && g == 0) {  // the warp's rows lie in one group: its partial
        red[wr * kMxNC + (c - c0)] = kv[0][0];
      }
    }
  if (K <= span) return;
  __syncthreads();
  const int per = K / span, ng = o.rows / K, nc = min(kMxNC, a.CL - c0);
  for (int e = threadIdx.x; e < ng * nc; e += a.nt) {
    const int s = e / nc, cc = e - s * nc;
    unsigned long long key = red[s * per * kMxNC + cc];
    for (int u = 1; u < per; ++u) key = mx_max(key, red[(s * per + u) * kMxNC + cc]);
    const size_t gi = o.g0 + s;
    a.y[gi * a.CL + c0 + cc] = mx_key_value(key);
    a.am_out[gi * a.CL + c0 + cc] = mx_key_row(key) - s * K;
  }
  // the next chunk writes red only past its first ring step's barrier
  }
}

// One chunk (columns c0 .. c0 + 127) of product P: its ring steps, each a
// barrier and MT row tiles of mma a warp, then the epilogue.  A chunk of w
// columns (32, 64 or 128) takes w / 32 column warps, the rest of the 8 the
// rows, MT row tiles of 16 each; warps past the rows idle.  The first step
// of a product's first chunk writes the mask words that o names.
template <int MT, int KIND, bool kFwd>
__device__ void mx_chunk(const MxArgs& a, const MxSmem& sm, const MxProd& P, int ch, MxRing& rg, const float* A,
                         const MxOut& o) {
  const int rem = P.width - ch * kMxNC, w = rem <= 32 ? 32 : rem <= 64 ? 64 : 128;
  const int ncw = w / 32, nrw = a.T / (16 * MT), warp = threadIdx.x >> 5;
  const bool active = warp < nrw * ncw;
  const int wr = warp % nrw, wc = warp / nrw, g = (threadIdx.x & 31) >> 2;
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;
  int kr[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) kr[i][h] = KIND == kMxOneHot && active ? sm.rk[wr * 16 * MT + 16 * i + 8 * h + g] : 0;
  const int depth8 = mx_round8(P.depth);
  for (int ks = 0; ks < P.nk; ++ks) {
    const float* st = mx_step(a, sm, rg);
    if (ks == 0 && o.mask_h) mx_mask_pass(a, sm, o.mask_h, o.mask_c, o.mask_word);
    if (ks == 0 && o.x_dst) {  // the next tile's rows, into the buffer this product leaves free
      mx_load_x(a, o.x_g0, o.x_rows, o.x_dst);
      cp_async_commit();
    }
    const int k0 = ks * kMxKC, kn8 = min(kMxKC, depth8 - k0) >> 3;
    if (active) mx_mma<MT, KIND>(st, A, a.S, a.T, k0, kn8, wr, wc, kr, acc);
  }
  // the mask words written at the first step are read by other warps in the
  // epilogue (the one-hot product's cotangent); a second step's barrier
  // orders them where there is one, this one where there is not
  if (o.mask_h && P.nk == 1) __syncthreads();
  mx_epilogue<MT, kFwd>(a, sm, P, o, acc, ch * kMxNC, wr, wc, active);
}

// Product P over all its chunks, each at the row tiles its width gives.
template <int KIND, bool kFwd>
__device__ void mx_prod(const MxArgs& a, const MxSmem& sm, const MxProd& P, MxRing& rg, const float* A, MxOut o) {
  for (int ch = 0; ch < P.nchunk; ++ch) {
    const int rem = P.width - ch * kMxNC, ncw = rem <= 32 ? 1 : rem <= 64 ? 2 : 4;
    if (a.T / (16 * ((a.nt >> 5) / ncw)) >= 2) mx_chunk<2, KIND, kFwd>(a, sm, P, ch, rg, A, o);
    else mx_chunk<1, KIND, kFwd>(a, sm, P, ch, rg, A, o);
    o.mask_h = nullptr;
    o.x_dst = nullptr;
  }
}

// The first layer on the CUDA cores (fewer than 8 inputs): z = fmaf over
// the inputs in ascending order from 0, then mx_bn; h_1 into O (0 in its
// pad columns), z into hz where asked.  A thread keeps one column's
// weights and BatchNorm in registers and walks the rows.
__device__ void mx_fma_layer(const MxArgs& a, const MxProd& P, const float* X, float* O, int rows, size_t g0) {
  const int w8 = mx_round8(P.width), rl = max(1, a.nt / w8);
  float* hz = a.hz[0];
  for (int e = threadIdx.x; e < w8 * rl; e += a.nt) {
    const int c = e % w8, r0 = e / w8;
    if (c >= P.width) {
      for (int r = r0; r < a.T; r += rl) O[r * a.S + c] = 0.f;
      continue;
    }
    float wv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) wv[k] = k < P.depth ? __ldg(P.w + (size_t)k * P.width + c) : 0.f;
    const float bb = __ldg(P.b + c), mm = __ldg(P.mean + c), mu = __ldg(P.mul + c), be = __ldg(P.beta + c);
    for (int r = r0; r < a.T; r += rl) {
      const float* xr = X + r * a.S;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < P.depth) acc = fmaf(xr[k], wv[k], acc);
      const float z = mx_bn(acc, bb, mm, mu, be);
      O[r * a.S + c] = act_fwd(z, a.slope);
      if (hz && r < rows) hz[(g0 * a.K + r) * P.width + c] = z;
    }
  }
}

// The hidden layers of a tile, the one function the forward and the
// backward's recompute share, so that the backward's masks are the
// forward's signs bit for bit: h_l+1 = act(mx_bn(h_l W_l)) for l < L - 1,
// from buf[xb] (the rows, 0 in the pad columns, landed for every thread
// where the caller says so) into the other buffer, then back, ...
// (kMasks: each h_l+1's mask words, written by the next product's first
// step).  Returns the mask pass of the last hidden output, for the product
// that follows.
template <bool kMasks>
__device__ MxOut mx_hidden(const MxArgs& a, const MxSmem& sm, MxRing& rg, int rows, size_t g0, int xb, bool landed) {
  MxOut o = {nullptr, rows, g0, nullptr, 0, 0, nullptr, 0, 0};
  for (int l = 0; l + 1 < a.L; ++l) {
    const MxProd& P = sm.prod[l];
    o.buf = sm.buf[(xb + l + 1) & 1];
    if (P.kind == kMxFma) {
      if (!landed) {
        cp_async_wait<0>();
        __syncthreads();  // the rows have landed for every thread
      }
      mx_fma_layer(a, P, sm.buf[xb], o.buf, rows, g0);
    } else {
      mx_prod<kMxFwd, !kMasks>(a, sm, P, rg, sm.buf[(xb + l) & 1], o);
    }
    o.mask_h = kMasks ? o.buf : nullptr;
    o.mask_c = P.width;
    o.mask_word = P.mword;
  }
  return o;
}

// The forward: resident blocks over tiles of T / K whole groups (T rows;
// a ragged last tile masks its missing groups).  The weights stream
// through the ring, which runs on from one tile to the next; the hidden
// layers (mx_hidden), then the last layer's chunks, each reduced to its
// groups' (max, lowest k) from the accumulators (mx_epilogue), while the
// next tile's rows come in behind them into the buffer the last layer
// leaves free.
__global__ void __launch_bounds__(2 * kMxThreads, 1) group_mfwd_kernel(MxArgs a, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MxSmem sm = mx_carve(a, smem, false);
  mx_copy_prods(a, sm.prod);
  const int gpt = a.T / a.K, L = a.L;
  auto tile_rows = [&](int tile) {
    const size_t g0 = (size_t)tile * gpt;
    return (size_t)a.NG - g0 < (size_t)gpt ? (int)((size_t)a.NG - g0) * a.K : gpt * a.K;
  };
  mx_load_x(a, (size_t)blockIdx.x * gpt, tile_rows(blockIdx.x), sm.buf[0]);
  __syncthreads();  // the products' table
  MxRing rg;
  mx_prologue(a, sm, rg, a.nsteps * ((ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x));
  // commit groups after the one with the tile's rows: the prologue's, or the last layer's steps after its first
  int after = a.stages - 2, xb = 0;
  const int last_steps = sm.prod[L - 1].nchunk * sm.prod[L - 1].nk;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if (after >= 2) cp_async_wait<2>();
    else if (after == 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // the tile's rows have landed for every thread, and the last tile is done
    const size_t g0 = (size_t)tile * gpt;
    const int rows = tile_rows(tile);
    MxOut o = mx_hidden<false>(a, sm, rg, rows, g0, xb, true);
    o.buf = nullptr;
    const int next = tile + gridDim.x;
    if (next < ntiles) {
      o.x_dst = sm.buf[(xb + L) & 1];
      o.x_g0 = (size_t)next * gpt;
      o.x_rows = tile_rows(next);
    }
    mx_prod<kMxFwd, true>(a, sm, sm.prod[L - 1], rg, sm.buf[(xb + L - 1) & 1], o);
    xb = (xb + L) & 1;
    after = last_steps - 1;
  }
  cp_async_wait<0>();
}

// The lists: a warp a group, whose winning rows (each the argmax of some
// column), ascending, then -1 up to wc, and their count.  A lane marks the
// rows its columns name in two words (K <= 64), the warp ORs them, and a
// winner's place is the count of winners below it: no atomics.
__global__ void __launch_bounds__(kMxThreads) group_mlists_kernel(const int* __restrict__ am, int NG, int K, int CL,
                                                                  int wc, int* __restrict__ counts,
                                                                  int* __restrict__ wrow) {
  const int lane = threadIdx.x & 31;
  const size_t bg = (size_t)blockIdx.x * (kMxThreads / 32) + (threadIdx.x >> 5);
  if (bg >= (size_t)NG) return;
  const int* a = am + bg * CL;
  unsigned lo = 0, hi = 0;
  for (int c = lane; c < CL; c += 32) {
    const int k = __ldg(a + c);
    if (k >= 0 && k < 32 && k < K) lo |= 1u << k;
    else if (k >= 32 && k < K) hi |= 1u << (k - 32);
  }
  lo = __reduce_or_sync(0xffffffffu, lo);
  hi = __reduce_or_sync(0xffffffffu, hi);
  const unsigned below = (1u << lane) - 1u;
  const int nlo = __popc(lo), n = nlo + __popc(hi);
  int* out = wrow + bg * wc;
  if ((lo >> lane) & 1u) out[__popc(lo & below)] = lane;
  if ((hi >> lane) & 1u) out[nlo + __popc(hi & below)] = 32 + lane;
  for (int i = n + lane; i < wc; i += 32) out[i] = -1;
  if (lane == 0) counts[bg] = n;
}

// off[i] = the winners of the groups before group i, off[NG] all of them:
// one block, each thread a run of groups.
__global__ void __launch_bounds__(1024) group_mscan_kernel(const int* __restrict__ counts, int NG,
                                                           int* __restrict__ off) {
  __shared__ int ws[32];
  const int total = block_scan(NG, [&](int i) { return __ldg(counts + i); }, [&](int i, int p) { off[i] = p; }, ws);
  if (threadIdx.x == 0) off[NG] = total;
}

// The rows stage: resident blocks over tiles of T listed rows (in the
// lists' order: groups ascending, rows ascending in each).  A tile's rows
// come in by 4-byte copies; the hidden layers again (mx_hidden, with their
// mask words); the one-hot cotangent of the last layer (g where the row is
// its column's argmax) through W_L^T, dense over the listed rows; then
// back through the masks and mul factors, W_l^T read as W is stored; each
// listed row's dx written once (every other row's is the memset's 0).
__global__ void __launch_bounds__(2 * kMxThreads, 1) group_mrows_kernel(MxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MxSmem sm = mx_carve(a, smem, true);
  mx_copy_prods(a, sm.prod);
  const int L = a.L, total = __ldg(a.off + a.NG), ntiles = (total + a.T - 1) / a.T;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the table (first tile); every buffer free (later tiles)
    for (int r = threadIdx.x; r < a.T; r += a.nt) {
      const int p = tile * a.T + r;
      int bg = -1, k = -1, row = -1;
      if (p < total) {
        int lo = 0, hi = a.NG - 1;  // the last group with off <= p
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (__ldg(a.off + mid) <= p) lo = mid;
          else hi = mid - 1;
        }
        bg = lo;
        k = __ldg(a.wrow + (size_t)lo * a.wc + (p - __ldg(a.off + lo)));
        row = lo * a.K + k;
      }
      sm.rbg[r] = bg;
      sm.rk[r] = k;
      sm.rrow[r] = row;
    }
    __syncthreads();
    if (L > 1) {  // the rows (the one-layer backward reads none)
      for (int e = threadIdx.x; e < a.T * a.C0; e += a.nt) {
        const int r = e / a.C0, q = e - r * a.C0, row = sm.rrow[r];
        cp_async4(sm.buf[0] + r * a.S + q, row >= 0 ? a.x + (size_t)row * a.C0 + q : a.x, row >= 0 ? 4 : 0);
      }
      const int pad = mx_round8(a.C0) - a.C0;
      for (int e = threadIdx.x; e < a.T * pad; e += a.nt) {
        const int r = e / pad;
        sm.buf[0][r * a.S + a.C0 + (e - r * pad)] = 0.f;
      }
    }
    MxRing rg;  // again for each tile: the one-hot steps read the tile's lists
    mx_prologue(a, sm, rg, a.nsteps);
    MxOut o = mx_hidden<true>(a, sm, rg, a.T, 0, 0, false);
    o.buf = sm.buf[L & 1];  // not the buffer of h_L-1, whose mask words the first step writes
    mx_prod<kMxOneHot, false>(a, sm, sm.prod[L - 1], rg, nullptr, o);
    o.mask_h = nullptr;
    for (int l = L - 2, q = L & 1; l >= 0; --l, q ^= 1) {
      o.buf = sm.buf[q ^ 1];
      mx_prod<kMxTrans, false>(a, sm, sm.prod[2 * L - 2 - l], rg, sm.buf[q], o);
    }
    if (a.mask_out) {
      __syncthreads();
      for (int e = threadIdx.x; e < a.T * a.mwords; e += a.nt)
        if (tile * a.T + e / a.mwords < total) a.mask_out[(size_t)tile * a.T * a.mwords + e] = sm.masks[e];
    }
  }
  cp_async_wait<0>();
}

// The tile and ring of the forward (bwd 0) or the rows stage (bwd 1): 128
// rows where no product is wider than 64 (PU-Net's sa0), else 64, with 3
// ring stages, then 2, where two blocks of 8 warps fit an SM's shared
// memory; else 64 rows in one block of 16 warps; else 32 rows (the
// forward's T holds whole groups).  The weights stream through L2 once a tile, so the
// taller tile costs less traffic (PU-Net's sa3: 1.05 MB a tile, 2.2 GB a
// forward at 64 rows); a second block on the SM works while the first
// waits on its ring, and two blocks of 64 rows hold as many rows as one of
// 128 with twice the warps.  A block's 8 warps take 16 or 32 rows x 32
// columns each of a 128-column chunk (MT = 1 or 2 row tiles), so the
// kernels keep to 128 registers.
struct MxPlan {
  int T, stages, S, mwords, stage_floats, nt;
  size_t smem;
};

bool mx_plan(int L, const int* dims, int K, int bwd, MxPlan& p) {
  if (L < 1 || L > kMaxLayers || K < 1 || K > kMxMaxK || (K & (K - 1))) return false;
  for (int l = 0; l <= L; ++l)
    if (dims[l] < 1) return false;
  int maxw = 8;  // the rows' and hidden layers' widths, each padded to 8
  for (int l = 0; l < L; ++l) maxw = std::max(maxw, mx_round8(dims[l]));
  p.S = maxw + 4;  // 4 (mod 8): an A fragment's 8 rows x 4 columns in distinct banks
  p.mwords = 0;
  if (bwd)
    for (int l = 1; l < L; ++l) p.mwords += (dims[l] + 31) / 32;
  constexpr size_t kTwo = 233472 / 2 - 1024;  // a block's share when two share an SM (228 KB, 1 KB each reserved)
  // (T, stages, two blocks an SM): two blocks take 8 warps each, one 16
  static const int cand[8][3] = {{128, 3, 1}, {128, 2, 1}, {64, 3, 1}, {64, 2, 1},
                                 {64, 3, 0}, {64, 2, 0}, {32, 3, 0}, {32, 2, 0}};
  int widest = 0;  // the widest product output: at 128 rows 8 warps keep to 2 row tiles up to 64
  for (int l = bwd ? 0 : 1; l <= L; ++l) widest = std::max(widest, dims[l]);
  for (const auto& c : cand) {
    const int T = c[0], st = c[1];
    if (T == 128 && widest > 64) continue;
    if (!bwd && T < K) continue;
    const int stage = bwd ? std::max(L > 1 ? kMxFwdStage : 0, kMxBwdStage) + 2 * T * kMxLDT : kMxFwdStage;
    const size_t smem = align16(sizeof(MxProd) * kMxProds) + 2 * align16(sizeof(float) * T * p.S) +
                        sizeof(float) * (size_t)st * stage +
                        (bwd ? align16(sizeof(unsigned) * T * p.mwords) + 3 * sizeof(int) * T
                             : sizeof(float) * (T / 16) * kMxNC * 2);
    if (smem <= (c[2] ? kTwo : kMaxSmem)) {
      p.T = T;
      p.nt = c[2] || T < 64 ? kMxThreads : 2 * kMxThreads;  // one block an SM: 16 warps
      p.stages = st;
      p.stage_floats = stage;
      p.smem = smem;
      return true;
    }
  }
  return false;
}

// The products of the forward (the L layers) or of the rows stage (the
// hidden layers, the last layer's one-hot product back, the products back
// through the others), each with its ring steps; returns the steps.
int mx_prods(int L, const int* dims, const void* const* params, int bwd, MxArgs& a) {
  auto W = [&](int l) { return static_cast<const float*>(params[5 * l]); };
  auto V = [&](int l, int v) { return static_cast<const float*>(params[5 * l + v]); };
  auto vec = [&](int l) { return dims[l + 1] % 4 == 0 && (reinterpret_cast<size_t>(W(l)) & 15) == 0; };
  int moff[kMaxLayers + 1] = {};  // the first mask word of h_l, l >= 1
  for (int l = 2; l < L; ++l) moff[l] = moff[l - 1] + (dims[l - 1] + 31) / 32;
  int n = 0, steps = 0;
  auto add = [&](MxProd P) {
    P.nchunk = (P.width + kMxNC - 1) / kMxNC;
    P.nk = P.kind == kMxFma ? 0 : (mx_round8(P.depth) + kMxKC - 1) / kMxKC;
    steps += P.nchunk * P.nk;
    a.prod[n++] = P;
  };
  for (int l = 0; l < (bwd ? L - 1 : L); ++l) {
    MxProd P = {};
    P.w = W(l);
    P.b = V(l, 1);
    P.mean = V(l, 2);
    P.mul = V(l, 3);
    P.beta = V(l, 4);
    P.depth = dims[l];
    P.width = dims[l + 1];
    P.layer = l;
    P.kind = l == 0 && l < L - 1 && dims[0] < 8 ? kMxFma : kMxFwd;
    P.out = l < L - 1 ? kMxHidden : kMxMax;
    P.vec = vec(l);
    P.mword = l < L - 1 ? moff[l + 1] : 0;
    add(P);
  }
  for (int l = L - 1; bwd && l >= 0; --l) {
    MxProd P = {};
    P.w = W(l);
    P.mul = l > 0 ? V(l - 1, 3) : nullptr;
    P.depth = dims[l + 1];
    P.width = dims[l];
    P.layer = l;
    P.kind = l == L - 1 ? kMxOneHot : kMxTrans;
    P.out = l > 0 ? kMxCot : kMxDx;
    P.vec = vec(l);
    P.mword = l > 0 ? moff[l] : 0;
    add(P);
  }
  a.nprod = n;
  return steps;
}

cudaError_t mx_setup(int device, const void* x, int B, int G, int K, int L, const int* dims,
                     const void* const* params, float slope, int bwd, MxArgs& a, MxPlan& pl) {
  if (B < 1 || G < 1 || (long long)B * G >= INT_MAX / kMxMaxK || !(slope >= 0.f && slope <= 1.f) ||
      !mx_plan(L, dims, K, bwd, pl))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  a = MxArgs{};
  a.x = static_cast<const float*>(x);
  a.NG = B * G;
  a.K = K;
  a.L = L;
  a.C0 = dims[0];
  a.CL = dims[L];
  a.slope = slope;
  a.T = pl.T;
  a.stages = pl.stages;
  a.S = pl.S;
  a.stage_floats = pl.stage_floats;
  a.mwords = pl.mwords;
  a.nt = pl.nt;
  a.nsteps = mx_prods(L, dims, params, bwd, a);
  return cudaSuccess;
}

int check_group(int B, int G, int K, int L, const int* dims, float slope, int tm, int bwd) {
  if (B < 1 || B > 65535 || G < 1 || K < 1 || K > 8 * tm) return 1;
  if (L < 1 || L > kMaxLayers || !(slope >= 0.f && slope <= 1.f)) return 1;
  if (tm != 8 && tm != 4 && tm != 2) return 1;
  for (int l = 0; l <= L; ++l)
    if (dims[l] < 1) return 1;
  if (group_smem(L, dims, K, tm, bwd) > kMaxSmem) return 1;
  return 0;
}

template <int TM, bool kMean>
cudaError_t launch_fwd(const float* x, int B, int G, int K, const Chain& ch, float* y, int* am,
                       size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(group_fwd_kernel<TM, kMean>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int gpb = (8 * TM) / K;
  const dim3 grid((G + gpb - 1) / gpb, B);
  group_fwd_kernel<TM, kMean><<<grid, kThreads, smem, s>>>(x, G, K, gpb, ch, y, am);
  return cudaGetLastError();
}

template <int TM, bool kMean>
cudaError_t launch_bwd(const float* x, int B, int G, int K, const Chain& ch, const int* am,
                       const float* g, float* dx, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(group_bwd_kernel<TM, kMean>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int gpb = (8 * TM) / K;
  const dim3 grid((G + gpb - 1) / gpb, B);
  group_bwd_kernel<TM, kMean><<<grid, kThreads, smem, s>>>(x, G, K, gpb, ch, am, g, dx);
  return cudaGetLastError();
}

template <bool kMean>
cudaError_t dispatch_fwd(int tm, const float* x, int B, int G, int K, const Chain& ch, float* y,
                         int* am, size_t smem, cudaStream_t s) {
  switch (tm) {
    case 8: return launch_fwd<8, kMean>(x, B, G, K, ch, y, am, smem, s);
    case 4: return launch_fwd<4, kMean>(x, B, G, K, ch, y, am, smem, s);
    default: return launch_fwd<2, kMean>(x, B, G, K, ch, y, am, smem, s);
  }
}

template <bool kMean>
cudaError_t dispatch_bwd(int tm, const float* x, int B, int G, int K, const Chain& ch,
                         const int* am, const float* g, float* dx, size_t smem, cudaStream_t s) {
  switch (tm) {
    case 8: return launch_bwd<8, kMean>(x, B, G, K, ch, am, g, dx, smem, s);
    case 4: return launch_bwd<4, kMean>(x, B, G, K, ch, am, g, dx, smem, s);
    default: return launch_bwd<2, kMean>(x, B, G, K, ch, am, g, dx, smem, s);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at TM = tm; the caller picks the
// largest tm with 8 * tm >= K whose need is at most pca_chain_max_smem().
size_t pca_group_smem(int L, const int* dims, int K, int tm, int bwd) {
  return group_smem(L, dims, K, tm, bwd);
}

// device: the CUDA device index of every pointer and the stream.
// x [B, G, K, dims[0]] f32 with 1 <= K <= 8 * tm; params: 5 device pointers
// per layer as in pca_chain_fwd; slope in [0, 1]; mean: 0 max pool (y and
// am written), 1 mean pool (y written, am unused).  y / am [B, G, dims[L]].
// Returns a cudaError_t code (0 on success).
int pca_group_fwd(int device, const void* x, int B, int G, int K, int L, const int* dims,
                  const void* const* params, float slope, int mean, void* y, void* am, int tm,
                  void* stream) {
  if (check_group(B, G, K, L, dims, slope, tm, 0)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Chain ch = make_chain(L, dims, params, nullptr);
  ch.slope = slope;
  const size_t smem = group_smem(L, dims, K, tm, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  int* ai = static_cast<int*>(am);
  e = mean ? dispatch_fwd<true>(tm, xf, B, G, K, ch, yf, ai, smem, s)
           : dispatch_fwd<false>(tm, xf, B, G, K, ch, yf, ai, smem, s);
  return (int)e;
}

// x, dims, params, slope, mean as in pca_group_fwd; wts: per layer W_l
// transposed, [dims[l+1], dims[l]] row-major; am int32 [B, G, dims[L]]
// (max; unused for mean); g [B, G, dims[L]]: dy * mul_L (max) or
// dy * mul_L / K (mean).  dx [B, G, K, dims[0]].  Returns a cudaError_t code.
int pca_group_bwd(int device, const void* x, int B, int G, int K, int L, const int* dims,
                  const void* const* params, const void* const* wts, float slope, int mean,
                  const void* am, const void* g, void* dx, int tm, void* stream) {
  if (check_group(B, G, K, L, dims, slope, tm, 1)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  Chain ch = make_chain(L, dims, params, wts);
  ch.slope = slope;
  const size_t smem = group_smem(L, dims, K, tm, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* ai = static_cast<const int*>(am);
  const float* gf = static_cast<const float*>(g);
  float* d = static_cast<float*>(dx);
  e = mean ? dispatch_bwd<true>(tm, xf, B, G, K, ch, ai, gf, d, smem, s)
           : dispatch_bwd<false>(tm, xf, B, G, K, ch, ai, gf, d, smem, s);
  return (int)e;
}

// Dynamic shared memory of the one-layer mean backward's block at (K, C0,
// CL); the caller holds it to pca_chain_max_smem().
size_t pca_group_mean1_smem(int K, int C0, int CL) {
  if (K < 1 || C0 < 1 || CL < 1) return 0;
  return mean1_smem(mean1_shape(1, K, C0, CL));
}

// The one-layer mean's input gradient: x [B, G, K, C0] f32; params: 5
// device pointers (W [C0, CL] row-major, b, mean, mul, beta [CL]); slope in
// [0, 1]; g [B, G, CL] = dy * mul / K; dx [B, G, K, C0].  Returns a
// cudaError_t code (0 on success).
int pca_group_mean1_bwd(int device, const void* x, int B, int G, int K, int C0, int CL,
                        const void* const* params, float slope, const void* g, void* dx, int tc, void* stream) {
  if (B < 1 || G < 1 || K < 1 || C0 < 1 || CL < 1 || !(slope >= 0.f && slope <= 1.f))
    return (int)cudaErrorInvalidValue;
  MeanBwd m = mean1_shape((size_t)B * G * K, K, C0, CL);
  const size_t smem = mean1_smem(m);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  m.x = static_cast<const float*>(x);
  m.w = static_cast<const float*>(params[0]);
  for (int v = 0; v < 4; ++v) m.vecs[v] = static_cast<const float*>(params[1 + v]);
  m.g = static_cast<const float*>(g);
  m.dx = static_cast<float*>(dx);
  m.vec = C0 % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  m.slope = slope;
  const void* kernel = tc ? reinterpret_cast<const void*>(group_mean1_bwd_kernel<true>)
                          : reinterpret_cast<const void*>(group_mean1_bwd_kernel<false>);
  int slots = 0;
  e = resident_slots(kernel, kMbWarps * 32, smem, kMaxSmem, device, &slots);
  if (e != cudaSuccess) return (int)e;
  const size_t tiles = (m.R + m.tr - 1) / m.tr;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < (size_t)slots ? tiles : (size_t)slots);
  if (tc)
    group_mean1_bwd_kernel<true><<<grid, kMbWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(m, (int)tiles);
  else
    group_mean1_bwd_kernel<false><<<grid, kMbWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(m, (int)tiles);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the one-layer forward's block at (K, C0, CL);
// the caller holds it to pca_chain_max_smem() (past it, group_fwd_kernel
// serves the shape).
size_t pca_group_fwd1_smem(int K, int C0, int CL) {
  if (K < 1 || C0 < 1 || CL < 1) return 0;
  return fwd1_smem(fwd1_shape(1u << 30, K, C0, CL));
}

// The one-layer forward: x [B, G, K, C0] f32; params: 5 device pointers (W
// [C0, CL] row-major, b, mean, mul, beta [CL]); slope in [0, 1]; mean: 0
// max pool (y and am written), 1 mean pool (y written, am unused); y / am
// [B, G, CL].  Returns a cudaError_t code (0 on success).
int pca_group_fwd1(int device, const void* x, int B, int G, int K, int C0, int CL, const void* const* params,
                   float slope, int mean, void* y, void* am, void* stream) {
  if (B < 1 || G < 1 || K < 1 || C0 < 1 || CL < 1 || !(slope >= 0.f && slope <= 1.f))
    return (int)cudaErrorInvalidValue;
  Fwd1 p = fwd1_shape((size_t)B * G, K, C0, CL);
  const size_t smem = fwd1_smem(p);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(params[0]);
  for (int v = 0; v < 4; ++v) p.vecs[v] = static_cast<const float*>(params[1 + v]);
  p.y = static_cast<float*>(y);
  p.am = static_cast<int*>(am);
  p.vec = C0 % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;
  p.slope = slope;
  const void* kernel = mean ? reinterpret_cast<const void*>(group_fwd1_kernel<true>)
                            : reinterpret_cast<const void*>(group_fwd1_kernel<false>);
  int slots = 0;
  e = resident_slots(kernel, p.nw * 32, smem, kMaxSmem, device, &slots);
  if (e != cudaSuccess) return (int)e;
  const size_t tiles = (p.NG + p.gpt - 1) / p.gpt;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < (size_t)slots ? tiles : (size_t)slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mean)
    group_fwd1_kernel<true><<<grid, p.nw * 32, smem, s>>>(p, (int)tiles);
  else
    group_fwd1_kernel<false><<<grid, p.nw * 32, smem, s>>>(p, (int)tiles);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the one-layer max backward's block at (K, C0,
// CL); the caller holds it to pca_chain_max_smem() (past it,
// group_bwd_kernel serves the shape).
size_t pca_group_max1_smem(int K, int C0, int CL) {
  if (K < 1 || C0 < 1 || CL < 1) return 0;
  return max1_smem(max1_shape(1, K, C0, CL));
}

// The one-layer max's input gradient: am int32 and g = dy * mul [B, G, CL];
// w: W [C0, CL] row-major; dx [B, G, K, C0].  Returns a cudaError_t code.
int pca_group_max1_bwd(int device, const void* am, const void* g, int B, int G, int K, int C0, int CL, const void* w,
                       void* dx, void* stream) {
  if (B < 1 || G < 1 || K < 1 || C0 < 1 || CL < 1) return (int)cudaErrorInvalidValue;
  MaxBwd1 m = max1_shape((size_t)B * G, K, C0, CL);
  const size_t smem = max1_smem(m);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  m.am = static_cast<const int*>(am);
  m.g = static_cast<const float*>(g);
  m.w = static_cast<const float*>(w);
  m.dx = static_cast<float*>(dx);
  m.vec = (K * C0) % 4 == 0 && (reinterpret_cast<size_t>(dx) & 15) == 0;
  int slots = 0;
  e = resident_slots(reinterpret_cast<const void*>(group_max1_bwd_kernel), m.nw * 32, smem, kMaxSmem, device, &slots);
  if (e != cudaSuccess) return (int)e;
  const size_t jobs = (m.NG + m.gpw - 1) / m.gpw, blocks = (jobs + m.nw - 1) / m.nw;
  const unsigned grid = (unsigned)(blocks < (size_t)slots ? blocks : (size_t)slots);
  group_max1_bwd_kernel<<<grid, m.nw * 32, smem, static_cast<cudaStream_t>(stream)>>>(m, jobs);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one block of the multi-layer max's forward (bwd 0)
// or rows stage (bwd 1) takes at (L, dims, K), and its tile rows and ring
// stages (where tile and stages are not null); 0 for a shape they do not
// take (K not a power of two up to 64, or no tile fits a block).
size_t pca_group_mmax_plan(int L, const int* dims, int K, int bwd, int* tile, int* stages) {
  MxPlan p;
  if (!mx_plan(L, dims, K, bwd, p)) return 0;
  if (tile) *tile = p.T;
  if (stages) *stages = p.stages;
  return p.smem;
}

// The multi-layer max forward on the tensor cores: x [B, G, K, dims[0]]
// f32, params as pca_group_fwd, slope in [0, 1]; y and am [B, G, dims[L]];
// hz: L - 1 pointers or null, each null or hidden layer l's pre-activation
// [B * G * K, dims[l + 1]] (the check of the backward's masks reads them).
// Returns a cudaError_t code.
int pca_group_mmax_fwd(int device, const void* x, int B, int G, int K, int L, const int* dims,
                       const void* const* params, float slope, void* y, void* am, void* const* hz, void* stream) {
  MxArgs a;
  MxPlan pl;
  cudaError_t e = mx_setup(device, x, B, G, K, L, dims, params, slope, 0, a, pl);
  if (e != cudaSuccess) return (int)e;
  a.y = static_cast<float*>(y);
  a.am_out = static_cast<int*>(am);
  for (int l = 0; hz && l + 1 < L; ++l) a.hz[l] = static_cast<float*>(hz[l]);
  int slots = 0;
  e = resident_slots(reinterpret_cast<const void*>(group_mfwd_kernel), pl.nt, pl.smem, kMaxSmem, device, &slots);
  if (e != cudaSuccess) return (int)e;
  const size_t gpt = pl.T / K, tiles = ((size_t)a.NG + gpt - 1) / gpt;
  if (tiles * a.nsteps > (size_t)INT_MAX) return (int)cudaErrorInvalidValue;
  group_mfwd_kernel<<<(unsigned)std::min(tiles, (size_t)slots), pl.nt, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      a, (int)tiles);
  return (int)cudaGetLastError();
}

// The lists of the multi-layer max's backward from am int32 [B * G, CL]
// (each entry a row in [0, K)): counts int32 [B * G] scratch; off [B * G +
// 1] the winners before each group, then all of them; wrow [B * G, min(K,
// CL)] each group's winning rows ascending, then -1.  Returns a
// cudaError_t code.
int pca_group_mmax_lists(int device, const void* am, int B, int G, int K, int CL, void* counts, void* off,
                         void* wrow, void* stream) {
  if (B < 1 || G < 1 || K < 1 || K > kMxMaxK || CL < 1 || (long long)B * G * CL >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NG = B * G, per = kMxThreads / 32;
  group_mlists_kernel<<<(NG + per - 1) / per, kMxThreads, 0, s>>>(static_cast<const int*>(am), NG, K, CL,
                                                                  std::min(K, CL), static_cast<int*>(counts),
                                                                  static_cast<int*>(wrow));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  group_mscan_kernel<<<1, 1024, 0, s>>>(static_cast<const int*>(counts), NG, static_cast<int*>(off));
  return (int)cudaGetLastError();
}

// dx [B, G, K, dims[0]] of the multi-layer max for g = dy * mul_L [B, G,
// dims[L]], over the winning rows of pca_group_mmax_lists' off and wrow:
// x, params, slope as pca_group_mmax_fwd, am int32 [B, G, dims[L]];
// mask_out null or [off[B * G], mask words a row] (the check of the masks).
// Returns a cudaError_t code.
int pca_group_mmax_rows(int device, const void* x, int B, int G, int K, int L, const int* dims,
                        const void* const* params, float slope, const void* am, const void* g, const void* off,
                        const void* wrow, void* dx, void* mask_out, void* stream) {
  MxArgs a;
  MxPlan pl;
  cudaError_t e = mx_setup(device, x, B, G, K, L, dims, params, slope, 1, a, pl);
  if (e != cudaSuccess) return (int)e;
  a.am = static_cast<const int*>(am);
  a.g = static_cast<const float*>(g);
  a.vecg = a.CL % 4 == 0 && ((reinterpret_cast<size_t>(am) | reinterpret_cast<size_t>(g)) & 15) == 0;
  a.off = static_cast<const int*>(off);
  a.wrow = static_cast<const int*>(wrow);
  a.wc = std::min(K, a.CL);
  a.dx = static_cast<float*>(dx);
  a.mask_out = static_cast<unsigned*>(mask_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(dx, 0, sizeof(float) * (size_t)a.NG * K * a.C0, s);
  if (e != cudaSuccess) return (int)e;
  int slots = 0;
  e = resident_slots(reinterpret_cast<const void*>(group_mrows_kernel), pl.nt, pl.smem, kMaxSmem, device, &slots);
  if (e != cudaSuccess) return (int)e;
  const size_t tiles = ((size_t)a.NG * a.wc + pl.T - 1) / pl.T;  // at most
  group_mrows_kernel<<<(unsigned)std::min(tiles, (size_t)slots), pl.nt, pl.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
