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
// What the design does about it.
//   * Two or more layers (and a one-layer shape whose block below would need
//     more shared memory than the card has) run group_fwd_kernel and
//     group_bwd_kernel.  The rows of a group are contiguous, so a block takes
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

}  // extern "C"
