// Fused per-point Dense -> eval-BatchNorm (-> ReLU) chain with a max and a
// first-index argmax over the points, and its input gradient, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// pointcloudattack_tpu_torch/ops/chain_maxpool.py.
//
// Replaces the TPU kernels of pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:
//   forward  _chain_fwd_pallas (pallas_call at :188, body _chain_fwd_kernel)
//   backward _chain_bwd_pallas (pallas_call at :216, body _chain_bwd_kernel)
// both reached through mlp_chain_maxpool.  For x [B, N, C0] and layers
// (w [C_l, C_l+1], b, mean, mul, beta) it computes, per point,
//   z_l = (h_l @ w_l + b_l - mean_l) * mul_l + beta_l,  h_l+1 = relu(z_l)
// (no ReLU after the last layer), then y[b, c] = max_n z_L[b, n, c] and
// idx[b, c] = the lowest n attaining it.  The backward takes
// g = dy * mul_L and returns dx [B, N, C0].
//
// What bounds it on this card.  At PointNet's spine (B=64, N=1024, chain
// 3 -> 64 -> 128 -> 1024) one forward is 2 * 65,536 * (3*64 + 64*128 +
// 128*1024) ~= 18.3 GFLOP, 94% of it in the 128 -> 1024 layer, against
// 0.8 MB of input and 0.5 MB of output: it is bound by f32 FMA issue, not
// by memory.  The unfused version writes and reads back a [B, N, 1024] f32
// map (268 MB) per spine; this kernel writes none.  The backward is about
// 1.1 GFLOP of recompute plus a sparse expansion: each output column has
// exactly one winning row.
//
// What the design does about it.
//   * Exact f32 FMA on the CUDA cores (no TF32, no bf16): the TPU kernel's
//     bf16 operand truncation was that chip's default matmul precision,
//     not the function's meaning.
//   * A block owns one row tile (T = 8 * TM points) of one cloud and runs
//     the whole chain on it.  Activations stay in shared memory, stored
//     transposed ([C][T]) so that a warp reads its TM rows as one
//     broadcast vector load.  Weights stream through a shared tile of
//     kKTile x (32 * TN) columns; every block reads the same weights, which
//     stay in L2.  Each thread keeps a TM x TN register tile of
//     accumulators, TN = 8, 4 or 2 by the layer's width, so the narrow
//     layers (64 or 3 outputs) do not pay for 256-column passes.
//   * Rows are tiled so that the path shape gives 16 x 64 = 1024 blocks for
//     132 SMs; one block per cloud would give only 64.
//   * The running max of the TPU grid cannot carry across parallel blocks.
//     Each tile writes a (max, first argmax) partial per column; a second
//     small kernel reduces the partials in tile order with a strict '>',
//     so ties keep the lowest row deterministically.  The ragged tail of N
//     is masked in the kernel (no padding copy of x).
//   * Backward: recompute the intermediate activations of the tile (their
//     signs are the ReLU masks), expand the sparse cotangent one row per
//     warp (a ballot over idx finds the columns the row won, in ascending
//     order, and adds g[c] * W_L[:, c]), then run the remaining layers
//     backward as small dense products through the masks and mul factors.
//
// Shapes it takes: 1 <= L <= kMaxLayers, every width >= 1; the caller picks
// TM in {8, 4, 2} so the shared memory fits (pca_chain_smem), and keeps the
// width entering the last layer <= 1024 (the backward's register row).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;    // widest output chunk: 32 lanes x 8 columns
constexpr int kKTile = 16;     // depth of one staged weight tile
constexpr int kMaxLayers = 4;
constexpr int kMaxRowWidth = 1024;  // backward expansion: 32 lanes x 32
constexpr size_t kMaxSmem = 232448;  // 227 KB opt-in per block on sm_90

struct Chain {
  int L;
  int dims[kMaxLayers + 1];
  const float* w[kMaxLayers];   // [dims[l], dims[l+1]] row-major
  const float* wt[kMaxLayers];  // [dims[l+1], dims[l]] row-major (backward)
  const float* b[kMaxLayers];
  const float* mean[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* beta[kMaxLayers];
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// A layer pass computes a [T x 32*TN] output chunk: each thread owns TM rows
// (its warp's slice) and TN columns.  TN follows the layer's width (8 for
// more than 128 outputs, 4 for 65-128, 2 for up to 64), so narrow layers
// do not compute a 256-column chunk for a few real columns.
template <int TN>
__device__ __forceinline__ int chunk_col(int lane, int j) {
  // TN == 8: two groups of 4 adjacent columns, so the weight-tile reads
  // stay float4 and conflict-free across the warp
  if constexpr (TN == 8) return (j < 4) ? lane * 4 + j : 128 + lane * 4 + (j - 4);
  else return lane * TN + j;
}

template <int TN>
__device__ __forceinline__ void load_cols(const float* wrow, int lane, float (&bv)[TN]) {
  if constexpr (TN == 8) {
    const float4 b0 = *reinterpret_cast<const float4*>(wrow + lane * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(wrow + 128 + lane * 4);
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
  } else if constexpr (TN == 4) {
    const float4 b0 = *reinterpret_cast<const float4*>(wrow + lane * 4);
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
  } else {
    const float2 b0 = *reinterpret_cast<const float2*>(wrow + lane * 2);
    bv[0] = b0.x; bv[1] = b0.y;
  }
}

template <int TM>
__device__ __forceinline__ void load_rows(const float* p, float (&a)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      a[i] = v.x; a[i + 1] = v.y;
    }
  }
}

template <int TM>
__device__ __forceinline__ void store_rows(float* p, const float (&v)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < TM; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < TM; i += 2)
      *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void fma_step(const float* aT, const float* wrow,
                                         int lane, float (&acc)[TM][TN]) {
  float a[TM], bv[TN];
  load_rows<TM>(aT, a);
  load_cols<TN>(wrow, lane, bv);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
}

// acc[i][j] = sum_k aT[k][warp*TM + i] * Bg[k][c0 + chunk_col<TN>(lane, j)]
// aT: shared [K][T]; Bg: global [K][ncols] row-major; wtile: shared
// [kKTile][32*TN].  Starts with a barrier, so writes to aT made before the
// call are visible, and the previous user of wtile is done with it.
template <int TM, int TN>
__device__ __forceinline__ void gemm_chunk(const float* aT, int K,
                                           const float* __restrict__ Bg,
                                           int ncols, int c0, float* wtile,
                                           float (&acc)[TM][TN]) {
  constexpr int T = 8 * TM, CW = 32 * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKTile) {
    __syncthreads();
    for (int e = tid; e < kKTile * CW; e += kThreads) {
      const int k = k0 + e / CW, c = c0 + e % CW;
      wtile[e] = (k < K && c < ncols) ? __ldg(Bg + (size_t)k * ncols + c) : 0.f;
    }
    __syncthreads();
    const float* a = aT + (size_t)k0 * T + warp * TM;
    if (K - k0 >= kKTile) {
#pragma unroll
      for (int kk = 0; kk < kKTile; ++kk)
        fma_step<TM, TN>(a + kk * T, wtile + kk * CW, lane, acc);
    } else {
      for (int kk = 0; kk < K - k0; ++kk)
        fma_step<TM, TN>(a + kk * T, wtile + kk * CW, lane, acc);
    }
  }
}

// One layer pass over ncols output columns, in chunks of 32*TN columns with
// TN picked by the width; epi(c0, acc) consumes each chunk (every thread
// calls it, so it may hold barriers).
template <int TM, int TN, class Epi>
__device__ __forceinline__ void layer_pass_tn(const float* aT, int K,
                                              const float* __restrict__ Bg,
                                              int ncols, float* wtile, Epi& epi) {
  float acc[TM][TN];
  for (int c0 = 0; c0 < ncols; c0 += 32 * TN) {
    gemm_chunk<TM, TN>(aT, K, Bg, ncols, c0, wtile, acc);
    epi(c0, acc);
  }
}

template <int TM, class Epi>
__device__ __forceinline__ void layer_pass(const float* aT, int K,
                                           const float* __restrict__ Bg,
                                           int ncols, float* wtile, Epi epi) {
  if (ncols > 128) layer_pass_tn<TM, 8>(aT, K, Bg, ncols, wtile, epi);
  else if (ncols > 64) layer_pass_tn<TM, 4>(aT, K, Bg, ncols, wtile, epi);
  else layer_pass_tn<TM, 2>(aT, K, Bg, ncols, wtile, epi);
}

// Dense + eval-BN (+ ReLU) into a shared [C][T] activation buffer.
template <int TM>
__device__ __forceinline__ void hidden_layer(const Chain& ch, int l,
                                             const float* in, float* out,
                                             float* wtile) {
  constexpr int T = 8 * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = ch.dims[l + 1];
  layer_pass<TM>(in, ch.dims[l], ch.w[l], C, wtile, [&](int c0, auto& acc) {
    constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + chunk_col<TN>(lane, j);
      if (c >= C) continue;
      const float bb = ch.b[l][c], mm = ch.mean[l][c], mu = ch.mul[l][c],
                  be = ch.beta[l][c];
      float h[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        h[i] = fmaxf((acc[i][j] + bb - mm) * mu + be, 0.f);
      store_rows<TM>(out + c * T + warp * TM, h);
    }
  });
}

// x rows [row0, row0 + T) of cloud b into shared [C0][T]; rows past N are 0.
template <int TM>
__device__ __forceinline__ void load_x_tile(const float* __restrict__ x,
                                            int N, int C0, int b, int row0,
                                            float* xT) {
  constexpr int T = 8 * TM;
  const float* xb = x + ((size_t)b * N + row0) * C0;
  for (int e = threadIdx.x; e < T * C0; e += kThreads) {
    const int r = e / C0, k = e % C0;
    xT[k * T + r] = (row0 + r < N) ? xb[e] : 0.f;
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
    chain_fwd_kernel(const float* __restrict__ x, int N, Chain ch,
                     float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int T = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int row0 = tile * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = ch.L;

  int maxw = ch.dims[0];
  for (int l = 1; l < L; ++l) maxw = max(maxw, ch.dims[l]);
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + (size_t)maxw * T;
  float* wtile = nxt + (size_t)maxw * T;
  float* red_v = wtile + kKTile * kChunk;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * kChunk);

  load_x_tile<TM>(x, N, ch.dims[0], b, row0, cur);
  for (int l = 0; l < L - 1; ++l) {
    hidden_layer<TM>(ch, l, cur, nxt, wtile);
    float* t = cur; cur = nxt; nxt = t;
  }

  const int l = L - 1, C = ch.dims[L];
  layer_pass<TM>(cur, ch.dims[l], ch.w[l], C, wtile, [&](int c0, auto& acc) {
    constexpr int TN = sizeof(acc[0]) / sizeof(float), CW = 32 * TN;
    // per-warp max over its TM rows, ascending rows, strict '>'
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = chunk_col<TN>(lane, j), c = c0 + cc;
      float best = -INFINITY;
      int arg = INT_MAX;
      if (c < C) {
        const float bb = ch.b[l][c], mm = ch.mean[l][c], mu = ch.mul[l][c],
                    be = ch.beta[l][c];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = row0 + warp * TM + i;
          const float z = (acc[i][j] + bb - mm) * mu + be;
          if (row < N && z > best) { best = z; arg = row; }
        }
      }
      red_v[warp * CW + cc] = best;
      red_i[warp * CW + cc] = arg;
    }
    __syncthreads();
    // across warps in row order; one thread per chunk column
    const int c = c0 + tid;
    if (tid < CW && c < C) {
      float best = red_v[tid];
      int arg = red_i[tid];
      for (int w = 1; w < kWarps; ++w) {
        const float v = red_v[w * CW + tid];
        if (v > best) { best = v; arg = red_i[w * CW + tid]; }
      }
      const size_t o = ((size_t)b * ntiles + tile) * C + c;
      part_v[o] = best;
      part_i[o] = arg;
    }
    // the next chunk's gemm_chunk opens with a barrier before red_* reuse
  });
}

// partials [B, ntiles, C] -> y, idx [B, C]; tiles in order, strict '>'.
__global__ void chain_reduce_kernel(const float* __restrict__ part_v,
                                    const int* __restrict__ part_i,
                                    int ntiles, int C, int total,
                                    float* __restrict__ y,
                                    int* __restrict__ idx) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int b = e / C, c = e % C;
  const float* pv = part_v + (size_t)b * ntiles * C + c;
  const int* pi = part_i + (size_t)b * ntiles * C + c;
  float best = pv[0];
  int arg = pi[0];
  for (int t = 1; t < ntiles; ++t) {
    const float v = pv[(size_t)t * C];
    if (v > best) { best = v; arg = pi[(size_t)t * C]; }
  }
  y[e] = best;
  idx[e] = arg;
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
    chain_bwd_kernel(const float* __restrict__ x, int N, Chain ch,
                     const int* __restrict__ idx, const float* __restrict__ g,
                     float* __restrict__ dx) {
  constexpr int T = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int row0 = tile * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = ch.L, C0 = ch.dims[0], CL = ch.dims[L];

  // act[0] = x tile, act[l] = h_l (post-ReLU output of layer l-1), l < L
  float* act[kMaxLayers];
  float* p = reinterpret_cast<float*>(smem);
  int maxg = 1;
  for (int l = 0; l < L; ++l) {
    act[l] = p;
    p += (size_t)ch.dims[l] * T;
    if (l > 0) maxg = max(maxg, ch.dims[l]);
  }
  float* gin = p;
  float* gout = gin + (size_t)maxg * T;
  float* wtile = gout + (size_t)maxg * T;
  int* idx_s = reinterpret_cast<int*>(wtile + kKTile * kChunk);
  float* g_s = reinterpret_cast<float*>(idx_s) + align16(CL * sizeof(int)) / sizeof(float);

  load_x_tile<TM>(x, N, C0, b, row0, act[0]);
  for (int l = 0; l < L - 1; ++l) hidden_layer<TM>(ch, l, act[l], act[l + 1], wtile);
  for (int c = tid; c < CL; c += kThreads) {
    idx_s[c] = idx[(size_t)b * CL + c];
    g_s[c] = g[(size_t)b * CL + c];
  }
  __syncthreads();

  // Sparse expansion through the last layer, one row per warp at a time:
  // dh[k] = sum over the columns c this row won (ascending) of g[c] * W_L[k, c].
  const int Cm = ch.dims[L - 1];
  const float* wtL = ch.wt[L - 1];  // [CL][Cm]: column c of W_L is row c
  for (int r = warp; r < T; r += kWarps) {
    const int row = row0 + r;
    float rowacc[kMaxRowWidth / 32];
#pragma unroll
    for (int q = 0; q < kMaxRowWidth / 32; ++q) rowacc[q] = 0.f;
    if (row < N) {
      for (int base = 0; base < CL; base += 32) {
        const int c = base + lane;
        unsigned hits = __ballot_sync(0xffffffffu, c < CL && idx_s[c] == row);
        while (hits) {
          const int cc = base + __ffs(hits) - 1;
          hits &= hits - 1;
          const float gv = g_s[cc];
          const float* wrow = wtL + (size_t)cc * Cm;
#pragma unroll
          for (int q = 0; q < kMaxRowWidth / 32; ++q) {
            const int k = q * 32 + lane;
            if (k < Cm) rowacc[q] = fmaf(gv, __ldg(wrow + k), rowacc[q]);
          }
        }
      }
    }
    if (L == 1) {
      if (row < N) {
#pragma unroll
        for (int q = 0; q < kMaxRowWidth / 32; ++q) {
          const int k = q * 32 + lane;
          if (k < Cm) dx[((size_t)b * N + row) * C0 + k] = rowacc[q];
        }
      }
    } else {
      // through layer L-2's ReLU mask and mul: cotangent at its matmul output
      const float* h = act[L - 1];
      const float* mu = ch.mul[L - 2];
#pragma unroll
      for (int q = 0; q < kMaxRowWidth / 32; ++q) {
        const int k = q * 32 + lane;
        if (k < Cm) gin[k * T + r] = (h[k * T + r] > 0.f) ? rowacc[q] * mu[k] : 0.f;
      }
    }
  }

  // Dense layers backward: dh_l = c_l @ W_l^T, then mask and mul of layer l-1.
  for (int l = L - 2; l >= 0; --l) {
    const int C = ch.dims[l];
    layer_pass<TM>(gin, ch.dims[l + 1], ch.wt[l], C, wtile, [&](int c0, auto& acc) {
      constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + chunk_col<TN>(lane, j);
        if (c >= C) continue;
        if (l > 0) {
          const float mu = ch.mul[l - 1][c];
          float h[TM], v[TM];
          load_rows<TM>(act[l] + c * T + warp * TM, h);
#pragma unroll
          for (int i = 0; i < TM; ++i) v[i] = (h[i] > 0.f) ? acc[i][j] * mu : 0.f;
          store_rows<TM>(gout + c * T + warp * TM, v);
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int row = row0 + warp * TM + i;
            if (row < N) dx[((size_t)b * N + row) * C0 + c] = acc[i][j];
          }
        }
      }
    });
    float* t = gin; gin = gout; gout = t;
  }
}

size_t smem_bytes(int L, const int* dims, int tm, int bwd) {
  const size_t T = 8 * (size_t)tm;
  const size_t wtile = align16(sizeof(float) * kKTile * kChunk);
  if (!bwd) {
    int maxw = dims[0];
    for (int l = 1; l < L; ++l) maxw = dims[l] > maxw ? dims[l] : maxw;
    return 2 * align16(sizeof(float) * maxw * T) + wtile +
           align16(sizeof(float) * kWarps * kChunk) +
           align16(sizeof(int) * kWarps * kChunk);
  }
  size_t acts = 0;
  int maxg = 1;
  for (int l = 0; l < L; ++l) {
    acts += align16(sizeof(float) * dims[l] * T);
    if (l > 0) maxg = dims[l] > maxg ? dims[l] : maxg;
  }
  return acts + 2 * align16(sizeof(float) * maxg * T) + wtile +
         align16(sizeof(int) * dims[L]) + align16(sizeof(float) * dims[L]);
}

int check_shapes(int B, int N, int L, const int* dims, int tm, int bwd) {
  if (B < 1 || B > 65535 || N < 1 || L < 1 || L > kMaxLayers) return 1;
  if (tm != 8 && tm != 4 && tm != 2) return 1;
  for (int l = 0; l <= L; ++l)
    if (dims[l] < 1) return 1;
  if (bwd && dims[L - 1] > kMaxRowWidth) return 1;
  if (smem_bytes(L, dims, tm, bwd) > kMaxSmem) return 1;
  return 0;
}

Chain make_chain(int L, const int* dims, const void* const* params,
                 const void* const* wts) {
  Chain ch = {};
  ch.L = L;
  for (int l = 0; l <= L; ++l) ch.dims[l] = dims[l];
  for (int l = 0; l < L; ++l) {
    ch.w[l] = static_cast<const float*>(params[5 * l + 0]);
    ch.b[l] = static_cast<const float*>(params[5 * l + 1]);
    ch.mean[l] = static_cast<const float*>(params[5 * l + 2]);
    ch.mul[l] = static_cast<const float*>(params[5 * l + 3]);
    ch.beta[l] = static_cast<const float*>(params[5 * l + 4]);
    ch.wt[l] = wts ? static_cast<const float*>(wts[l]) : nullptr;
  }
  return ch;
}

template <int TM>
cudaError_t launch_fwd(const float* x, int B, int N, const Chain& ch,
                       float* part_v, int* part_i, size_t smem,
                       cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      chain_fwd_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + 8 * TM - 1) / (8 * TM), B);
  chain_fwd_kernel<TM><<<grid, kThreads, smem, s>>>(x, N, ch, part_v, part_i);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_bwd(const float* x, int B, int N, const Chain& ch,
                       const int* idx, const float* g, float* dx, size_t smem,
                       cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      chain_bwd_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + 8 * TM - 1) / (8 * TM), B);
  chain_bwd_kernel<TM><<<grid, kThreads, smem, s>>>(x, N, ch, idx, g, dx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the caller picks the largest TM
// whose need is at most pca_chain_max_smem().
size_t pca_chain_smem(int L, const int* dims, int tm, int bwd) {
  return smem_bytes(L, dims, tm, bwd);
}

size_t pca_chain_max_smem(void) { return kMaxSmem; }

const char* pca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// device: the CUDA device index of every pointer and the stream.
// x [B, N, dims[0]]; params: 5 device pointers per layer (w [dims[l],
// dims[l+1]], b, mean, mul, beta [dims[l+1]]); part_v / part_i scratch
// [B, ceil(N / (8*tm)), dims[L]]; y / idx [B, dims[L]].  Returns a
// cudaError_t code (0 on success).
int pca_chain_fwd(int device, const void* x, int B, int N, int L,
                  const int* dims, const void* const* params, void* part_v,
                  void* part_i, void* y, void* idx, int tm, void* stream) {
  if (check_shapes(B, N, L, dims, tm, 0)) return (int)cudaErrorInvalidValue;
  // this library's runtime keeps its own current device
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Chain ch = make_chain(L, dims, params, nullptr);
  const size_t smem = smem_bytes(L, dims, tm, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  switch (tm) {
    case 8: e = launch_fwd<8>(xf, B, N, ch, pv, pi, smem, s); break;
    case 4: e = launch_fwd<4>(xf, B, N, ch, pv, pi, smem, s); break;
    default: e = launch_fwd<2>(xf, B, N, ch, pv, pi, smem, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (N + 8 * tm - 1) / (8 * tm);
  const int total = B * dims[L];
  chain_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      pv, pi, ntiles, dims[L], total, static_cast<float*>(y),
      static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

// x as above; params as above; wts: per layer W_l transposed, [dims[l+1],
// dims[l]] row-major; idx int32 and g = dy * mul_L, both [B, dims[L]];
// dx [B, N, dims[0]].  Returns a cudaError_t code.
int pca_chain_bwd(int device, const void* x, int B, int N, int L,
                  const int* dims, const void* const* params,
                  const void* const* wts, const void* idx, const void* g,
                  void* dx, int tm, void* stream) {
  if (check_shapes(B, N, L, dims, tm, 1)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Chain ch = make_chain(L, dims, params, wts);
  const size_t smem = smem_bytes(L, dims, tm, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* ii = static_cast<const int*>(idx);
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(dx);
  switch (tm) {
    case 8: e = launch_bwd<8>(xf, B, N, ch, ii, gg, d, smem, s); break;
    case 4: e = launch_bwd<4>(xf, B, N, ch, ii, gg, d, smem, s); break;
    default: e = launch_bwd<2>(xf, B, N, ch, ii, gg, d, smem, s); break;
  }
  return (int)e;
}

}  // extern "C"
