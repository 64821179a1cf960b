// Shared device code of the per-point Dense -> eval-BatchNorm (-> ReLU or
// LeakyReLU) chain kernels (chain_maxpool.cu, gather_chain.cu,
// group_chain.cu, ball_hoist.cu) for Hopper (sm_90a): the f32 register
// tiles below, and at the end the cp.async copies, the 3xTF32 mma.sync
// product and the block scan.
//
// A block owns a tile of T = 8 * TM rows and runs the whole chain on it.
// Activations stay in shared memory, stored transposed ([C][T]) so that a
// warp reads its TM rows as one broadcast vector load.  Weights stream
// through a shared tile of kKTile x (32 * TN) columns; every block reads the
// same weights, which stay in L2.  Each thread keeps a TM x TN register
// tile of f32 accumulators (exact f32 FMA on the CUDA cores, no TF32), TN
// = 8, 4 or 2 by the layer's width, so narrow layers do not pay for
// 256-column passes.  Rows of a tile fall into segments of `seg` rows (the
// whole tile for a max over points, one group's K neighbours for a max over
// K); a segment starts at a multiple of TM, so each warp's rows lie in one
// segment.  The activation between layers is max(z, slope * z): ReLU at
// slope 0 (Chain's default), LeakyReLU otherwise, as the JAX package's
// dense_max_kernel.py::_act.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace pca {

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
  float slope;  // the activation's negative slope, in [0, 1]; 0 = ReLU
};

// The activation, max(z, slope * z); at slope 0 exactly fmaxf(z, 0).
__device__ __forceinline__ float act_fwd(float z, float slope) {
  return slope == 0.f ? fmaxf(z, 0.f) : fmaxf(z, slope * z);
}

// The cotangent dh through the activation of the hidden value h (h > 0
// exactly where its input z > 0, for slope >= 0), times the layer's mul:
// (dh or slope * dh) * mu, as _act_bwd then the mul; at slope 0 exactly
// the ReLU's h > 0 ? dh * mu : 0.
__device__ __forceinline__ float act_bwd_mul(float h, float dh, float mu, float slope) {
  return h > 0.f ? dh * mu : (slope == 0.f ? 0.f : (slope * dh) * mu);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Dynamic shared memory of one block.  Forward: two activation buffers of
// the widest layer input, the weight tile and the per-warp max partials.
// Backward: every layer input, two cotangent buffers (the second also holds
// the last layer's one-hot cotangent when `dense`), the weight tile and
// `groups` rows of (argmax, cotangent) of the last layer.
inline size_t chain_smem_bytes(int L, const int* dims, int tm, int bwd, int groups,
                               bool dense = false) {
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
  const int wide = dense && dims[L] > maxg ? dims[L] : maxg;
  return acts + align16(sizeof(float) * maxg * T) + align16(sizeof(float) * wide * T) + wtile +
         align16(sizeof(int) * groups * dims[L]) +
         align16(sizeof(float) * groups * dims[L]);
}

inline Chain make_chain(int L, const int* dims, const void* const* params,
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

// A layer pass computes a [T x 32*TN] output chunk: each thread owns TM rows
// (its warp's slice) and TN columns.
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
// call are visible, and the previous user of wtile is done with it.  A
// ragged K (an odd input width) is masked in the staged tile.
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

// Dense + eval-BN + activation into a shared [C][T] activation buffer.
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
        h[i] = act_fwd((acc[i][j] + bb - mm) * mu + be, ch.slope);
      store_rows<TM>(out + c * T + warp * TM, h);
    }
  });
}

// Visit every (row, column) of a [C0][T] tile, fn(r, col).  Eight
// consecutive threads take eight rows of one column: their shared-memory
// accesses fall in distinct banks, and a warp touches four columns of
// eight rows in device memory.
template <int TM, class Fn>
__device__ __forceinline__ void for_tile(int C0, Fn fn) {
  constexpr int T = 8 * TM;
  for (int e = threadIdx.x; e < T * C0; e += kThreads) {
    const int rest = e >> 3;
    fn((rest / C0) * 8 + (e & 7), rest % C0);
  }
}

// Fill a shared [C0][T] tile with val(r, col).
template <int TM, class Val>
__device__ __forceinline__ void fill_tile(int C0, Val val, float* xT) {
  constexpr int T = 8 * TM;
  for_tile<TM>(C0, [&](int r, int col) { xT[col * T + r] = val(r, col); });
}

// The whole chain forward on a tile whose input is in cur ([dims[0]][T]),
// then a max with the first argmax over each segment of seg rows (a
// multiple of TM; rows past the last whole segment are ignored).
// row_arg(r) is the index a row reports as its argmax, or -1 for a row that
// takes no part.  emit(s, c, value, arg) is called once for each segment s
// and output column c, by one thread.  Ties keep the lowest row: ascending
// rows within a warp and warps in order, with a strict '>'.
template <int TM, class RowArg, class Emit>
__device__ __forceinline__ void chain_fwd_max(const Chain& ch, float* cur, float* nxt,
                                              float* wtile, float* red_v, int* red_i,
                                              int seg, RowArg row_arg, Emit emit) {
  constexpr int T = 8 * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = ch.L;
  for (int l = 0; l < L - 1; ++l) {
    hidden_layer<TM>(ch, l, cur, nxt, wtile);
    float* t = cur; cur = nxt; nxt = t;
  }
  const int l = L - 1, C = ch.dims[L];
  const int nseg = T / seg, wps = seg / TM;  // segments per tile, warps per segment
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
          const int a = row_arg(warp * TM + i);
          const float z = (acc[i][j] + bb - mm) * mu + be;
          if (a >= 0 && z > best) { best = z; arg = a; }
        }
      }
      red_v[warp * CW + cc] = best;
      red_i[warp * CW + cc] = arg;
    }
    __syncthreads();
    // across the warps of each segment, in row order
    for (int e = tid; e < nseg * CW; e += kThreads) {
      const int s = e / CW, cc = e % CW, c = c0 + cc;
      if (c >= C) continue;
      const int w0 = s * wps;
      float best = red_v[w0 * CW + cc];
      int arg = red_i[w0 * CW + cc];
      for (int w = w0 + 1; w < w0 + wps; ++w) {
        const float v = red_v[w * CW + cc];
        if (v > best) { best = v; arg = red_i[w * CW + cc]; }
      }
      emit(s, c, best, arg);
    }
    // the next chunk's gemm_chunk opens with a barrier before red_* reuse
  });
}

// The last layer's cotangent rows of a tile row: the row takes the columns
// c with idx[c] == key, with cotangent g[c]; idx == nullptr: no columns.
struct HitRow {
  const int* idx;
  const float* g;
  int key;
};

// The layers below the last, backward.  gin ([dims[L-1]][T]) holds the
// cotangent at layer L-2's matmul output (mask and mul applied); for each
// layer l = L-2 .. 0 it forms dh_l = c_l @ W_l^T, then layer l-1's mask and
// mul, and store(r, k, v) receives the input cotangent of row r, column k,
// once for each pair.  act[l] holds layer l's input (its signs are the
// masks); gout is scratch of the widest hidden layer.  With L == 1 it does
// nothing.
template <int TM, class Store>
__device__ __forceinline__ void chain_bwd_hidden(const Chain& ch, float* const* act, float* gin,
                                                 float* gout, float* wtile, Store store) {
  constexpr int T = 8 * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = ch.L - 2; l >= 0; --l) {
    const int C = ch.dims[l];
    layer_pass<TM>(gin, ch.dims[l + 1], ch.wt[l], C, wtile, [&](int c0, auto& acc) {
      constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + chunk_col<TN>(lane, j);
        if (c >= C) continue;
        if (l > 0) {
          const float mu = ch.mul[l - 1][c];
          float hv[TM], v[TM];
          load_rows<TM>(act[l] + c * T + warp * TM, hv);
#pragma unroll
          for (int i = 0; i < TM; ++i) v[i] = act_bwd_mul(hv[i], acc[i][j], mu, ch.slope);
          store_rows<TM>(gout + c * T + warp * TM, v);
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) store(warp * TM + i, c, acc[i][j]);
        }
      }
    });
    float* t = gin; gin = gout; gout = t;
  }
}

// The chain backward from a dense cotangent: gout ([C_L][T], C_L * T
// floats) holds, before the call, the cotangent at the last layer's matmul
// output of every tile row.  One layer pass multiplies it by W_L^T, then
// the other layers run backward (chain_bwd_hidden), with act, gin, wtile
// and store as there.
template <int TM, class Store>
__device__ __forceinline__ void chain_bwd_dense(const Chain& ch, float* const* act, float* gin,
                                                float* gout, float* wtile, Store store) {
  constexpr int T = 8 * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = ch.L, CL = ch.dims[L], Cm = ch.dims[L - 1];
  const float* wtL = ch.wt[L - 1];  // [CL][Cm]: column c of W_L is row c
  layer_pass<TM>(gout, CL, wtL, Cm, wtile, [&](int c0, auto& acc) {
    constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = c0 + chunk_col<TN>(lane, j);
      if (k >= Cm) continue;
      if (L == 1) {
#pragma unroll
        for (int i = 0; i < TM; ++i) store(warp * TM + i, k, acc[i][j]);
      } else {
        // through layer L-2's mask and mul
        const float mu = ch.mul[L - 2][k];
        float hv[TM], v[TM];
        load_rows<TM>(act[L - 1] + k * T + warp * TM, hv);
#pragma unroll
        for (int i = 0; i < TM; ++i) v[i] = act_bwd_mul(hv[i], acc[i][j], mu, ch.slope);
        store_rows<TM>(gin + k * T + warp * TM, v);
      }
    }
  });
  chain_bwd_hidden<TM>(ch, act, gin, gout, wtile, store);
}

// The chain backward on a tile whose last layer is max-pooled.  act[0]
// ([dims[0]][T]) holds the input rows, and the tables that hits(r) points
// into are filled, both before the call.  It recomputes act[1..L-1] (their
// signs are the masks), takes the cotangent through the last layer, then
// runs the other layers backward as small dense products through the masks
// and mul factors.  store(r, k, v) receives the input cotangent of row r,
// column k, once for each pair.
//
// Through the last layer, each output column has one winning row.  Sparse
// (kDense false): one row per warp, a ballot over idx finds the columns the
// row won, in ascending order, and adds g[c] * W_L[:, c]; cheap when the
// winners spread over many rows.  Dense (kDense true): the one-hot
// cotangent [C_L][T] goes into gout (which then holds C_L * T floats) and
// chain_bwd_dense multiplies it by W_L^T; it costs as much as the forward's
// last layer, however the winners fall (a row that wins every column, as a
// group of one repeated point does, would leave one warp with all the
// sparse work).
template <int TM, bool kDense, class Hits, class Store>
__device__ __forceinline__ void chain_bwd_tile(const Chain& ch, float* const* act, float* gin,
                                               float* gout, float* wtile, Hits hits,
                                               Store store) {
  constexpr int T = 8 * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = ch.L, CL = ch.dims[L];
  for (int l = 0; l < L - 1; ++l) hidden_layer<TM>(ch, l, act[l], act[l + 1], wtile);
  __syncthreads();

  if constexpr (kDense) {
    for_tile<TM>(CL, [&](int r, int c) {
      const HitRow h = hits(r);
      gout[c * T + r] = (h.idx && h.idx[c] == h.key) ? h.g[c] : 0.f;
    });
    chain_bwd_dense<TM>(ch, act, gin, gout, wtile, store);
  } else {
    const int Cm = ch.dims[L - 1];
    const float* wtL = ch.wt[L - 1];  // [CL][Cm]: column c of W_L is row c
    for (int r = warp; r < T; r += kWarps) {
      const HitRow h = hits(r);
      float rowacc[kMaxRowWidth / 32];
#pragma unroll
      for (int q = 0; q < kMaxRowWidth / 32; ++q) rowacc[q] = 0.f;
      if (h.idx) {
        for (int base = 0; base < CL; base += 32) {
          const int c = base + lane;
          unsigned bits = __ballot_sync(0xffffffffu, c < CL && h.idx[c] == h.key);
          while (bits) {
            const int cc = base + __ffs(bits) - 1;
            bits &= bits - 1;
            const float gv = h.g[cc];
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
#pragma unroll
        for (int q = 0; q < kMaxRowWidth / 32; ++q) {
          const int k = q * 32 + lane;
          if (k < Cm) store(r, k, rowacc[q]);
        }
      } else {
        // through layer L-2's mask and mul: cotangent at its matmul output
        const float* hl = act[L - 1];
        const float* mu = ch.mul[L - 2];
#pragma unroll
        for (int q = 0; q < kMaxRowWidth / 32; ++q) {
          const int k = q * 32 + lane;
          if (k < Cm) gin[k * T + r] = act_bwd_mul(hl[k * T + r], rowacc[q], mu[k], ch.slope);
        }
      }
    }
    chain_bwd_hidden<TM>(ch, act, gin, gout, wtile, store);
  }
}

// partials [R, ntiles, C] -> y, idx [R, C]; tiles in order, strict '>', so
// ties keep the lowest tile.  A template, so that every source including
// this header may hold it.
template <class T>
__global__ void argmax_reduce_kernel(const T* __restrict__ part_v,
                                     const int* __restrict__ part_i,
                                     int ntiles, int C, int total,
                                     T* __restrict__ y,
                                     int* __restrict__ idx) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int r = e / C, c = e % C;
  const T* pv = part_v + (size_t)r * ntiles * C + c;
  const int* pi = part_i + (size_t)r * ntiles * C + c;
  T best = pv[0];
  int arg = pi[0];
  for (int t = 1; t < ntiles; ++t) {
    const T v = pv[(size_t)t * C];
    if (v > best) { best = v; arg = pi[(size_t)t * C]; }
  }
  y[e] = best;
  idx[e] = arg;
}

// ---------------------------------------------------------------------------
// Asynchronous copies, the 3xTF32 product on the tensor cores and a block
// scan, shared by chain_maxpool.cu and ball_hoist.cu.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// x = hi + lo + e, |e| < 2^-20 |x|: hi keeps the 10 mantissa bits of TF32
// and lo those of x - hi (exact in f32), both by dropping the 13 low bits.
// A mask and a subtraction: cvt.rna's rounding costs a conversion-unit
// instruction per part, which bounded the product stage.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Exclusive prefix sums of val(0..n-1) by the block, each thread a
// contiguous run; out(i, prefix) for each i; returns the total.  ws: 32
// shared ints.  Every thread of the block must call it.
template <class Val, class Out>
__device__ int block_scan(int n, Val val, Out out, int* ws) {
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int per = (n + nt - 1) / nt, lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += val(i);
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane < nw) ws[lane] = v;
  }
  __syncthreads();
  int run = incl - s + (warp ? ws[warp - 1] : 0);
  const int total = ws[nw - 1];
  for (int i = lo; i < hi; ++i) {
    const int v = val(i);
    out(i, run);
    run += v;
  }
  __syncthreads();
  return total;
}

}  // namespace pca
