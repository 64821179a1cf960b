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
//   * The rows of a group are contiguous, so a block takes whole groups:
//     a tile of T = 8 * TM rows holds gpb = floor(T / K) groups (3 at
//     K = 20 and T = 64: 60 rows of 64 at work, where the gather kernel's
//     warp-aligned groups left 12 of 32 idle), and a ragged G masks the
//     last tile's missing groups.  K <= T.
//   * The chain is chain_common.cuh's register-tiled f32 layer pass, with
//     its slope.  The last layer's epilogue writes the tile's z (max) or
//     activation (mean) to a shared [C_L][T + 1] buffer (the padding puts
//     neighbouring columns in distinct banks), and one thread per (group,
//     column) scans the group's K rows in ascending k: a strict '>' keeps
//     the lowest k among ties (the TPU kernel's min-iota), and the mean
//     sums in ascending k, then divides by K as jnp.mean does.
//   * Backward: recompute the hidden layers (their signs are the masks);
//     max puts g on each column's argmax row (at one layer without loading
//     the rows, which nothing reads), mean recomputes the last layer and
//     puts act'(z_L) * g on every row; then chain_common.cuh's
//     dense backward takes the [C_L][T] cotangent through W_L^T and the
//     hidden layers.  Each row's dx is its own: no atomics, deterministic.

#include "chain_common.cuh"

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

}  // extern "C"
