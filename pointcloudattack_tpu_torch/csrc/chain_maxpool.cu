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
// 1.1 GFLOP of recompute (the masks), a sparse expansion (each output
// column has exactly one winning row) and 1.1 GFLOP of products back
// through the narrow layers.
//
// What the design does about it.
//   * Exact f32 FMA on the CUDA cores (no TF32, no bf16): the TPU kernel's
//     bf16 operand truncation was that chip's default matmul precision,
//     not the function's meaning.
//   * A block owns one row tile (T = 8 * TM points) of one cloud and runs
//     the whole chain on it, with the register-tiled layer passes of
//     chain_common.cuh (shared with gather_chain.cu).
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

#include "chain_common.cuh"

namespace {

using namespace pca;

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
    chain_fwd_kernel(const float* __restrict__ x, int N, Chain ch,
                     float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int T = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int row0 = tile * T;
  const int L = ch.L, C0 = ch.dims[0], C = ch.dims[L];

  int maxw = C0;
  for (int l = 1; l < L; ++l) maxw = max(maxw, ch.dims[l]);
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + (size_t)maxw * T;
  float* wtile = nxt + (size_t)maxw * T;
  float* red_v = wtile + kKTile * kChunk;
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * kChunk);

  // x rows [row0, row0 + T) of cloud b; rows past N are 0
  const float* xb = x + ((size_t)b * N + row0) * C0;
  fill_tile<TM>(C0, [&](int r, int k) { return (row0 + r < N) ? xb[(size_t)r * C0 + k] : 0.f; },
                cur);
  chain_fwd_max<TM>(
      ch, cur, nxt, wtile, red_v, red_i, T,
      [&](int r) { return (row0 + r < N) ? row0 + r : -1; },
      [&](int, int c, float v, int a) {
        const size_t o = ((size_t)b * ntiles + tile) * C + c;
        part_v[o] = v;
        part_i[o] = a;
      });
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

  const float* xb = x + ((size_t)b * N + row0) * C0;
  fill_tile<TM>(C0, [&](int r, int k) { return (row0 + r < N) ? xb[(size_t)r * C0 + k] : 0.f; },
                act[0]);
  for (int c = threadIdx.x; c < CL; c += kThreads) {
    idx_s[c] = idx[(size_t)b * CL + c];
    g_s[c] = g[(size_t)b * CL + c];
  }
  chain_bwd_tile<TM, false>(
      ch, act, gin, gout, wtile,
      [&](int r) { return (row0 + r < N) ? HitRow{idx_s, g_s, row0 + r} : HitRow{nullptr, nullptr, 0}; },
      [&](int r, int k, float v) {
        if (row0 + r < N) dx[((size_t)b * N + row0 + r) * C0 + k] = v;
      });
}

size_t smem_bytes(int L, const int* dims, int tm, int bwd) {
  return chain_smem_bytes(L, dims, tm, bwd, 1);
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
  argmax_reduce_kernel<float><<<(total + 255) / 256, 256, 0, s>>>(
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
