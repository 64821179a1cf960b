// Both directions' nearest-neighbour squared distances (the symmetric
// Chamfer / Hausdorff / nearest-index bundle of GeoA3) for Hopper
// (sm_90a), forward and backward.  Plain C interface, loaded with ctypes
// by pointcloudattack_tpu_torch/ops/chamfer.py.
//
// Replaces the TPU kernels pointcloudattack_tpu/ops/pallas/chamfer_kernel.py::
// _both_fwd (pallas_call at :205, body _both_fwd_kernel) and _both_bwd
// (pallas_call at :236, body _both_bwd_kernel), reached from
// min_sqdist_both (:286) by losses/distance.py::chamfer_hausdorff_nn, once
// per GeoA3 iteration forward and once backward.
//
// Forward.  For x [B, N, 3] and y [B, M, 3]: row_min [B, N] =
// min_j |x_i - y_j|^2 with row_arg [B, N] int32, the first j attaining it,
// and col_min [B, M] = min_i |x_i - y_j|^2 with col_arg [B, M], the first i.
// Backward, the JAX custom VJP: with gr [B, N] and gc [B, M] the
// cotangents of row_min and col_min,
//   dx_i = 2 gr_i (x_i - y_{row_arg i}) - sum_{j : col_arg j = i} 2 gc_j (y_j - x_i)
//   dy_j = 2 gc_j (y_j - x_{col_arg j}) - sum_{i : row_arg i = j} 2 gr_i (x_i - y_j)
//
// Numerics.  Distances are sqdist_common.cuh's sqdist3, the plain version's
// per-coordinate form, bit for bit; a strict '<' in ascending index keeps
// the first index on ties.  The backward's products and sums are each
// rounded on their own in the plain version's order, and each sum over the
// other side's matches runs in ascending index, the order in which the plain
// version's index_add_ on the CPU adds them: so dx and dy are bit-equal to
// the plain version on the CPU, and the same from run to run (no atomics).
//
// What bounds it on this card.  At GeoA3's shape (B=8, N=M=1024) the
// forward is 8.4 M pairs at 8 operations a pair (3 subtractions, 3
// products, 2 sums): 67 M operations, 0.001 ms at the FP32 rate, against
// 0.2 MB of input and output; the backward is two O(N + M) gathers and
// scatters plus N*M index compares.  Both are bound by latency at this size,
// not by the card.
//
// What the design does about it.  One launch per direction pair: the grid's
// first blocks run x's rows against y (the row min of min_sqdist.cu), the
// rest y's rows against x, so each direction computes its own distances
// (twice the distance work of one pass, but no cross-block reduction and no
// atomics).  The backward is one launch of the same split: a thread owns one
// output point and pulls the other side's matching terms by scanning its
// argmin array, staged in shared memory, in ascending index.  Ragged N and
// M are masked.

#include "sqdist_common.cuh"

namespace {

using pca::kRowMinThreads;

constexpr int kBwdThreads = 256;
constexpr int kArgTile = 2048;  // argmin entries per staged tile: 8 KB

__global__ void __launch_bounds__(kRowMinThreads)
    both_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y, int N, int M, int xblocks,
                    float* __restrict__ rmin, int* __restrict__ rarg, float* __restrict__ cmin,
                    int* __restrict__ carg) {
  __shared__ float4 ps[pca::kRowMinTile];
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * N * 3;
  const float* yb = y + (size_t)b * M * 3;
  if ((int)blockIdx.x < xblocks) {
    pca::row_min_block(xb, yb, N, M, blockIdx.x * kRowMinThreads + threadIdx.x, ps, rmin + (size_t)b * N,
                       rarg + (size_t)b * N);
  } else {
    pca::row_min_block(yb, xb, M, N, (blockIdx.x - xblocks) * kRowMinThreads + threadIdx.x, ps,
                       cmin + (size_t)b * M, carg + (size_t)b * M);
  }
}

// One side of the backward.  The thread's point p[i] (of P points; i >= P
// marks a thread without one) takes its own term 2 g_i (p_i - o_{arg_i})
// against the other side o, then subtracts, in ascending j, the other
// side's terms 2 og_j (o_j - p_i) for every j whose oarg_j is i.
__device__ __forceinline__ void both_bwd_side(const float* __restrict__ p, const float* __restrict__ o,
                                              const int* __restrict__ arg, const int* __restrict__ oarg,
                                              const float* __restrict__ g, const float* __restrict__ og, int P,
                                              int O, int i, int* tile, float* __restrict__ dp) {
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  if (i < P) {
    p0 = p[3 * i];
    p1 = p[3 * i + 1];
    p2 = p[3 * i + 2];
    const float* q = o + (size_t)arg[i] * 3;
    const float s = __fmul_rn(2.0f, g[i]);
    acc0 = __fmul_rn(s, __fsub_rn(p0, q[0]));
    acc1 = __fmul_rn(s, __fsub_rn(p1, q[1]));
    acc2 = __fmul_rn(s, __fsub_rn(p2, q[2]));
  }
  for (int j0 = 0; j0 < O; j0 += kArgTile) {
    const int nj = min(kArgTile, O - j0);
    __syncthreads();  // the previous tile's reads are done
    for (int j = threadIdx.x; j < nj; j += blockDim.x) tile[j] = oarg[j0 + j];
    __syncthreads();
    if (i >= P) continue;
    for (int j = 0; j < nj; ++j) {
      if (tile[j] != i) continue;
      const float* q = o + (size_t)(j0 + j) * 3;
      const float s = __fmul_rn(2.0f, og[j0 + j]);
      acc0 = __fsub_rn(acc0, __fmul_rn(s, __fsub_rn(q[0], p0)));
      acc1 = __fsub_rn(acc1, __fmul_rn(s, __fsub_rn(q[1], p1)));
      acc2 = __fsub_rn(acc2, __fmul_rn(s, __fsub_rn(q[2], p2)));
    }
  }
  if (i < P) {
    dp[3 * i] = acc0;
    dp[3 * i + 1] = acc1;
    dp[3 * i + 2] = acc2;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
    both_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y, const int* __restrict__ rarg,
                    const int* __restrict__ carg, const float* __restrict__ gr, const float* __restrict__ gc,
                    int N, int M, int xblocks, float* __restrict__ dx, float* __restrict__ dy) {
  __shared__ int tile[kArgTile];
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * N * 3;
  const float* yb = y + (size_t)b * M * 3;
  const int* rb = rarg + (size_t)b * N;
  const int* cb = carg + (size_t)b * M;
  if ((int)blockIdx.x < xblocks) {
    both_bwd_side(xb, yb, rb, cb, gr + (size_t)b * N, gc + (size_t)b * M, N, M,
                  blockIdx.x * kBwdThreads + threadIdx.x, tile, dx + (size_t)b * N * 3);
  } else {
    both_bwd_side(yb, xb, cb, rb, gc + (size_t)b * M, gr + (size_t)b * N, M, N,
                  (blockIdx.x - xblocks) * kBwdThreads + threadIdx.x, tile, dy + (size_t)b * M * 3);
  }
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  x [B, N, 3]
// and y [B, M, 3] f32; rmin [B, N], cmin [B, M] f32; rarg [B, N], carg
// [B, M] int32.  Returns a cudaError_t code (0 on success).
int pca_min_both_fwd(int device, const void* x, const void* y, int B, int N, int M, void* rmin, void* rarg,
                     void* cmin, void* carg, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int xblocks = (N + kRowMinThreads - 1) / kRowMinThreads;
  const dim3 grid(xblocks + (M + kRowMinThreads - 1) / kRowMinThreads, B);
  both_fwd_kernel<<<grid, kRowMinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), N, M, xblocks, static_cast<float*>(rmin),
      static_cast<int*>(rarg), static_cast<float*>(cmin), static_cast<int*>(carg));
  return (int)cudaGetLastError();
}

// x [B, N, 3], y [B, M, 3] f32; rarg [B, N], carg [B, M] int32 (from the
// forward); gr [B, N], gc [B, M] f32 cotangents; dx [B, N, 3], dy [B, M, 3]
// f32 outputs.  Returns a cudaError_t code (0 on success).
int pca_min_both_bwd(int device, const void* x, const void* y, const void* rarg, const void* carg,
                     const void* gr, const void* gc, int B, int N, int M, void* dx, void* dy, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int xblocks = (N + kBwdThreads - 1) / kBwdThreads;
  const dim3 grid(xblocks + (M + kBwdThreads - 1) / kBwdThreads, B);
  both_bwd_kernel<<<grid, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const int*>(rarg),
      static_cast<const int*>(carg), static_cast<const float*>(gr), static_cast<const float*>(gc), N, M,
      xblocks, static_cast<float*>(dx), static_cast<float*>(dy));
  return (int)cudaGetLastError();
}

}  // extern "C"
