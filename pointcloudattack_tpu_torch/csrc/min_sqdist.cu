// Per-row nearest-neighbour squared distance (the Chamfer row min) for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// pointcloudattack_tpu_torch/ops/chamfer.py.
//
// Replaces the TPU kernel pointcloudattack_tpu/ops/pallas/chamfer_kernel.py::
// _min_rows_pallas_2d (pallas_call at :103, body _kernel), reached from
// min_sqdist_rows (:356) by the single-direction Chamfer and Hausdorff
// distances (the KNN attack's per-iteration distance term).  For x [B, N, 3]
// and y [B, M, 3] it writes mins [B, N], min_j |x_i - y_j|^2, and
// argmin [B, N] int32, the first j attaining it.
//
// Numerics.  The distance is the TPU kernel's per-coordinate form
// ((dx*dx + dy*dy) + dz*dz) with every product and sum rounded on its own
// (__fsub_rn / __fmul_rn / __fadd_rn: nvcc would otherwise contract
// a*b + c into an FMA), in the order of the plain PyTorch version, so the
// mins agree bit for bit.  The running (min, argmin) is updated under a
// strict '<' in ascending j, so the first index wins a tie whatever the
// tiling.
//
// What bounds it on this card.  At the KNN attack's shape (B=64,
// N=M=1024) it is 67.1 M pairs at 8 operations a pair (3 subtractions,
// 3 products, 2 sums): 0.54 G operations against about 2 MB of input and
// output, a bound near 0.008 ms by operations.  Uncontracted, every
// multiply and add issues alone, and the compare-and-select adds two more
// instructions a pair, so the floor is well above that bound (PERF.md).
//
// What the design does about it.  One x row per thread, its running
// (min, argmin) in registers; the y cloud streams through shared memory in
// tiles of 1024 points stored as float4, so each pair costs one broadcast
// shared load.  The [N, M] matrix never exists.  Ragged N and M are masked,
// not padded with sentinel points.

#include "sqdist_common.cuh"

namespace {

using pca::kRowMinThreads;

__global__ void __launch_bounds__(kRowMinThreads)
    min_rows_kernel(const float* __restrict__ x, const float* __restrict__ y, int N, int M,
                    float* __restrict__ mins, int* __restrict__ argmin) {
  __shared__ float4 ys[pca::kRowMinTile];
  const int b = blockIdx.y;
  pca::row_min_block(x + (size_t)b * N * 3, y + (size_t)b * M * 3, N, M, blockIdx.x * kRowMinThreads + threadIdx.x,
                     ys, mins + (size_t)b * N, argmin + (size_t)b * N);
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  x [B, N, 3]
// and y [B, M, 3] f32; mins [B, N] f32, argmin [B, N] int32.  Returns a
// cudaError_t code (0 on success).
int pca_min_rows(int device, const void* x, const void* y, int B, int N, int M, void* mins,
                 void* argmin, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kRowMinThreads - 1) / kRowMinThreads, B);
  min_rows_kernel<<<grid, kRowMinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), N, M,
      static_cast<float*>(mins), static_cast<int*>(argmin));
  return (int)cudaGetLastError();
}

}  // extern "C"
