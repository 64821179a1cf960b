// Device code shared by the nearest-point kernels (min_sqdist.cu,
// min_sqdist_both.cu) and the curvature kernel (kappa.cu).
//
// sqdist3 is the TPU kernels' exact per-coordinate squared distance,
// ((q0-p0)^2 + (q1-p1)^2) + (q2-p2)^2, every subtraction, product and sum
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn: nvcc would
// otherwise contract a*b + c into an FMA), in the order of the plain
// PyTorch versions, so kernel and plain version compute the same bits.
// Swapping the two points gives the same bits too: fl(a - b) = -fl(b - a).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace pca {

__device__ __forceinline__ float sqdist3(float q0, float q1, float q2, float p0, float p1, float p2) {
  const float d0 = __fsub_rn(q0, p0), d1 = __fsub_rn(q1, p1), d2 = __fsub_rn(q2, p2);
  return __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
}

constexpr int kRowMinThreads = 256;
constexpr int kRowMinTile = 1024;  // reference points per staged tile: 16 KB

// The nearest of the M points ref[M, 3] to the query point q[i] (one per
// thread; i >= N marks a thread without a point), for every thread of the
// block, which all must call it.  The reference points stream through
// ys[kRowMinTile] in shared memory as float4, one broadcast load a pair; the
// running (min, argmin) is updated under a strict '<' in ascending j, so the
// first index wins a tie.  An all-infinite row keeps index 0, as the plain
// version does.
__device__ __forceinline__ void row_min_block(const float* __restrict__ q, const float* __restrict__ ref,
                                              int N, int M, int i, float4* ys, float* __restrict__ mins,
                                              int* __restrict__ argmin) {
  float x0 = 0.f, x1 = 0.f, x2 = 0.f;
  if (i < N) {
    x0 = q[3 * i];
    x1 = q[3 * i + 1];
    x2 = q[3 * i + 2];
  }
  float best = INFINITY;
  int arg = 0;
  for (int j0 = 0; j0 < M; j0 += kRowMinTile) {
    const int nj = min(kRowMinTile, M - j0);
    __syncthreads();  // the previous tile's reads are done
    for (int j = threadIdx.x; j < nj; j += blockDim.x) {
      const float* p = ref + (size_t)(j0 + j) * 3;
      ys[j] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    for (int j = 0; j < nj; ++j) {
      const float4 p = ys[j];
      const float d = sqdist3(x0, x1, x2, p.x, p.y, p.z);
      if (d < best) {
        best = d;
        arg = j0 + j;
      }
    }
  }
  if (i < N) {
    mins[i] = best;
    argmin[i] = arg;
  }
}

}  // namespace pca
