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

}  // namespace pca
