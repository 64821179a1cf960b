// Farthest point sampling for Hopper (sm_90a).  Plain C interface, loaded
// with ctypes by pointcloudattack_tpu_torch/ops/fps.py.
//
// Replaces the TPU kernel pointcloudattack_tpu/ops/pallas/fps_kernel.py::
// fps_pallas (pallas_call at :79, body _fps_kernel), reached from
// ops/fps.py::farthest_point_sample.  For xyz [B, N, 3] and start [B] it
// writes out [B, npoint] int32: out[b, 0] = start[b]; each step lowers the
// running distance dist[n] = min(dist[n], |xyz[n] - xyz[picked]|^2) and
// picks the point of largest dist, ties to the lowest index.
//
// Numerics.  The squared distance is (dx*dx + dy*dy) + dz*dz with every
// product and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc would
// otherwise contract a*b + c into an FMA), in the order of the JAX scan
// (ops/fps.py:60) and of the plain PyTorch version.  One changed bit could
// flip a near tie and with it every later pick; with these intrinsics the
// kernel and the plain version agree bit for bit.
//
// What bounds it on this card.  The work is tiny: PointNet++'s first SA
// is 16 clouds x 512 steps x 1024 points x ~9 flops = 75 MFLOP, against
// 0.2 MB of input.  What bounds it is latency: npoint dependent steps, each
// a distance update and a block-wide argmax (a warp shuffle tree, one
// barrier, a 16-way scan).  B = 16 fills only 16 of the 132 SMs.
//
// What the design does about it.  One block per cloud: the cloud (as
// three coordinate arrays) and the running distances live in shared
// memory, so a step touches no device memory.  The argmax compares
// (value, index) pairs, larger value first and then lower index, so the
// result does not depend on the reduction order.  Per-warp winners go to a
// double-buffered shared slot, so each step needs one barrier.  Spreading a
// cloud over several SMs (a cluster) is left for a later change.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPoints = 8192;  // 16 bytes a point: 128 KB of shared memory

// (v, i) beats (bv, bi): larger value, or equal value and lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start,
               int N, int npoint, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + N;
  float* zs = ys + N;
  float* dist = zs + N;
  __shared__ float red_v[2][kWarps];
  __shared__ int red_i[2][kWarps];

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  for (int n = tid; n < N; n += kThreads) {
    xs[n] = p[3 * n];
    ys[n] = p[3 * n + 1];
    zs[n] = p[3 * n + 2];
    dist[n] = INFINITY;
  }
  __syncthreads();

  int far = start[b];
  for (int s = 0; s < npoint; ++s) {
    if (tid == 0) out[(size_t)b * npoint + s] = far;
    if (s == npoint - 1) break;  // the last pick needs no update
    const float cx = xs[far], cy = ys[far], cz = zs[far];
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int n = tid; n < N; n += kThreads) {
      const float dx = __fsub_rn(xs[n], cx), dy = __fsub_rn(ys[n], cy),
                  dz = __fsub_rn(zs[n], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(dist[n], d);
      dist[n] = m;
      if (better(m, n, bv, bi)) { bv = m; bi = n; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    const int buf = s & 1;
    if (lane == 0) { red_v[buf][warp] = bv; red_i[buf][warp] = bi; }
    __syncthreads();
    bv = red_v[buf][0];
    bi = red_i[buf][0];
    for (int w = 1; w < kWarps; ++w)
      if (better(red_v[buf][w], red_i[buf][w], bv, bi)) { bv = red_v[buf][w]; bi = red_i[buf][w]; }
    far = bi;
    // A thread writes this step's dist[n] and reads it back next step
    // (same n, same thread); the other buffer of red_* is written next.
  }
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  xyz [B, N, 3]
// f32, start [B] int32, out [B, npoint] int32.  Returns a cudaError_t code.
int pca_fps(int device, const void* xyz, const void* start, int B, int N,
            int npoint, void* out, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxPoints || npoint < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(float) * 4 * (size_t)N;
  e = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  fps_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const int*>(start), N, npoint,
      static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
