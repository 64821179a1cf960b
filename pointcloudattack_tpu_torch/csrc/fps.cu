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
// kernel and the plain version agree bit for bit.  A running distance is a
// sum of squares or +inf, never -0 or negative, so distances order as their
// unsigned bits, and the argmax is exact in any reduction order.
//
// What bounds it on this card.  The work is tiny: PointNet++'s first SA
// is 16 clouds x 512 steps x 1024 points x ~10 operations = 84 M
// operations against 0.2 MB of input, 0.0014 ms at the data sheet's rates.
// What bounds it is latency: npoint dependent steps, each a distance update
// of the whole cloud, a block-wide argmax and a read of the picked point.
// Steps are sequential, so more SMs a cloud shorten no step.
//
// What the design does about it.  One block a cloud, each lane holding P
// contiguous points (4, or 1 or 2 below 512 points so that a cloud keeps 4
// warps, 8 or 16 past 1024 so that it keeps at most 8 warps up to 4096: the
// fastest on the card of 1 to 16 warps at 256, 512 and 1024 points) with
// their coordinates and running distances in registers (P a template
// argument): point n = (warp 32 + lane) P + k, so
// indices ascend with (warp, lane, k).  A step reads the picked point (the
// cloud as float4 in shared memory), lowers the distances, and finds the
// argmax in three levels, each where a later candidate wins only on a
// strictly larger distance, which keeps the lowest index on a tie: a merge
// tree over the lane's points; a warp's redux.sync max of the distances'
// bits, whose lowest lane holding it (a ballot) writes the warp's winner;
// and, behind the step's one barrier, every thread's merge tree over the
// warps' winners, read from a double-buffered shared slot (WT slots, the
// warps' count rounded up to 4, 8 or 16; a slot past the warps never wins).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxPoints = 8192;   // 16 bytes a point in shared memory: 128 KB
constexpr int kMaxThreads = 512;   // 16 warps of 16 points a lane at N = 8192
constexpr unsigned kFull = 0xffffffffu;

template <int P, int WT>
__global__ void __launch_bounds__(kMaxThreads)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ start, int N, int npoint,
               int* __restrict__ out) {
  extern __shared__ float4 pts[];                // [N]
  __shared__ __align__(16) uint2 win[2][WT];     // the warps' (distance bits, index), double-buffered
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = xyz + (size_t)b * N * 3;
  for (int n = tid; n < N; n += blockDim.x) pts[n] = make_float4(p[3 * n], p[3 * n + 1], p[3 * n + 2], 0.f);
  if (tid < WT) win[0][tid] = win[1][tid] = make_uint2(0u, 0u);  // a slot past the warps: distance 0, last
  // a point past N keeps distance 0 and an index above every real one, so it never wins
  const int n0 = (warp * 32 + lane) * P;
  float px[P], py[P], pz[P], dist[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const bool in = n0 + k < N;
    px[k] = in ? p[3 * (n0 + k)] : 0.f;
    py[k] = in ? p[3 * (n0 + k) + 1] : 0.f;
    pz[k] = in ? p[3 * (n0 + k) + 2] : 0.f;
    dist[k] = in ? INFINITY : 0.f;
  }
  __syncthreads();

  int far = start ? start[b] : 0;
  int* o = out + (size_t)b * npoint;
  for (int s = 0;; ++s) {
    if (tid == 0) o[s] = far;
    if (s == npoint - 1) break;  // the last pick needs no update
    const float4 c = pts[far];
    unsigned v[P];
    int kk[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float dx = __fsub_rn(px[k], c.x), dy = __fsub_rn(py[k], c.y), dz = __fsub_rn(pz[k], c.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      dist[k] = fminf(dist[k], d);
      v[k] = __float_as_uint(dist[k]);
      kk[k] = k;
    }
#pragma unroll
    for (int w = 1; w < P; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < P; k += 2 * w) {
        if (v[k + w] > v[k]) {
          v[k] = v[k + w];
          kk[k] = kk[k + w];
        }
      }
    }
    const unsigned m = __reduce_max_sync(kFull, v[0]);
    const unsigned lanes = __ballot_sync(kFull, v[0] == m);
    const int buf = s & 1;
    if (lane == __ffs(lanes) - 1) win[buf][warp] = make_uint2(m, (unsigned)(n0 + kk[0]));
    __syncthreads();
    // win[buf] is written again two steps on, after the next barrier, which
    // every thread passes only once it has read it here
    uint2 e[WT];
#pragma unroll
    for (int w = 0; w < WT; w += 2) {
      const uint4 two = reinterpret_cast<const uint4*>(win[buf])[w / 2];
      e[w] = make_uint2(two.x, two.y);
      e[w + 1] = make_uint2(two.z, two.w);
    }
#pragma unroll
    for (int w = 1; w < WT; w *= 2) {
#pragma unroll
      for (int k = 0; k + w < WT; k += 2 * w)
        if (e[k + w].x > e[k].x) e[k] = e[k + w];
    }
    far = (int)e[0].y;
  }
}

template <int P, int WT>
cudaError_t launch(const float* xyz, const int* start, int B, int N, int npoint, int* out, cudaStream_t s) {
  const int warps = (N + 32 * P - 1) / (32 * P);
  const size_t smem = sizeof(float4) * (size_t)N;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fps_kernel<P, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fps_kernel<P, WT><<<B, warps * 32, smem, s>>>(xyz, start, N, npoint, out);
  return cudaGetLastError();
}

// The winners' slots: the warps' count rounded up to 4, 8 or 16.
template <int P>
cudaError_t launch_p(const float* xyz, const int* start, int B, int N, int npoint, int* out, cudaStream_t s) {
  const int warps = (N + 32 * P - 1) / (32 * P);
  if (warps <= 4) return launch<P, 4>(xyz, start, B, N, npoint, out, s);
  if (warps <= 8) return launch<P, 8>(xyz, start, B, N, npoint, out, s);
  return launch<P, 16>(xyz, start, B, N, npoint, out, s);
}

// Points a lane: the fewest of 1, 2, 4, 8, 16 with which 4 warps hold the
// cloud, or from 4 points a lane on 8 warps; the warps then cover it.
int lane_points(int N) {
  int P = 1;
  while (P < 16 && N > 32 * P * (P >= 4 ? 8 : 4)) P *= 2;
  return P;
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  xyz [B, N, 3]
// f32, start [B] int32 (null: every cloud from index 0), out [B, npoint]
// int32.  Returns a cudaError_t code.
int pca_fps(int device, const void* xyz, const void* start, int B, int N, int npoint, void* out, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxPoints || npoint < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const float* x = static_cast<const float*>(xyz);
  const int* st = static_cast<const int*>(start);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane_points(N)) {
    case 1: return (int)launch_p<1>(x, st, B, N, npoint, o, s);
    case 2: return (int)launch_p<2>(x, st, B, N, npoint, o, s);
    case 4: return (int)launch_p<4>(x, st, B, N, npoint, o, s);
    case 8: return (int)launch_p<8>(x, st, B, N, npoint, o, s);
    default: return (int)launch_p<16>(x, st, B, N, npoint, o, s);
  }
}

}  // extern "C"
