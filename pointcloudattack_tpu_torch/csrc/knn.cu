// Exact self-kNN for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by pointcloudattack_tpu_torch/ops/knn.py.
//
// Replaces the TPU kernel pointcloudattack_tpu/ops/pallas/knn_kernel.py::
// knn_pallas (pallas_call at :111, body _knn_kernel), reached from
// ops/knn.py::knn (DGCNN's EdgeConv, four times per forward).  For
// x [B, N, C] it writes idx [B, N, k] int32: the k nearest points of each
// point, self included, in ascending distance, ties to the lower index
// (the stable order of lax.top_k on the negated distances).
//
// Numerics.  The distance is the port's ops/pairwise.py::pairwise_sqdist,
// bit for bit: d[i, j] = (xx_i - 2 * xy_ij) + xx_j, where xx and xy are
// summed over the channels in ascending order, every product and every sum
// rounded on its own (__fmul_rn / __fadd_rn: nvcc would otherwise contract
// a*b + c into an FMA and change the last bit, which can reorder a near
// tie).  So kernel and plain version pick the same indices, in the same
// order.
//
// What bounds it on this card.  At DGCNN's stages (B=16, N=1024, k=20,
// C = 3/64/64/128) the distances are 16.8 M pairs a stage and 2C + 3
// operations a pair: 8.9 G operations per forward.  Uncontracted, every
// multiply and add issues alone, so the floor is twice the FMA-based FP32
// bound.  The selection adds k compares a pair (0.34 G a stage).  The
// input is at most 8 MB and the output 1.3 MB: operations bound it.
//
// What the design does about it.
//   * A block owns 8 query rows of one cloud.  The [N, N] matrix never
//     reaches device memory: the block's 8 distance rows (8 x N floats,
//     128 KB at N = 4096) stay in shared memory.
//   * Distances: each thread owns one candidate of a 256-point tile and
//     keeps the 8 rows' running dot products in registers; the candidate
//     tile is staged transposed through shared memory 32 channels at a
//     time (a padded stride, so both the coalesced staging and the reads
//     are free of bank conflicts), and the 8 query rows' channel values
//     are one broadcast read each.  Squared norms come from a first small
//     kernel, in the same ascending order.
//   * Selection: one warp per row runs k warp-wide passes; pass t takes the
//     smallest (distance, index) pair above the one pass t-1 took, in
//     lexicographic order, so the picks come out in ascending distance with
//     ties to the lower index whatever the reduction order, and nothing is
//     written back to the distance row.
//   * Ragged N is masked, with no padded copy.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;     // query rows per block: one warp each
constexpr int kTile = 256;   // candidates per staged tile: one per thread
constexpr int kCh = 32;      // channels per staged tile
constexpr int kMaxPoints = 4096;
constexpr int kMaxChannels = 128;

// sum_c x[c] * x[c] in ascending c, each product and sum rounded.
__global__ void sqnorm_kernel(const float* __restrict__ x, int rows, int C,
                              float* __restrict__ nrm) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + (size_t)r * C;
  float s = __fmul_rn(p[0], p[0]);
  for (int c = 1; c < C; ++c) s = __fadd_rn(s, __fmul_rn(p[c], p[c]));
  nrm[r] = s;
}

// (v, i) comes after (pv, pi) in (distance, index) order.
__device__ __forceinline__ bool after(float v, int i, float pv, int pi) {
  return v > pv || (v == pv && i > pi);
}

// (v, i) comes before (bv, bi).
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ x, const float* __restrict__ nrm, int N, int C,
               int k, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);   // [C][kRows]
  float* tile = q + kMaxChannels * kRows;      // [kCh][kTile + 1]
  float* dist = tile + kCh * (kTile + 1);      // [kRows][N]

  const int b = blockIdx.y, row0 = blockIdx.x * kRows, tid = threadIdx.x;
  const float* xb = x + (size_t)b * N * C;
  const float* nb = nrm + (size_t)b * N;

  for (int e = tid; e < kRows * C; e += kThreads) {
    const int r = e / C, c = e % C;
    q[c * kRows + r] = row0 + r < N ? xb[(size_t)(row0 + r) * C + c] : 0.f;
  }
  float qn[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) qn[r] = row0 + r < N ? nb[row0 + r] : 0.f;

  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int j = j0 + tid;
    const int nj = min(kTile, N - j0);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kCh) {
      const int cw = min(kCh, C - c0);
      __syncthreads();  // the previous tile's reads are done (and q is written)
      for (int e = tid; e < nj * cw; e += kThreads) {
        const int jj = e / cw, cc = e % cw;  // consecutive threads, consecutive channels
        tile[cc * (kTile + 1) + jj] = xb[(size_t)(j0 + jj) * C + c0 + cc];
      }
      __syncthreads();
      if (tid < nj) {
        for (int cc = 0; cc < cw; ++cc) {
          const float y = tile[cc * (kTile + 1) + tid];
          const float* qc = q + (c0 + cc) * kRows;
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(qc[r], y));
        }
      }
    }
    if (tid < nj) {
      const float yn = nb[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        dist[r * N + j] = __fadd_rn(__fsub_rn(qn[r], __fmul_rn(2.0f, acc[r])), yn);
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, row = row0 + warp;
  if (row >= N) return;
  const float* d = dist + warp * N;
  int* o = out + ((size_t)b * N + row) * k;
  float pv = -INFINITY;
  int pi = -1;
  for (int t = 0; t < k; ++t) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int jj = lane; jj < N; jj += 32) {
      const float v = d[jj];
      if (after(v, jj, pv, pi) && before(v, jj, bv, bi)) { bv = v; bi = jj; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) o[t] = bi;
    pv = bv;
    pi = bi;
  }
}

size_t knn_smem(int N) {
  return sizeof(float) * ((size_t)kMaxChannels * kRows + (size_t)kCh * (kTile + 1) +
                          (size_t)kRows * N);
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  x [B, N, C]
// f32; nrm [B, N] f32 scratch; out [B, N, k] int32.  1 <= C <= 128,
// 1 <= k <= N <= 4096.  Returns a cudaError_t code (0 on success).
int pca_knn(int device, const void* x, void* nrm, int B, int N, int C, int k, void* out,
            void* stream) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxPoints || C < 1 || C > kMaxChannels || k < 1 ||
      k > N)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* nf = static_cast<float*>(nrm);
  const int rows = B * N;
  sqnorm_kernel<<<(rows + 255) / 256, 256, 0, s>>>(xf, rows, C, nf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = knn_smem(N);
  e = cudaFuncSetAttribute(knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kRows - 1) / kRows, B);
  knn_kernel<<<grid, kThreads, smem, s>>>(xf, nf, N, C, k, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
