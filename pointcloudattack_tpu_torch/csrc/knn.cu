// Exact self-kNN for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by pointcloudattack_tpu_torch/ops/knn.py.
//
// Replaces the TPU kernel pointcloudattack_tpu/ops/pallas/knn_kernel.py::
// knn_pallas (pallas_call at :111, body _knn_kernel), reached from
// ops/knn.py::knn (DGCNN's EdgeConv, four times per forward; CurveNet's
// kNNs on xyz; GeoA3's normals and cached curvature sets).  For
// x [B, N, C] it writes idx [B, N, k] int32: the k nearest points of each
// point, self included, in ascending distance, ties to the lower index
// (the stable order of lax.top_k on the negated distances).
//
// Numerics.  The distance is the port's ops/pairwise.py::pairwise_sqdist,
// bit for bit: d[i, j] = (xx_i - 2 * xy_ij) + xx_j, where xx and xy are
// summed over the channels in ascending order, every product and every sum
// rounded on its own (__fmul_rn / __fadd_rn: nvcc would otherwise contract
// a*b + c into an FMA and change the last bit, which can reorder a near
// tie).  Channels past C, to a multiple of 4, are 0 on both sides and add
// +0, which leaves every distance's bits as they are.  The selection is
// lexicographic in (distance, index) (select_common.cuh), so kernel and
// plain version pick the same indices, in the same order.
//
// What bounds it on this card.  At DGCNN's stages (B=16, N=1024, k=20,
// C = 3/64/64/128) the distances are 16.8 M pairs a stage and 2C + 3
// operations a pair: 8.9 G operations per forward.  Uncontracted, every
// multiply and add issues alone, so the floor is twice the FMA-based FP32
// bound, about 0.27 ms a forward.  The selection needs one compare a pair.
// The input is at most 8 MB and the output 1.3 MB: operations bound it.
//
// What the design does about it.
//   * A block owns 32 rows of one cloud (16 and 8 past N = 1024 and 2048)
//     and keeps their exact distances to every point in shared memory, 128
//     KB at most; the [N, N] matrix never reaches device memory.
//   * Distances: the block's warps form row groups of kRW = 4 rows, two
//     warps a group, each warp taking half of every kTile = 256 candidate
//     tile, a lane 4 candidates (lane + 32 v): a thread holds a 4 x 4
//     register tile of accumulators and per 4 channels reads its rows as 4
//     broadcast float4 and its candidates as 4 float4 for 16 products and
//     16 sums.  Candidate tiles of kCh channels, and their squared norms,
//     stream through a double-buffered shared ring by cp.async (16 bytes
//     where C % 4 == 0, zero-filled past N and C), the next one loading
//     while this one multiplies.  Squared norms come from a first small
//     kernel, in the same ascending order.  From C = 64 on the rounded
//     products and sums set the time, with each step's two barriers: so a
//     step takes 32 channels, the most that a block's 227 KB of shared
//     memory holds beside the rows, and a whole step is unrolled.
//   * Selection (select_common.cuh): each lane keeps the smallest distance
//     it wrote to each of its rows, so every row has 64 share minima (two
//     warps of 32 lanes), whose k-th smallest bounds its k-th distance; one
//     float4 pass gathers the entries under it (a few more than k on the
//     path's clouds) and a bitonic sort of those across a warp orders them.
//     Past k = 64, and for rows with more than 128 entries under the bound
//     (many exact duplicates), the warp runs k passes over the row instead.
//   * Ragged N is masked (rows padded with +inf to a multiple of 4), with
//     no padded copy of x.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

#include "chain_common.cuh"
#include "select_common.cuh"

namespace {

constexpr int kRW = 4;            // rows of a row group
constexpr int kGroupWarps = 2;    // warps of a row group, each taking half of a tile's candidates
constexpr int kCT = 4;            // candidates a lane takes of a tile
constexpr int kTile = 32 * kCT * kGroupWarps;  // candidates a staged tile
constexpr int kCh = 32;           // channels a staged tile
constexpr int kLd = kCh + 4;      // a candidate's stride in the tile: float4-aligned, conflict-free
constexpr int kMaxPoints = 4096;
constexpr int kMaxChannels = 128;
constexpr int kRowFloats = 32 * 1024;  // the distance rows' shared memory: 128 KB
constexpr int kShares = pca::sel::kShares;
static_assert(kShares == 32 * kGroupWarps, "a row's share minima are its two warps' lanes");

// sum_c x[c] * x[c] in ascending c, each product and sum rounded.
__global__ void sqnorm_kernel(const float* __restrict__ x, int rows, int C, float* __restrict__ nrm) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + (size_t)r * C;
  float s = __fmul_rn(p[0], p[0]);
  for (int c = 1; c < C; ++c) s = __fadd_rn(s, __fmul_rn(p[c], p[c]));
  nrm[r] = s;
}

struct KnnArgs {
  const float* x;    // [B, N, C]
  const float* nrm;  // [B, N]
  int* out;          // [B, N, k]
  int N, C, k;
  int N4, Cq;        // N and C rounded up to 4
  bool vec;          // C % 4 == 0 and x 16-byte aligned: 16-byte copies
};

// Shared memory of a block of `warps` warps: its rows, their channels,
// their share minima, two tiles with their norms (the selection's buffers
// reuse the tiles).
size_t knn_smem(int warps, int N4, int Cq) {
  const size_t rows = (size_t)warps / kGroupWarps * kRW;
  return sizeof(float) * (rows * N4 + rows * Cq + rows * kShares + 2 * (size_t)kTile * (kLd + 1));
}

// Stages channels [c0, c0 + cw) (cw a multiple of 4) of candidates
// [j0, j0 + kTile) into tile [kTile][kLd], 0 past N and C, and with the
// first channels their squared norms into yn [kTile].
template <int THREADS>
__device__ __forceinline__ void stage(const KnnArgs& p, const float* xb, const float* nb, int j0, int c0, int cw,
                                      float* tile, float* yn) {
  const int tid = threadIdx.x;
  if (p.vec) {
    const int per = cw >> 2;  // float4 a candidate
    for (int e = tid; e < kTile * per; e += THREADS) {
      const int jj = e / per, c = c0 + 4 * (e - jj * per), j = j0 + jj;
      const bool ok = j < p.N && c < p.C;
      pca::cp_async16(tile + jj * kLd + (c - c0), ok ? xb + (size_t)j * p.C + c : xb, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kTile * cw; e += THREADS) {
      const int jj = e / cw, c = c0 + (e - jj * cw), j = j0 + jj;
      const bool ok = j < p.N && c < p.C;
      pca::cp_async4(tile + jj * kLd + (c - c0), ok ? xb + (size_t)j * p.C + c : xb, ok ? 4 : 0);
    }
  }
  if (c0 == 0) {
    for (int jj = tid; jj < kTile; jj += THREADS) {
      const bool ok = j0 + jj < p.N;
      pca::cp_async4(yn + jj, ok ? nb + j0 + jj : nb, ok ? 4 : 0);
    }
  }
  pca::cp_async_commit();
}

// acc[r][v] += q[r] . y[v] over 4 channels, in ascending channel order, each
// product and sum rounded on its own: q at row stride sq, the candidates
// y at 32 * v * kLd.
__device__ __forceinline__ void channels4(float (&acc)[kRW][kCT], const float* q, int sq, const float* y) {
  float4 qv[kRW], yv[kCT];
#pragma unroll
  for (int r = 0; r < kRW; ++r) qv[r] = *reinterpret_cast<const float4*>(q + r * sq);
#pragma unroll
  for (int v = 0; v < kCT; ++v) yv[v] = *reinterpret_cast<const float4*>(y + 32 * v * kLd);
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
#pragma unroll
    for (int v = 0; v < kCT; ++v) {
      float a = __fadd_rn(acc[r][v], __fmul_rn(qv[r].x, yv[v].x));
      a = __fadd_rn(a, __fmul_rn(qv[r].y, yv[v].y));
      a = __fadd_rn(a, __fmul_rn(qv[r].z, yv[v].z));
      acc[r][v] = __fadd_rn(a, __fmul_rn(qv[r].w, yv[v].w));
    }
  }
}

template <int WARPS>
__global__ void __launch_bounds__(WARPS * 32) knn_kernel(KnnArgs p) {
  constexpr int THREADS = WARPS * 32, R = WARPS / kGroupWarps * kRW, PER = R / WARPS;  // rows a warp selects
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);  // [R][N4]
  float* q = rows + (size_t)R * p.N4;            // [R][Cq]
  float* mins = q + (size_t)R * p.Cq;            // [R][kShares]
  float* tiles = mins + R * kShares;             // [2][kTile][kLd], then the selection's buffers
  float* yns = tiles + 2 * kTile * kLd;          // [2][kTile]

  const int b = blockIdx.y, row0 = blockIdx.x * R, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, N = p.N;
  const int group = warp / kGroupWarps, half = warp % kGroupWarps;  // this warp's rows and candidates
  const float* xb = p.x + (size_t)b * N * p.C;
  const float* nb = p.nrm + (size_t)b * N;

  const int nc = (p.C + kCh - 1) / kCh, nt = (N + kTile - 1) / kTile, steps = nt * nc;
  const auto width = [&](int h) { return min(kCh, p.Cq - h * kCh); };
  stage<THREADS>(p, xb, nb, 0, 0, width(0), tiles, yns);

  for (int e = tid; e < R * p.Cq; e += THREADS) {  // the rows' channels, 0 past C and N
    const int r = e / p.Cq, c = e - r * p.Cq;
    q[e] = row0 + r < N && c < p.C ? xb[(size_t)(row0 + r) * p.C + c] : 0.f;
  }
  float* my = rows + (size_t)group * kRW * p.N4;  // this warp's rows
  for (int e = N + lane + 32 * half; e < p.N4; e += 32 * kGroupWarps) {
#pragma unroll
    for (int r = 0; r < kRW; ++r) my[r * p.N4 + e] = INFINITY;
  }
  float qn[kRW], m[kRW];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int i = row0 + group * kRW + r;
    qn[r] = i < N ? nb[i] : 0.f;
    m[r] = INFINITY;
  }

  float acc[kRW][kCT];
  for (int s = 0; s < steps; ++s) {
    const int t = s / nc, h = s - t * nc, cw = width(h);
    if (s + 1 < steps) {
      const int t1 = (s + 1) / nc, h1 = s + 1 - t1 * nc;
      stage<THREADS>(p, xb, nb, t1 * kTile, h1 * kCh, width(h1), tiles + ((s + 1) & 1) * kTile * kLd,
                     yns + (t1 & 1) * kTile);
      pca::cp_async_wait<1>();
    } else {
      pca::cp_async_wait<0>();
    }
    __syncthreads();  // step s's tile (and, at s = 0, q) is in place
    if (h == 0) {
#pragma unroll
      for (int r = 0; r < kRW; ++r)
#pragma unroll
        for (int v = 0; v < kCT; ++v) acc[r][v] = 0.f;
    }
    const float* tb = tiles + (s & 1) * kTile * kLd + (half * 32 * kCT + lane) * kLd;
    const float* qw = q + (size_t)group * kRW * p.Cq + h * kCh;
    if (cw == kCh) {  // a whole chunk: unrolled, so the loads run ahead of the products
#pragma unroll
      for (int c = 0; c < kCh; c += 4) channels4(acc, qw + c, p.Cq, tb + c);
    } else {
#pragma unroll 2
      for (int c = 0; c < cw; c += 4) channels4(acc, qw + c, p.Cq, tb + c);
    }
    if (h == nc - 1) {  // tile t is complete: its distances into the rows
      const float* yn = yns + (t & 1) * kTile + half * 32 * kCT + lane;
#pragma unroll
      for (int v = 0; v < kCT; ++v) {
        const int j = t * kTile + half * 32 * kCT + lane + 32 * v;
        if (j >= N) continue;
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const float d = __fadd_rn(__fsub_rn(qn[r], __fmul_rn(2.0f, acc[r][v])), yn[32 * v]);
          my[r * p.N4 + j] = d;
          m[r] = fminf(m[r], d);
        }
      }
    }
    __syncthreads();  // every read of this tile and its norms is done before they are restaged
  }
#pragma unroll
  for (int r = 0; r < kRW; ++r) mins[(group * kRW + r) * kShares + half * 32 + lane] = m[r];
  __syncthreads();  // the rows and their share minima are complete
  float* bufv = tiles + warp * 2 * pca::sel::kCap;  // the tiles are free now
  int* bufi = reinterpret_cast<int*>(bufv + pca::sel::kCap);
#pragma unroll 1
  for (int u = 0; u < PER; ++u) {
    const int r = warp * PER + u, i = row0 + r;
    if (i >= N) break;
    pca::sel::select_row(rows + (size_t)r * p.N4, N, p.N4, p.k, mins + r * kShares, bufv, bufi,
                         p.out + ((size_t)b * N + i) * p.k);
  }
}

template <int WARPS>
cudaError_t launch(const KnnArgs& a, int B, cudaStream_t s) {
  static_assert(2 * kTile * kLd >= WARPS * 2 * pca::sel::kCap, "the selection's buffers fit in the tiles");
  const size_t smem = knn_smem(WARPS, a.N4, a.Cq);
  cudaError_t e = cudaFuncSetAttribute(knn_kernel<WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  constexpr int R = WARPS / kGroupWarps * kRW;
  const dim3 grid((a.N + R - 1) / R, B);
  knn_kernel<WARPS><<<grid, WARPS * 32, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  x [B, N, C]
// f32; nrm [B, N] f32 scratch; out [B, N, k] int32.  1 <= C <= 128,
// 1 <= k <= N <= 4096.  Returns a cudaError_t code (0 on success).
int pca_knn(int device, const void* x, void* nrm, int B, int N, int C, int k, void* out, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || N > kMaxPoints || C < 1 || C > kMaxChannels || k < 1 || k > N)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* nf = static_cast<float*>(nrm);
  sqnorm_kernel<<<(B * N + 255) / 256, 256, 0, s>>>(xf, B * N, C, nf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const KnnArgs a = {xf, nf, static_cast<int*>(out), N, C, k, (N + 3) & ~3, (C + 3) & ~3,
                     C % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0};
  // as many rows a block as 128 KB of distance rows hold, 8 to 32
  const int rows = a.N4 * 32 <= kRowFloats ? 32 : a.N4 * 16 <= kRowFloats ? 16 : 8;
  return (int)(rows == 32 ? launch<16>(a, B, s) : rows == 16 ? launch<8>(a, B, s) : launch<4>(a, B, s));
}

}  // extern "C"
