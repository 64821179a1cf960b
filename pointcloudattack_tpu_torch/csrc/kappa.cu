// GeoA3's curvature term for Hopper (sm_90a): a self-kNN and the mean
// |unit(a_j - a_i) . n_i| over each point's k neighbours, forward and
// backward.  Plain C interface, loaded with ctypes by
// pointcloudattack_tpu_torch/ops/kappa.py.
//
// Replaces the TPU kernels pointcloudattack_tpu/ops/pallas/kappa_kernel.py::
// _kappa_fwd (pallas_call at :321, body _kappa_fwd_kernel, the default pick
// loop) and _kappa_bwd (pallas_call at :358, body _kappa_bwd_kernel and
// _bwd_scatter_core), reached from kappa_knn_mean (:390): once per GeoA3
// attack on the clean cloud and, under grad, once per iteration on the
// adversarial one.
//
// Forward.  For a [B, N, 3] and normals n [B, N, 3]: each row's k + 1
// smallest (distance, index) pairs in lexicographic order, the first (the
// point itself, or a copy of it at a lower index) dropped; then
//   kappa_i = (1/k) sum_t |n_i . a_j - n_i . a_i| / (sqrt(d_ij) + 1e-12)
// over the k kept picks j in pick order, a pick at distance 0 adding 0.  It
// writes kappa [B, N] and the k picks [B, N, k] int32, which the backward
// reads in place of the TPU kernel's four boundary scalars.
//
// Backward.  With w = dkappa_i / k, s = sign(num), num = n_i . a_j -
// n_i . a_i, rn = sqrt(d_ij), rr = rn + 1e-12, for each kept pick at d > 0:
// alpha = w s / rr and beta = -(w s num) / (rr^2 rn), the edge term
// e = alpha n_i + beta (a_j - a_i); then dnormal_i = sum_t alpha (a_j - a_i)
// and dadv = (sum of e over the edges into j) - (sum of e over the edges out
// of i).
//
// Numerics.  Distances are sqdist_common.cuh's sqdist3; the projections
// ((n0 a0 + n1 a1) + n2 a2), the square root, the divisions and every sum
// are rounded on their own (__f*_rn), in the plain version's order; the
// selection is lexicographic, so its picks equal the plain version's stable
// sort, ties and exact duplicates included.  The sums over a row's picks
// run in pick order and the sum of the edges into j in ascending (i, t), the
// order of the plain version's index_add_ on the CPU: kernel and plain
// version give the same bits, and a run gives the same bits every time.
//
// What bounds it on this card.  At GeoA3's shape (B=8, N=1024, k=16) the
// forward's distances are 8.4 M pairs at 8 operations, its selection at
// least one compare a pair, and its contributions 131 K edges: about 76 M
// operations, 0.001 ms at the FP32 rate, against 0.3 MB of input and
// output.  The backward is 131 K edges of about 40 operations and the
// N * k index compares of each pulled point.  Latency bounds both here.
//
// What the design does about it.
//   * Forward: a block owns 8 rows of one cloud and keeps their 8 x N exact
//     distances in shared memory (the [N, N] matrix never reaches device
//     memory); one warp a row runs k + 1 warp-wide passes, pass t taking the
//     smallest pair above pass t-1's, as csrc/knn.cu selects; the row's lane
//     0 then forms the k contributions from the stored distance and the
//     neighbour's coordinates.
//   * Backward: a thread a row forms its k edge terms, writes them to a
//     [B, N, k, 3] scratch and sums the row's own side; then a thread a
//     point pulls the edges that point at it, scanning the cloud's picks
//     staged in shared memory: no atomics.

#include "sqdist_common.cuh"

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows per forward block: one warp each
constexpr int kMaxK = 64;
constexpr int kMaxPoints = 4096;
constexpr int kPullThreads = 128;
constexpr int kIdxTile = 4096;  // picks per staged tile: 16 KB
constexpr float kEps = 1e-12f;

// (v, i) comes after (pv, pi) in (distance, index) order.
__device__ __forceinline__ bool after(float v, int i, float pv, int pi) {
  return v > pv || (v == pv && i > pi);
}

// (v, i) comes before (bv, bi).
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// n . p, summed in ascending coordinate order, each product and sum rounded.
__device__ __forceinline__ float dot3(const float* n, const float* p) {
  return __fadd_rn(__fadd_rn(__fmul_rn(n[0], p[0]), __fmul_rn(n[1], p[1])), __fmul_rn(n[2], p[2]));
}

__global__ void __launch_bounds__(kThreads)
    kappa_fwd_kernel(const float* __restrict__ a, const float* __restrict__ nrm, int N, int k,
                     float* __restrict__ kap, int* __restrict__ picks_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* picks = reinterpret_cast<int*>(smem);                   // [kRows][kMaxK + 1]
  float* dist = reinterpret_cast<float*>(picks + kRows * (kMaxK + 1));  // [kRows][N]

  const int b = blockIdx.y, row0 = blockIdx.x * kRows, tid = threadIdx.x;
  const float* ab = a + (size_t)b * N * 3;
  float q[kRows][3];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = min(row0 + r, N - 1);  // a row past the end computes a copy and writes nothing
    q[r][0] = ab[3 * i];
    q[r][1] = ab[3 * i + 1];
    q[r][2] = ab[3 * i + 2];
  }
  for (int j = tid; j < N; j += kThreads) {
    const float p0 = ab[3 * j], p1 = ab[3 * j + 1], p2 = ab[3 * j + 2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dist[r * N + j] = pca::sqdist3(q[r][0], q[r][1], q[r][2], p0, p1, p2);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, row = row0 + warp;
  if (row >= N) return;
  const float* d = dist + warp * N;
  int* pk = picks + warp * (kMaxK + 1);
  float pv = -INFINITY;
  int pi = -1;
  for (int t = 0; t <= k; ++t) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int jj = lane; jj < N; jj += 32) {
      const float v = d[jj];
      if (after(v, jj, pv, pi) && before(v, jj, bv, bi)) {
        bv = v;
        bi = jj;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) pk[t] = bi;
    pv = bv;
    pi = bi;
  }
  if (lane != 0) return;
  const float* ai = ab + 3 * row;
  const float* ni = nrm + ((size_t)b * N + row) * 3;
  const float mii = dot3(ni, ai);
  int* out = picks_out + ((size_t)b * N + row) * k;
  float acc = 0.f;
  for (int t = 1; t <= k; ++t) {
    const int j = pk[t];
    const float dj = d[j];
    float c = 0.f;
    if (dj > 0.f) {
      const float num = __fsub_rn(dot3(ni, ab + 3 * j), mii);
      c = __fdiv_rn(fabsf(num), __fadd_rn(__fsqrt_rn(dj), kEps));
    }
    acc = t == 1 ? c : __fadd_rn(acc, c);
    out[t - 1] = j;
  }
  kap[(size_t)b * N + row] = __fdiv_rn(acc, (float)k);
}

// One thread a row: its k edge terms into e [B, N, k, 3], the row's own
// side (the sum of its e) into ctr and its normal's gradient into dnrm.
__global__ void __launch_bounds__(kThreads)
    kappa_edge_kernel(const float* __restrict__ a, const float* __restrict__ nrm, const int* __restrict__ picks,
                      const float* __restrict__ dkap, int B, int N, int k, float* __restrict__ e,
                      float* __restrict__ ctr, float* __restrict__ dnrm) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= B * N) return;
  const int b = r / N;
  const float* ab = a + (size_t)b * N * 3;
  const float* ai = a + (size_t)r * 3;
  const float* ni = nrm + (size_t)r * 3;
  const float mii = dot3(ni, ai);
  const float w = __fdiv_rn(dkap[r], (float)k);
  float c[3] = {0.f, 0.f, 0.f}, dn[3] = {0.f, 0.f, 0.f};
  for (int t = 0; t < k; ++t) {
    const int j = picks[(size_t)r * k + t];
    const float* aj = ab + 3 * j;
    const float d = pca::sqdist3(ai[0], ai[1], ai[2], aj[0], aj[1], aj[2]);
    const float num = __fsub_rn(dot3(ni, aj), mii);
    const float s = num > 0.f ? 1.f : (num < 0.f ? -1.f : 0.f);
    float alpha = 0.f, beta = 0.f;
    if (d > 0.f) {
      const float rn = __fsqrt_rn(d), rr = __fadd_rn(rn, kEps), ws = __fmul_rn(w, s);
      alpha = __fdiv_rn(ws, rr);
      beta = __fdiv_rn(-__fmul_rn(ws, num), __fmul_rn(__fmul_rn(rr, rr), rn));
    }
    float* et = e + ((size_t)r * k + t) * 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float v = __fsub_rn(aj[q], ai[q]);
      const float eq = __fadd_rn(__fmul_rn(alpha, ni[q]), __fmul_rn(beta, v));
      const float nq = __fmul_rn(alpha, v);
      et[q] = eq;
      c[q] = t == 0 ? eq : __fadd_rn(c[q], eq);
      dn[q] = t == 0 ? nq : __fadd_rn(dn[q], nq);
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    ctr[(size_t)r * 3 + q] = c[q];
    dnrm[(size_t)r * 3 + q] = dn[q];
  }
}

// One thread a point j: the edges (i, t) of its cloud whose pick is j, in
// ascending (i, t), summed from 0; dadv_j = that sum - ctr_j.
__global__ void __launch_bounds__(kPullThreads)
    kappa_pull_kernel(const int* __restrict__ picks, const float* __restrict__ e, const float* __restrict__ ctr,
                      int N, int k, float* __restrict__ dadv) {
  __shared__ int tile[kIdxTile];
  const int b = blockIdx.y, j = blockIdx.x * kPullThreads + threadIdx.x;
  const int edges = N * k;
  const int* pb = picks + (size_t)b * edges;
  const float* eb = e + (size_t)b * edges * 3;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int e0 = 0; e0 < edges; e0 += kIdxTile) {
    const int ne = min(kIdxTile, edges - e0);
    __syncthreads();  // the previous tile's reads are done
    for (int q = threadIdx.x; q < ne; q += kPullThreads) tile[q] = pb[e0 + q];
    __syncthreads();
    if (j >= N) continue;
    for (int q = 0; q < ne; ++q) {
      if (tile[q] != j) continue;
      const float* eq = eb + (size_t)(e0 + q) * 3;
      s0 = __fadd_rn(s0, eq[0]);
      s1 = __fadd_rn(s1, eq[1]);
      s2 = __fadd_rn(s2, eq[2]);
    }
  }
  if (j >= N) return;
  const size_t o = ((size_t)b * N + j) * 3;
  dadv[o] = __fsub_rn(s0, ctr[o]);
  dadv[o + 1] = __fsub_rn(s1, ctr[o + 1]);
  dadv[o + 2] = __fsub_rn(s2, ctr[o + 2]);
}

size_t fwd_smem(int N) {
  return sizeof(int) * (size_t)kRows * (kMaxK + 1) + sizeof(float) * (size_t)kRows * N;
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  a, nrm
// [B, N, 3] f32; kap [B, N] f32; picks [B, N, k] int32.  1 <= k <= 64,
// k + 1 <= N <= 4096.  Returns a cudaError_t code (0 on success).
int pca_kappa_fwd(int device, const void* a, const void* nrm, int B, int N, int k, void* kap, void* picks,
                  void* stream) {
  if (B < 1 || B > 65535 || k < 1 || k > kMaxK || k + 1 > N || N > kMaxPoints) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fwd_smem(N);
  e = cudaFuncSetAttribute(kappa_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kRows - 1) / kRows, B);
  kappa_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(nrm), N, k, static_cast<float*>(kap),
      static_cast<int*>(picks));
  return (int)cudaGetLastError();
}

// a, nrm [B, N, 3] f32; picks [B, N, k] int32 from the forward; dkap [B, N]
// f32; e [B, N, k, 3] and ctr [B, N, 3] f32 scratch; dnrm and dadv [B, N, 3]
// f32 outputs.  Returns a cudaError_t code (0 on success).
int pca_kappa_bwd(int device, const void* a, const void* nrm, const void* picks, const void* dkap, int B, int N,
                  int k, void* e, void* ctr, void* dnrm, void* dadv, void* stream) {
  if (B < 1 || B > 65535 || k < 1 || k > kMaxK || k + 1 > N || N > kMaxPoints) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kappa_edge_kernel<<<(B * N + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(nrm), static_cast<const int*>(picks),
      static_cast<const float*>(dkap), B, N, k, static_cast<float*>(e), static_cast<float*>(ctr),
      static_cast<float*>(dnrm));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kPullThreads - 1) / kPullThreads, B);
  kappa_pull_kernel<<<grid, kPullThreads, 0, s>>>(static_cast<const int*>(picks), static_cast<const float*>(e),
                                                  static_cast<const float*>(ctr), N, k, static_cast<float*>(dadv));
  return (int)cudaGetLastError();
}

}  // extern "C"
