// The gather + one-layer chain + max over each group's K neighbours, with
// its first (and only) layer run once a point, and its input gradients
// without atomics, for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by pointcloudattack_tpu_torch/ops/gather_hoist.py.
//
// Replaces, for a chain of one layer with the max pool and no activation
// on the built rows (DGCNN's EdgeConvs, CurveNet's initial LPFA), the TPU
// kernels of pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py:
//   forward  _gather_fwd_pallas (pallas_call at :550, body _gather_fwd_kernel)
//   backward _gather_bwd_pallas (pallas_call at :641, body _gather_bwd_kernel)
// reached through gather_chain_groupmax.  gather_chain.cu keeps the rest
// of that op (longer chains, the mean, the ball query).
//
// The layer is affine in the built row, and every segment of the row is a
// slice of one source point's features, of one center's, or their
// difference, so W . row(i, k) = P[idx[i, k]] + Q[i], with P = src . W_src
// over the B*N source points and Q = ctr . W_ctr over the B*G centers
// (W_src sums the weight rows of the diff and pass segments at their source
// columns, W_ctr those of the center segments minus the diff segments' at
// their center columns; the wrapper folds them).  Four kernels (lists from
// hoist_common.cuh, which ball_hoist.cu shares; the ball route launches
// this file's product too):
//   product     out = a . w, f32 FFMA, a [R, Kd] and w [Kd, M]; up to two
//               such products in one launch.  Forward: P and Q (one product
//               of width 2 * C when the sources are the centers); backward:
//               dsrc = dP . W_src^T and dctr = dQ . W_ctr^T.
//   max         y[b, i, c] = max_k BN(P[b, idx[b, i, k], c] + Q[b, i, c]),
//               am the lowest k attaining it, BN(v) = ((v + bias) - mean) *
//               mul + beta, each operation rounded on its own (no FMA), so
//               it is bit-equal to the plain version on the same P and Q.
//   lists       each source point's reverse neighbour list: the pairs
//               (i, k) with idx[b, i, k] = j, in ascending (i, k), as a
//               stable counting sort, each stored as (i << s) | k with s
//               the bit length of K - 1 (a shift and a mask to read);
//               start [B, N + 1] and list [B, G * K].
//   pull        dP[b, j, c] = the sum over j's list, in its order, of
//               g[b, i, c] where am[b, i, c] == k (and dQ = g).
// Every sum has a fixed order and no atomic touches a float, so two calls
// on the same inputs give the same bits.
//
// What bounds it on this card.  At DGCNN's four EdgeConvs (B=16, N=G=1024,
// K=20, C = 3/64/64/128 -> 64/64/128/256) the products are 2.97 GFLOP a
// forward (0.044 ms at the FP32 peak; the per-row kernel did 20x that); the
// max reads K rows of P a center and unit from L2 (one cloud's P is at most
// 1 MB, all of it at B=16 16.7 MB, inside the 50 MB L2) and writes y and
// am: bytes bound it; the pull reads am for every list entry and g only
// where it hits: bytes again.
//
// What the design does about it.
//   * product: 128 x 64 output tiles, 256 threads each holding an 8 x 4
//     register tile; the [128 x 16] and [16 x 64] operand tiles stream into
//     shared memory with 4-byte cp.async, double-buffered, zero-filled past
//     the edges (any Kd, 3 included, no padded copy); the a tile is stored
//     transposed so a thread reads its 8 rows as two float4; w is read in
//     place with its strides, so the backward's W^T needs no copy.  Tensor cores
//     would not pay: the whole product is 0.044 ms at the FP32 peak, and
//     the port runs with TF32 off.
//   * max: one block a cloud and 16 centers, their idx in shared memory,
//     threads across the units, four adjacent units a thread where the
//     widths allow, so each P row is read coalesced in float4.
//   * lists: one block a cloud, 1024 threads; each of up to 32 warps takes a
//     contiguous part of the entries, counts them by point in shared memory
//     (a count per part and point), then places them in order,
//     __match_any_sync ranking the lanes that share a point.
//   * pull: threads across (point, unit), each walking its point's list with
//     eight entries' loads in flight at once, adding in the list's order.
//     A hub point's list (hundreds of entries in a feature-space kNN) sets
//     the kernel's time: its walk is one thread's.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "hoist_common.cuh"

// The product kernel (P and Q forward, dsrc and dctr backward; the ball
// route of ball_hoist.py launches it here too, through pca_hoist_product).
namespace pca {
namespace hoist {
namespace {

constexpr int kBM = 128, kBN = 64, kBK = 16;  // product tile
constexpr int kTM = 8, kTN = 4;               // per thread: 16 x 16 threads

struct Product {
  const float* a;  // [R, Kd], row stride lda
  const float* w;  // [Kd, M], element (k, n) at w[k * wk + n * wn]
  float* out;      // [R, M] row-major
  int R, Kd, M, lda, wk, wn, tiles_n;
};

struct Products {
  Product p0, p1;
  int first1;  // the first block of p1 (all blocks belong to p0 when there is no p1)
};

__global__ void __launch_bounds__(kThreads) product_kernel(Products ps) {
  __shared__ __align__(16) float As[2][kBK][kBM + 4];  // transposed a tile, padded
  __shared__ __align__(16) float Ws[2][kBK][kBN + 4];  // padded: the transposed fill writes down columns
  const bool second = (int)blockIdx.x >= ps.first1;
  const Product p = second ? ps.p1 : ps.p0;
  const int tile = blockIdx.x - (second ? ps.first1 : 0);
  const int r0 = (tile / p.tiles_n) * kBM, c0 = (tile % p.tiles_n) * kBN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + kThreads * i, m = e >> 4, k = e & 15;
      const int r = r0 + m, kk = k0 + k;
      const bool ok = r < p.R && kk < p.Kd;
      cp_async4(&As[buf][k][m], ok ? p.a + (size_t)r * p.lda + kk : p.a, ok ? 4 : 0);
    }
    const bool rows = p.wn == 1;  // neighbouring threads on neighbouring addresses: along n, or along k
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int e = tid + kThreads * i, k = rows ? e >> 6 : e & 15, n = rows ? e & 63 : e >> 4;
      const int kk = k0 + k, c = c0 + n;
      const bool ok = kk < p.Kd && c < p.M;
      cp_async4(&Ws[buf][k][n], ok ? p.w + (size_t)kk * p.wk + (size_t)c * p.wn : p.w, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int nk = (p.Kd + kBK - 1) / kBK;
  load(0, 0);
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) {
      load(buf ^ 1, (t + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * kTM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Ws[buf][kk][tx * kTN]);
      const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled by the next step's load
  }

  const int c = c0 + tx * kTN;
  const bool vec = (p.M & 3) == 0 && c + kTN <= p.M;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty * kTM + i;
    if (r >= p.R) break;
    float* o = p.out + (size_t)r * p.M + c;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (c + j < p.M) o[j] = acc[i][j];
    }
  }
}

bool bad_product(const void* a, const void* w, const void* o, int R, int Kd, int M, int lda, int wk, int wn) {
  return !a || !w || !o || R < 1 || Kd < 1 || M < 1 || lda < Kd || wk < 0 || wn < 0;
}

Product make_product(const void* a, const void* w, void* o, int R, int Kd, int M, int lda, int wk, int wn) {
  return {static_cast<const float*>(a), static_cast<const float*>(w), static_cast<float*>(o), R, Kd, M, lda, wk, wn,
          (M + kBN - 1) / kBN};
}

int tiles(const Product& p) { return ((p.R + kBM - 1) / kBM) * p.tiles_n; }

// out_i = a_i . w_i for the nprob (1 or 2) products given, in one launch
// (the C entry points' argument order); returns a cudaError_t.
cudaError_t launch_products(int device, int nprob, const void* a0, const void* w0, void* o0, int r0, int k0, int m0,
                            int lda0, int wk0, int wn0, const void* a1, const void* w1, void* o1, int r1, int k1,
                            int m1, int lda1, int wk1, int wn1, void* stream) {
  if (nprob < 1 || nprob > 2 || bad_product(a0, w0, o0, r0, k0, m0, lda0, wk0, wn0) ||
      (nprob == 2 && bad_product(a1, w1, o1, r1, k1, m1, lda1, wk1, wn1)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  Products ps;
  ps.p0 = make_product(a0, w0, o0, r0, k0, m0, lda0, wk0, wn0);
  ps.p1 = nprob == 2 ? make_product(a1, w1, o1, r1, k1, m1, lda1, wk1, wn1) : ps.p0;
  ps.first1 = tiles(ps.p0);
  const long long blocks = (long long)ps.first1 + (nprob == 2 ? tiles(ps.p1) : 0);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  product_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(ps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hoist
}  // namespace pca

namespace {

constexpr int kThreads = 256;
constexpr int kTileG = 16;                    // centers a block of the max
constexpr int kPullDepth = 8;                 // list entries a pull thread loads at once
constexpr size_t kMaxSmem = 232448;           // 227 KB opt-in per block on sm_90

struct MaxArgs {
  const float* p;  // P [B*N, C] at row stride sp
  const float* q;  // Q [B*G, C] at row stride sq
  const int* idx;  // [B, G, K]
  const float *bias, *mean, *mul, *beta;  // [C]
  float* y;        // [B, G, C]
  int* am;         // [B, G, C]
  int sp, sq, N, G, K, C;
};

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using F = float;
  using I = int;
  static __device__ __forceinline__ float get(const F& v, int) { return v; }
  static __device__ __forceinline__ void set(F& v, int, float x) { v = x; }
  static __device__ __forceinline__ void set(I& v, int, int x) { v = x; }
};
template <>
struct Vec<4> {
  using F = float4;
  using I = int4;
  static __device__ __forceinline__ float get(const F& v, int u) { return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w; }
  static __device__ __forceinline__ void set(F& v, int u, float x) { (u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w) = x; }
  static __device__ __forceinline__ void set(I& v, int u, int x) { (u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w) = x; }
};

// V consecutive units a thread: 4 (float4 loads and stores) when C, the row
// strides and the pointers allow it, else 1.
template <int V>
__global__ void __launch_bounds__(kThreads) max_kernel(MaxArgs a) {
  using F = typename Vec<V>::F;
  using I = typename Vec<V>::I;
  extern __shared__ int idx_s[];  // [kTileG][K]
  const int b = blockIdx.y, g0 = blockIdx.x * kTileG;
  const int ng = min(kTileG, a.G - g0);
  const int* id = a.idx + ((size_t)b * a.G + g0) * a.K;
  for (int e = threadIdx.x; e < ng * a.K; e += kThreads) idx_s[e] = id[e];
  __syncthreads();
  const float* pb = a.p + (size_t)b * a.N * a.sp;
  const int cv = a.C / V;
  for (int e = threadIdx.x; e < ng * cv; e += kThreads) {
    const int lg = e / cv, c = (e - lg * cv) * V;
    const size_t o = ((size_t)b * a.G + g0 + lg) * a.C + c;
    const F qv = *reinterpret_cast<const F*>(a.q + ((size_t)b * a.G + g0 + lg) * a.sq + c);
    float bb[V], mm[V], mu[V], be[V], best[V];
    int arg[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      bb[u] = a.bias[c + u]; mm[u] = a.mean[c + u]; mu[u] = a.mul[c + u]; be[u] = a.beta[c + u];
      best[u] = -INFINITY;
      arg[u] = 0;
    }
    const int* row = idx_s + lg * a.K;
#pragma unroll 4
    for (int k = 0; k < a.K; ++k) {
      const int j = row[k];
      const bool ok = (unsigned)j < (unsigned)a.N;  // idx lies in [0, N); nothing outside is read
      const F pv = *reinterpret_cast<const F*>(pb + (size_t)(ok ? j : 0) * a.sp + c);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float z = __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(__fadd_rn(Vec<V>::get(pv, u), Vec<V>::get(qv, u)),
                                                                bb[u]), mm[u]), mu[u]), be[u]);
        if (ok && (z > best[u] || k == 0)) {  // strict: a tie keeps the lowest k
          best[u] = z;
          arg[u] = k;
        }
      }
    }
    F yv;
    I av;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      Vec<V>::set(yv, u, best[u]);
      Vec<V>::set(av, u, arg[u]);
    }
    *reinterpret_cast<F*>(a.y + o) = yv;
    *reinterpret_cast<I*>(a.am + o) = av;
  }
}

// Cloud b's entries are its G * K slots in (i, k) order: each names the
// point idx[b, i, k] and is stored as (i << ks) | k.
struct IdxEntries {
  const int* idx;  // [B, G * K]
  int E, K, ks;
  __device__ int count(int) const { return E; }
  __device__ int key(int b, int e) const { return idx[(size_t)b * E + e]; }
  __device__ int payload(int, int e) const { return ((e / K) << ks) | (e % K); }
  __device__ size_t base(int b) const { return (size_t)b * E; }
};

struct PullArgs {
  const int* start;  // [B, N + 1]
  const int* list;   // [B, G*K], entries (i << ks) | k
  const int* am;     // [B, G, C]
  const float* g;    // [B, G, C]
  float* dp;         // [B, N, C]
  int N, G, K, ks, C, pts;
};

__global__ void __launch_bounds__(kThreads) pull_kernel(PullArgs a) {
  const int b = blockIdx.y, j0 = blockIdx.x * a.pts;
  const int* st = a.start + (size_t)b * (a.N + 1);
  const int* ls = a.list + (size_t)b * a.G * a.K;
  const int* amb = a.am + (size_t)b * a.G * a.C;
  const float* gb = a.g + (size_t)b * a.G * a.C;
  const int kmask = (1 << a.ks) - 1;
  for (int e = threadIdx.x; e < a.pts * a.C; e += kThreads) {
    const int lj = e / a.C, c = e - lj * a.C, j = j0 + lj;
    if (j >= a.N) break;  // e only grows
    float acc = 0.f;
    int s = st[j];
    const int s1 = st[j + 1];
    for (; s + kPullDepth <= s1; s += kPullDepth) {  // the loads of kPullDepth entries in flight together
      int o[kPullDepth];
      bool hit[kPullDepth];
      float gv[kPullDepth];
#pragma unroll
      for (int u = 0; u < kPullDepth; ++u) {
        const int ent = ls[s + u];
        o[u] = (ent >> a.ks) * a.C + c;
        hit[u] = amb[o[u]] == (ent & kmask);
      }
#pragma unroll
      for (int u = 0; u < kPullDepth; ++u) gv[u] = hit[u] ? gb[o[u]] : 0.f;
#pragma unroll
      for (int u = 0; u < kPullDepth; ++u)
        if (hit[u]) acc = __fadd_rn(acc, gv[u]);
    }
    for (; s < s1; ++s) {
      const int ent = ls[s], o = (ent >> a.ks) * a.C + c;
      if (amb[o] == (ent & kmask)) acc = __fadd_rn(acc, gb[o]);
    }
    a.dp[((size_t)b * a.N + j) * a.C + c] = acc;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// out_i = a_i . w_i for the nprob (1 or 2) products given, in one launch:
// a_i [R_i, Kd_i] f32 at row stride lda_i (>= Kd_i), w_i [Kd_i, M_i] f32
// with element (k, n) at w_i[k * wk_i + n * wn_i] (a transposed view
// needs no copy), out_i [R_i, M_i] f32 row-major.  The second product's
// arguments are unread when nprob is 1.  Returns a cudaError_t code.
int pca_hoist_product(int device, int nprob, const void* a0, const void* w0, void* o0, int r0, int k0, int m0,
                      int lda0, int wk0, int wn0, const void* a1, const void* w1, void* o1, int r1, int k1, int m1,
                      int lda1, int wk1, int wn1, void* stream) {
  return pca::hoist::launch_products(device, nprob, a0, w0, o0, r0, k0, m0, lda0, wk0, wn0, a1, w1, o1, r1, k1,
                                     m1, lda1, wk1, wn1, stream);
}

// y / am [B, G, C] (f32 / int32) of the max over each group's K rows of
// BN(P[b, idx[b, i, k]] + Q[b, i]): p [B*N, C] f32 at row stride sp, q
// [B*G, C] f32 at row stride sq, idx [B, G, K] int32 in [0, N), bias,
// mean, mul and beta [C] f32.  Returns a cudaError_t code.
int pca_hoist_max(int device, const void* p, int sp, const void* q, int sq, const void* idx, const void* bias,
                  const void* mean, const void* mul, const void* beta, int B, int N, int G, int K, int C, void* y,
                  void* am, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || G < 1 || K < 1 || C < 1 || sp < C || sq < C) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)kTileG * K;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  MaxArgs a = {static_cast<const float*>(p), static_cast<const float*>(q), static_cast<const int*>(idx),
               static_cast<const float*>(bias), static_cast<const float*>(mean), static_cast<const float*>(mul),
               static_cast<const float*>(beta), static_cast<float*>(y), static_cast<int*>(am), sp, sq, N, G, K, C};
  const bool vec = C % 4 == 0 && sp % 4 == 0 && sq % 4 == 0 && aligned16(p) && aligned16(q) && aligned16(y) &&
                   aligned16(am);
  const dim3 grid((G + kTileG - 1) / kTileG, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = vec ? cudaFuncSetAttribute(max_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
          : cudaFuncSetAttribute(max_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (vec)
    max_kernel<4><<<grid, kThreads, smem, s>>>(a);
  else
    max_kernel<1><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The parts the reverse-list build splits a cloud's entries into at N
// points (0: N is too large for one block's shared memory).
int pca_hoist_lists_parts(int N) { return N < 1 ? 0 : pca::hoist::lists_parts(N); }

// The reverse neighbour lists of idx [B, G, K] int32 in [0, N): start
// [B, N + 1] int32 (point j's entries are list[b, start[b, j] : start[b,
// j + 1]]) and list [B, G*K] int32, the entries (i << ks) | k with
// idx[b, i, k] = j in ascending (i, k); ks is the bit length of K - 1.
// parts from pca_hoist_lists_parts(N).  Returns a cudaError_t code.
int pca_hoist_lists(int device, const void* idx, int B, int N, int G, int K, int ks, int parts, void* start,
                    void* list, void* stream) {
  if (B < 1 || N < 1 || G < 1 || K < 1 || parts < 1 || parts > pca::hoist::lists_parts(N) || ks < 0 || ks > 30 ||
      (1LL << ks) < K || ((long long)G << ks) > 0x7fffffffLL || (long long)G * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const IdxEntries src = {static_cast<const int*>(idx), G * K, K, ks};
  return (int)pca::hoist::launch_lists(src, B, N, parts, static_cast<int*>(start), static_cast<int*>(list),
                                       static_cast<cudaStream_t>(stream));
}

// dP [B, N, C] f32: for each point j, the sum over its list (start, list
// from pca_hoist_lists with the same ks), in order, of g[b, i, c] where
// am[b, i, c] == k, for the entry (i << ks) | k; am int32 and g f32 [B, G,
// C].  Returns a cudaError_t code.
int pca_hoist_pull(int device, const void* start, const void* list, const void* am, const void* g, int B, int N,
                   int G, int K, int ks, int C, void* dp, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || G < 1 || K < 1 || C < 1 || ks < 0 || ks > 30 || (1LL << ks) < K ||
      (long long)G * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int pts = C >= kThreads ? 1 : kThreads / C;
  PullArgs a = {static_cast<const int*>(start), static_cast<const int*>(list), static_cast<const int*>(am),
                static_cast<const float*>(g), static_cast<float*>(dp), N, G, K, ks, C, pts};
  const dim3 grid((N + pts - 1) / pts, B);
  pull_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
