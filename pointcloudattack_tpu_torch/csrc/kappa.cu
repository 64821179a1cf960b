// GeoA3's curvature term for Hopper (sm_90a): the mean |unit(a_j - a_i) .
// n_i| over each point's k neighbours, forward and backward, with the
// neighbours chosen by an in-kernel self-kNN or given by the caller.  Plain
// C interface, loaded with ctypes by pointcloudattack_tpu_torch/ops/kappa.py.
//
// Replaces the TPU kernels pointcloudattack_tpu/ops/pallas/kappa_kernel.py::
// _kappa_fwd (pallas_call at :321, body _kappa_fwd_kernel, the default pick
// loop) and _kappa_bwd (pallas_call at :358, body _kappa_bwd_kernel and
// _bwd_scatter_core), reached from kappa_knn_mean (:390): once per GeoA3
// attack on the clean cloud and, under grad, once per iteration on the
// adversarial one.  And, for a given [B, N, k] neighbour set (GeoA3's
// curv_knn_refresh > 1 cache and its partial mode), _kappa_idx_fwd
// (pallas_call at :500, body _kappa_idx_fwd_kernel) and _kappa_idx_bwd
// (pallas_call at :525, body _kappa_idx_bwd_kernel), reached from
// kappa_knn_mean_from_idx (:554): under grad, once per iteration.
//
// Forward.  For a [B, N, 3] and normals n [B, N, 3]: each row's k + 1
// smallest (distance, index) pairs in lexicographic order, the first (the
// point itself, or a copy of it at a lower index) dropped; then
//   kappa_i = (1/k) sum_t |n_i . a_j - n_i . a_i| / (sqrt(d_ij) + 1e-12)
// over the k kept picks j in pick order, a pick at distance 0 adding 0.  It
// writes kappa [B, N] and the k picks [B, N, k] int32, which the backward
// reads in place of the TPU kernel's four boundary scalars.
//
// Forward on a given neighbour set idx [B, N, k] int32: the same sum over
// the row's k columns in slot order (a repeated index adds once per slot),
// each edge formed exactly as above from sqdist3 of the two points.  The
// TPU kernel rebuilt the set as an [R, N] column mask with k compare passes
// over every column, O(N^2) work per cloud for N k edges, because Mosaic
// has no gather; here the lanes of a row read its k indices and gather each
// a_j.  Indices are the caller's precondition, as in the JAX package: in
// [0, N).  An index outside it reads nothing and adds 0, in both
// directions.
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
// output.  The backward is 131 K edges of about 46 operations, 0.0003 ms
// (bytes: the points, normals, dkappa and picks read once, two gradients
// written).  The given-set forward is the same 131 K edges alone, about
// 2.6 M operations against 0.72 MB of indices, points, normals and kappa:
// bytes bound it, at about 0.0002 ms.  Latency bounds all three here: one
// launch is some 0.005 ms.
//
// What the design does about it.
//   * Forward (select_common.cuh's selection, as knn.cu's): a block takes 8
//     warps' rows of one cloud, each warp the fewest rows in turn (1, 2, 4
//     or 8) with which the grid fits the card in one wave (4 at B = 8,
//     N = 1024: 32 rows a block), and stages the cloud in shared memory once
//     (16 KB as float4 at N = 1024); each warp writes its row's exact
//     distances to its own shared row (the [N, N] matrix never reaches
//     device memory), its lanes keeping 64 share minima on the way.  The k+1-th smallest minimum
//     bounds the k+1-th distance; one float4 pass gathers the entries at or
//     below it (a few more than k + 1 on GeoA3's clouds) by ballots, and a
//     bitonic sort across the warp orders them.  Past k + 1 = 64, and for a
//     row with more than 128 entries under the bound (many exact copies of a
//     point), the warp runs k + 1 passes over the row instead.  Then lane t
//     forms the edge term of pick t + 1 (edge_term, its square root and
//     division) and every lane adds the shuffled terms in pick order, so the
//     sum's bits are the plain version's.  Each block holds one row of
//     distances a warp, 60 KB at N = 1024: three blocks an SM.  The earlier
//     design ran k + 1 warp-wide passes over each row, 17 at k = 16, and
//     formed the edges in lane 0 alone (0.1202 ms a call on an H100,
//     against 0.0012).
//   * Given-set forward: the selecting forward's tail on the given set.  A
//     row takes 16 lanes at k <= 16 (32 past it, k > 32 in passes), a
//     block of 1024 threads 64 rows of one cloud (128 blocks at B = 8,
//     N = 1024: one an SM).  Lane t reads slot t first, so the row's indices
//     (one coalesced read) are in flight while the block stages the cloud
//     as float4 in shared memory (16 KB at N = 1024); then it gathers a_j
//     with one shared load, forms edge t with edge_term, and lane_order_sum
//     adds the terms in slot order, as the selecting forward does.  Every
//     step is a latency; the staging replaces a gather through L1, three
//     scattered loads an edge.  The earlier design, a thread a row over 256
//     rows of one cloud staged as floats, put its 16 edges in one serial
//     chain on 32 of the 132 SMs at B = 8.
//   * Backward, for both forwards, two launches and no float atomics: the
//     lists (hoist_common.cuh's stable counting sort of the picks by the
//     point they name, 2048 picks a block: 64 blocks at B=8), then one warp
//     a point (B * N warps, so the card is full at B=8) forms its own k
//     edges and recomputes its incoming ones, about k on average, each from
//     (i, t) with edge_grad.
//     Recomputing costs some 46 operations an edge; keeping the terms
//     instead would need a third launch (every edge formed before any point
//     pulls it) and a [B, N, k, 3] scratch written and read back.

#include "hoist_common.cuh"
#include "select_common.cuh"
#include "sqdist_common.cuh"

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kFwdWarps = 8;  // warps of a forward block, one row each at a time
constexpr int kIdxThreads = 1024;  // a block of the given-set forward: 64 rows of one cloud at k <= 16
constexpr int kMaxK = 64;
constexpr int kMaxPoints = 4096;
constexpr float kEps = 1e-12f;
constexpr int kListEntries = 2048;  // picks a block of the backward's lists sorts
constexpr int kListPart = 256;      // picks a warp of it places
constexpr int kMaxListBlocks = 32;

// n . p, summed in ascending coordinate order, each product and sum rounded.
__device__ __forceinline__ float dot3(const float* n, const float* p) {
  return __fadd_rn(__fadd_rn(__fmul_rn(n[0], p[0]), __fmul_rn(n[1], p[1])), __fmul_rn(n[2], p[2]));
}

__device__ __forceinline__ void load3(const float* p, float (&v)[3]) {
  v[0] = p[0];
  v[1] = p[1];
  v[2] = p[2];
}

// One edge's contribution |n_i . a_j - n_i . a_i| / (sqrt(d) + 1e-12), with
// mii = n_i . a_i and d = sqdist3(a_i, a_j); 0 where d = 0.
__device__ __forceinline__ float edge_term(const float* ni, const float* aj, float mii, float d) {
  if (!(d > 0.f)) return 0.f;
  const float num = __fsub_rn(dot3(ni, aj), mii);
  return __fdiv_rn(fabsf(num), __fadd_rn(__fsqrt_rn(d), kEps));
}

// acc plus the terms c of lanes 0 .. n-1 of each W-lane group of the warp,
// added in lane order, each sum rounded; with first, lane 0's term starts
// the sum.  The whole warp calls it and every lane of a group returns its
// group's sum.  The W shuffles issue back to back, so only the adds form a
// chain.  Both forwards sum a row's edge terms with it, W at a time in slot
// order, so their sums take the plain version's order.
template <int W>
__device__ __forceinline__ float lane_order_sum(float acc, float c, int n, bool first) {
  float v[W];
#pragma unroll
  for (int l = 0; l < W; ++l) v[l] = __shfl_sync(0xffffffffu, c, l, W);
#pragma unroll
  for (int l = 0; l < W; ++l)
    if (l < n) acc = first && l == 0 ? v[l] : __fadd_rn(acc, v[l]);
  return acc;
}

// A warp a row, per rows in turn, kFwdWarps warps a block; the
// block's rows lie in one cloud, whose points it stages in shared memory
// first.  For its row i the warp writes the N exact distances to its own
// shared row (+inf past N) and keeps each lane's two share minima (lane
// and lane + 32: the entries j with j % 64 the share), selects the k + 1
// smallest pairs with select_common.cuh, then lane t forms the edge term of
// pick t + 1 and every lane sums the terms in pick order after a shuffle.
__global__ void __launch_bounds__(kFwdWarps * 32)
    kappa_fwd_kernel(const float* __restrict__ a, const float* __restrict__ nrm, int N, int k, int per,
                     float* __restrict__ kap, int* __restrict__ picks_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N4 = (N + 3) & ~3;
  float4* pts = reinterpret_cast<float4*>(smem);                  // [N]
  float* dist = reinterpret_cast<float*>(pts + N);                // [kFwdWarps][N4]
  float* mins = dist + (size_t)kFwdWarps * N4;                    // [kFwdWarps][kShares]
  float* bufv = mins + kFwdWarps * pca::sel::kShares;             // [kFwdWarps][kCap]
  int* bufi = reinterpret_cast<int*>(bufv + kFwdWarps * pca::sel::kCap);  // [kFwdWarps][kCap]
  int* pks = bufi + kFwdWarps * pca::sel::kCap;                   // [kFwdWarps][kMaxK + 1]

  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* ab = a + (size_t)b * N * 3;
  for (int j = tid; j < N; j += kFwdWarps * 32) pts[j] = make_float4(ab[3 * j], ab[3 * j + 1], ab[3 * j + 2], 0.f);
  float* d = dist + (size_t)warp * N4;
  for (int j = N + lane; j < N4; j += 32) d[j] = INFINITY;
  float* mw = mins + warp * pca::sel::kShares;
  int* pk = pks + warp * (kMaxK + 1);
  __syncthreads();

#pragma unroll 1
  for (int u = 0; u < per; ++u) {
    const int row = (blockIdx.x * kFwdWarps + warp) * per + u;
    if (row >= N) break;  // the whole warp
    const float4 q = pts[row];
    float m0 = INFINITY, m1 = INFINITY;
    for (int j0 = 0; j0 < N; j0 += 64) {
      const int j = j0 + lane;
      if (j < N) {
        const float4 p = pts[j];
        const float v = pca::sqdist3(q.x, q.y, q.z, p.x, p.y, p.z);
        d[j] = v;
        m0 = fminf(m0, v);
      }
      if (j + 32 < N) {
        const float4 p = pts[j + 32];
        const float v = pca::sqdist3(q.x, q.y, q.z, p.x, p.y, p.z);
        d[j + 32] = v;
        m1 = fminf(m1, v);
      }
    }
    mw[lane] = m0;
    mw[lane + 32] = m1;
    __syncwarp();
    pca::sel::select_row(d, N, N4, k + 1, mw, bufv + warp * pca::sel::kCap, bufi + warp * pca::sel::kCap, pk);

    const size_t r = (size_t)b * N + row;
    const float ai[3] = {q.x, q.y, q.z};
    const float ni[3] = {nrm[r * 3], nrm[r * 3 + 1], nrm[r * 3 + 2]};
    const float mii = dot3(ni, ai);
    int* out = picks_out + r * k;
    float acc = 0.f;
    for (int t0 = 0; t0 < k; t0 += 32) {
      const int t = t0 + lane;
      float c = 0.f;
      if (t < k) {
        const int j = pk[t + 1];
        const float4 p = pts[j];
        const float aj[3] = {p.x, p.y, p.z};
        c = edge_term(ni, aj, mii, d[j]);
        out[t] = j;
      }
      acc = lane_order_sum<32>(acc, c, min(32, k - t0), t0 == 0);
    }
    if (lane == 0) kap[r] = __fdiv_rn(acc, (float)k);
    __syncwarp();  // every read of d and pk is done before the next row rewrites them
  }
}

// W lanes a row of the given set (16 at k <= 16, 32 past it), kIdxThreads
// / W rows of one cloud a block, which stages the cloud's points in shared
// memory as float4 (16 N bytes).  Lane t reads slot t of its row first (the
// row's reads of idx are coalesced, and in flight while the block stages),
// gathers a_j with one shared load and forms edge t with edge_term; the
// row's lanes sum the terms in slot order with lane_order_sum, W slots a
// pass.  An index outside [0, N) reads nothing and adds 0.  The lanes of a
// row past N take part in the shuffles and store nothing.
template <int W>
__global__ void __launch_bounds__(kIdxThreads)
    kappa_idx_fwd_kernel(const float* __restrict__ a, const float* __restrict__ nrm, const int* __restrict__ idx,
                         int N, int k, float* __restrict__ kap) {
  extern __shared__ float4 cloud[];  // [N]
  const int b = blockIdx.y, t = threadIdx.x & (W - 1);
  const int i = blockIdx.x * (kIdxThreads / W) + threadIdx.x / W;
  const bool live = i < N;
  const size_t r = (size_t)b * N + i;
  const int* ix = idx + r * k;
  int j = live && t < k ? ix[t] : -1;  // the first pass's slot, read before the staging
  const float* ab = a + (size_t)b * N * 3;
  for (int q = threadIdx.x; q < N; q += kIdxThreads)
    cloud[q] = make_float4(ab[3 * q], ab[3 * q + 1], ab[3 * q + 2], 0.f);
  float ni[3] = {0.f, 0.f, 0.f};
  if (live) load3(nrm + r * 3, ni);
  __syncthreads();
  const float4 pi = cloud[live ? i : 0];
  const float ai[3] = {pi.x, pi.y, pi.z};
  const float mii = dot3(ni, ai);
  float acc = 0.f;
  for (int t0 = 0; t0 < k; t0 += W) {
    if (t0 > 0) j = live && t0 + t < k ? ix[t0 + t] : -1;
    float c = 0.f;
    if ((unsigned)j < (unsigned)N) {  // not for -1: a slot past k, a row past N
      const float4 p = cloud[j];
      const float aj[3] = {p.x, p.y, p.z};
      c = edge_term(ni, aj, mii, pca::sqdist3(ai[0], ai[1], ai[2], aj[0], aj[1], aj[2]));
    }
    acc = lane_order_sum<W>(acc, c, min(W, k - t0), t0 == 0);
  }
  if (live && t == 0) kap[r] = __fdiv_rn(acc, (float)k);
}

// The gradient terms of the edge i -> j (w = dkappa_i / k, mii = n_i . a_i):
// e = alpha n_i + beta (a_j - a_i) into eq and alpha (a_j - a_i) into nq,
// each operation rounded on its own in the plain version's order; both 0
// at d = 0.
__device__ __forceinline__ void edge_grad(const float (&ai)[3], const float (&ni)[3], const float (&aj)[3],
                                          float mii, float w, float (&eq)[3], float (&nq)[3]) {
  const float d = pca::sqdist3(ai[0], ai[1], ai[2], aj[0], aj[1], aj[2]);
  const float num = __fsub_rn(dot3(ni, aj), mii);
  const float s = num > 0.f ? 1.f : (num < 0.f ? -1.f : 0.f);
  float alpha = 0.f, beta = 0.f;
  if (d > 0.f) {
    const float rn = __fsqrt_rn(d), rr = __fadd_rn(rn, kEps), ws = __fmul_rn(w, s);
    alpha = __fdiv_rn(ws, rr);
    beta = __fdiv_rn(-__fmul_rn(ws, num), __fmul_rn(__fmul_rn(rr, rr), rn));
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float v = __fsub_rn(aj[q], ai[q]);
    eq[q] = __fadd_rn(__fmul_rn(alpha, ni[q]), __fmul_rn(beta, v));
    nq[q] = __fmul_rn(alpha, v);
  }
}

// Cloud b's entries are its N * k picks (or given indices) in (i, t) order,
// each naming the point picks[b, i, t] and stored as its number i * k + t:
// hoist_common.cuh's lists kernel sorts them into each point's incoming
// edges, in ascending (i, t).
struct PickEntries {
  const int* picks;  // [B, N * k]
  int E;
  __device__ int count(int) const { return E; }
  __device__ int key(int b, int e) const { return picks[(size_t)b * E + e]; }
  __device__ int payload(int, int e) const { return e; }
  __device__ size_t base(int b) const { return (size_t)b * E; }
};

// One warp a point j of B * N.  Its own row first: lane t forms the edge
// j -> picks[j, t] (32 at a time), and the warp sums them in pick order into
// ctr and dnormal_j (an index outside [0, N) adds nothing).  Then its
// incoming edges, list[start[j] ...]: lane p recomputes the edge (i, t) of
// entry p from a_i, n_i and dkappa_i, and the warp sums them from 0 in list
// order, ascending (i, t); dadv_j = that sum - ctr.  Each lane forms its
// edge with edge_grad, the same operations on the same values for the edge
// on both of its ends, and every sum runs in one lane's registers after a
// shuffle, so the bits are the plain version's.
__global__ void __launch_bounds__(kThreads)
    kappa_rows_kernel(const float* __restrict__ a, const float* __restrict__ nrm, const int* __restrict__ picks,
                      const float* __restrict__ dkap, const int* __restrict__ start, const int* __restrict__ list,
                      int B, int N, int k, float* __restrict__ dnrm, float* __restrict__ dadv) {
  const int r = (int)(((size_t)blockIdx.x * kThreads + threadIdx.x) >> 5), lane = threadIdx.x & 31;
  if (r >= B * N) return;  // the whole warp
  const int b = r / N, j = r - b * N;
  const float* ab = a + (size_t)b * N * 3;
  float aj[3], nj[3];
  load3(a + (size_t)r * 3, aj);
  load3(nrm + (size_t)r * 3, nj);
  const float mjj = dot3(nj, aj), wj = __fdiv_rn(dkap[r], (float)k);
  float c[3] = {0.f, 0.f, 0.f}, dn[3] = {0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < k; t0 += 32) {
    const int t = t0 + lane;
    float eq[3] = {0.f, 0.f, 0.f}, nq[3] = {0.f, 0.f, 0.f};
    const int q = t < k ? picks[(size_t)r * k + t] : -1;
    const bool ok = (unsigned)q < (unsigned)N;
    if (ok) {
      float aq[3];
      load3(ab + 3 * q, aq);
      edge_grad(aj, nj, aq, mjj, wj, eq, nq);
    }
    const unsigned okm = __ballot_sync(0xffffffffu, ok);
    const int n = min(32, k - t0);
    for (int l = 0; l < n; ++l) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const float e = __shfl_sync(0xffffffffu, eq[u], l), m = __shfl_sync(0xffffffffu, nq[u], l);
        if (okm >> l & 1u) {
          c[u] = t0 + l == 0 ? e : __fadd_rn(c[u], e);
          dn[u] = t0 + l == 0 ? m : __fadd_rn(dn[u], m);
        }
      }
    }
  }
  const int lo = start[(size_t)b * (N + 1) + j], hi = start[(size_t)b * (N + 1) + j + 1];
  const int* ls = list + (size_t)b * N * k;
  float s[3] = {0.f, 0.f, 0.f};
  for (int p0 = lo; p0 < hi; p0 += 32) {
    float eq[3] = {0.f, 0.f, 0.f}, nq[3];
    if (p0 + lane < hi) {
      const int i = ls[p0 + lane] / k;
      const size_t ri = (size_t)b * N + i;
      float ai[3], ni[3];
      load3(ab + 3 * i, ai);
      load3(nrm + ri * 3, ni);
      edge_grad(ai, ni, aj, dot3(ni, ai), __fdiv_rn(dkap[ri], (float)k), eq, nq);
    }
    const int n = min(32, hi - p0);
    for (int l = 0; l < n; ++l) {
#pragma unroll
      for (int u = 0; u < 3; ++u) s[u] = __fadd_rn(s[u], __shfl_sync(0xffffffffu, eq[u], l));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      dadv[(size_t)r * 3 + u] = __fsub_rn(s[u], c[u]);
      dnrm[(size_t)r * 3 + u] = dn[u];
    }
  }
}

// Blocks a cloud of the backward's lists: kListEntries picks each, 1 to
// kMaxListBlocks.
int lists_blocks(int N, int k) {
  const int g = (N * k + kListEntries - 1) / kListEntries;
  return g < 1 ? 1 : g > kMaxListBlocks ? kMaxListBlocks : g;
}

// The forward block's shared memory: the cloud as float4, a distance row a
// warp, its share minima, its selection buffer and its picks (193 KB at
// N = 4096, 60 KB at N = 1024: three blocks an SM).
size_t fwd_smem(int N) {
  const size_t N4 = (N + 3) & ~3;
  return sizeof(float4) * (size_t)N +
         sizeof(float) * kFwdWarps * (N4 + pca::sel::kShares + pca::sel::kCap) +
         sizeof(int) * kFwdWarps * (pca::sel::kCap + kMaxK + 1);
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
  int slots = 0;
  e = pca::resident_slots(reinterpret_cast<const void*>(kappa_fwd_kernel), kFwdWarps * 32, smem, fwd_smem(kMaxPoints),
                          device, &slots);
  if (e != cudaSuccess) return (int)e;
  int per = 1;  // the fewest rows a warp (1, 2, 4, 8) with which the grid fits the card in one wave
  while (per < 8 && (size_t)B * ((N + kFwdWarps * per - 1) / (kFwdWarps * per)) > (size_t)slots) per *= 2;
  const dim3 grid((N + kFwdWarps * per - 1) / (kFwdWarps * per), B);
  kappa_fwd_kernel<<<grid, kFwdWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(nrm), N, k, per, static_cast<float*>(kap),
      static_cast<int*>(picks));
  return (int)cudaGetLastError();
}

// a, nrm [B, N, 3] f32; idx [B, N, k] int32, the given neighbours; kap
// [B, N] f32.  1 <= k <= 64, k + 1 <= N <= 4096.  Returns a cudaError_t code
// (0 on success).
int pca_kappa_idx_fwd(int device, const void* a, const void* nrm, const void* idx, int B, int N, int k, void* kap,
                      void* stream) {
  if (B < 1 || B > 65535 || k < 1 || k > kMaxK || k + 1 > N || N > kMaxPoints) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  static bool opted[64] = {false};  // the staged cloud takes up to 64 KB, past the 48 KB default
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[device]) {
    const int most = (int)sizeof(float4) * kMaxPoints;
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kappa_idx_fwd_kernel<16>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kappa_idx_fwd_kernel<32>),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    opted[device] = true;
  }
  const float* af = static_cast<const float*>(a);
  const float* nf = static_cast<const float*>(nrm);
  const int* xf = static_cast<const int*>(idx);
  float* kf = static_cast<float*>(kap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float4) * (size_t)N;
  if (k <= 16)
    kappa_idx_fwd_kernel<16><<<dim3((N * 16 + kIdxThreads - 1) / kIdxThreads, B), kIdxThreads, smem, s>>>(af, nf, xf,
                                                                                                          N, k, kf);
  else
    kappa_idx_fwd_kernel<32><<<dim3((N * 32 + kIdxThreads - 1) / kIdxThreads, B), kIdxThreads, smem, s>>>(af, nf, xf,
                                                                                                          N, k, kf);
  return (int)cudaGetLastError();
}

// a, nrm [B, N, 3] f32; picks [B, N, k] int32 from the forward (or the given
// neighbours); dkap [B, N] f32; start [B, N + 1] and list [B, N * k] int32
// scratch (each point's incoming edges); dnrm and dadv [B, N, 3] f32
// outputs.  Two launches: the lists, then the rows.  Returns a cudaError_t
// code (0 on success).
int pca_kappa_bwd(int device, const void* a, const void* nrm, const void* picks, const void* dkap, int B, int N,
                  int k, void* start, void* list, void* dnrm, void* dadv, void* stream) {
  if (B < 1 || B > 65535 || k < 1 || k > kMaxK || k + 1 > N || N > kMaxPoints) return (int)cudaErrorInvalidValue;
  // kListPart picks a warp: each part keeps N counts that the block zeroes, scans and offsets, so a
  // few long parts beat many short ones
  const int G = lists_blocks(N, k), most = pca::hoist::lists_parts(N, G > 1 ? 2 : 1);
  if (most < 1) return (int)cudaErrorInvalidValue;
  const int parts = std::max(1, std::min(most, (N * k / G) / kListPart));
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PickEntries src = {static_cast<const int*>(picks), N * k};
  err = pca::hoist::launch_lists(src, B, N, parts, static_cast<int*>(start), static_cast<int*>(list), s, G);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)(((size_t)B * N * 32 + kThreads - 1) / kThreads);
  kappa_rows_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(nrm), static_cast<const int*>(picks),
      static_cast<const float*>(dkap), static_cast<const int*>(start), static_cast<const int*>(list), B, N, k,
      static_cast<float*>(dnrm), static_cast<float*>(dadv));
  return (int)cudaGetLastError();
}

}  // extern "C"
