// Both directions' nearest-neighbour squared distances (the symmetric
// Chamfer / Hausdorff / nearest-index bundle of GeoA3) for Hopper
// (sm_90a), forward and backward.  Plain C interface, loaded with ctypes
// by pointcloudattack_tpu_torch/ops/chamfer.py.
//
// Replaces the TPU kernels pointcloudattack_tpu/ops/pallas/chamfer_kernel.py::
// _both_fwd (pallas_call at :205, body _both_fwd_kernel) and _both_bwd
// (pallas_call at :236, body _both_bwd_kernel), reached from
// min_sqdist_both (:286) by losses/distance.py::chamfer_hausdorff_nn, once
// per GeoA3 iteration forward and once backward.
//
// Forward.  For x [B, N, 3] and y [B, M, 3]: row_min [B, N] =
// min_j |x_i - y_j|^2 with row_arg [B, N] int32, the first j attaining it,
// and col_min [B, M] = min_i |x_i - y_j|^2 with col_arg [B, M], the first i.
// Backward, the JAX custom VJP: with gr [B, N] and gc [B, M] the
// cotangents of row_min and col_min,
//   dx_i = 2 gr_i (x_i - y_{row_arg i}) - sum_{j : col_arg j = i} 2 gc_j (y_j - x_i)
//   dy_j = 2 gc_j (y_j - x_{col_arg j}) - sum_{i : row_arg i = j} 2 gr_i (x_i - y_j)
//
// Numerics.  Distances are sqdist_common.cuh's sqdist3, the plain version's
// per-coordinate form, bit for bit.  A minimum and its index travel as one
// 64-bit key, the distance's bits above the index: a distance is a sum of
// squares or +inf, so keys order as (distance, index) and their minimum is
// the first index attaining the minimum distance, whatever order partial
// minima meet in, integer atomics included.  An all-infinite row keeps
// index 0.  The backward's products and sums are each rounded on their own
// in the plain version's order, and each sum over the other side's matches
// runs in ascending index, the order in which the plain version's
// index_add_ on the CPU adds them: so dx and dy are bit-equal to the plain
// version on the CPU, and the same from run to run (no float atomics).
//
// What bounds it on this card.  At GeoA3's shape (B=8, N=M=1024) the
// forward is 8.4 M pairs at 8 operations a pair (3 subtractions, 3
// products, 2 sums) and a compare for each direction: 84 M operations,
// 0.0013 ms at the FP32 rate, against 0.2 MB of input and output; the
// backward is O(N + M) gathers and sums, 0.0002 ms of bytes.  Uncontracted,
// each operation issues alone and each running minimum costs a compare and
// two selects: about 15 instructions a pair, so issue slots, not the data
// sheet's rate, set the forward's floor (7,400 cycles an SM at GeoA3's shape
// when every SM works); the backward is bound by latency.
//
// What the design does about the forward.  One pass: each distance serves
// both directions.  A cloud takes as many blocks as put one on each SM (16
// at B=8, 64 rows each; 148 KB of shared memory keeps a second block off),
// each block a contiguous part of x's rows against all of y, staged 1024
// points at a time as float4.  Each of its 16 warps holds R rows (1, 2, 4
// or 8) in registers, the same in every lane; lane l takes the chunk's
// points l, l + 32, ...: its rows' running minima over them under a strict
// '<' in ascending j, and each point's key over the warp's rows (a merge
// tree, a later row winning only on a strictly smaller distance), stored a
// key per (warp, point).  A row's lane minima fold by two redux.sync (the bits, then
// the index among lanes that hold them) and the block writes row_min and
// row_arg.  The block folds its warps' keys of each point and sends them to
// the cloud's keys with a 64-bit atomicMin, an integer minimum that gives
// the same bits in any order; the cloud's last block (a count of finished
// blocks) writes col_min and col_arg and resets the keys and the count, so
// the scratch, kept by the wrapper per device and stream, is filled once.
// (Clusters of a cloud's blocks, folding the keys through distributed
// shared memory, were slower: only 7 clusters of 10 or more blocks are
// resident at once on an H100, so 8 clouds took two waves.)
//
// What the design does about the backward.  A block takes 128 points of
// one side (dx's or dy's), one a thread: its own term from its argmin, then
// the other side's terms in ascending index.  To find them the block reads
// the other side's whole argmin array in order, each warp a contiguous part,
// and keeps, by ballot and prefix count, the entries that name one of its
// points with what their terms need (the point and 2 g), in shared memory
// in ascending index; each thread then reads the kept entries in order and
// adds those that name its point.  One launch, no atomics, no scratch.

#include <algorithm>

#include "sqdist_common.cuh"

namespace {

typedef unsigned long long u64;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdWarps = 16;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kMaxRows = 8;      // rows a warp holds in registers
constexpr int kChunk = 1024;     // y points a block stages at a time
constexpr int kFinal = 4;        // points' keys a thread of the last block loads at once
constexpr size_t kMaxSmem = 232448;

constexpr int kBwdThreads = 128;          // points a backward block, one a thread
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdEntries = 2048;         // the other side's entries a block reads at a time
constexpr int kBwdPart = kBwdEntries / kBwdWarps;

__device__ __forceinline__ u64 key_of(float d, unsigned i) { return ((u64)__float_as_uint(d) << 32) | i; }
__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }

// Shared memory of a forward block over `rows` rows of x: the staged chunk,
// the warps' point keys and the rows' keys (more than half an SM's: one
// block an SM).
size_t fwd_smem(int rows) {
  return sizeof(float4) * kChunk + sizeof(u64) * ((size_t)kFwdWarps * kChunk + (size_t)rows);
}

template <int R>
__global__ void __launch_bounds__(kFwdThreads)
    both_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y, int N, int M, int rows,
                    float* __restrict__ rmin, int* __restrict__ rarg, float* __restrict__ cmin,
                    int* __restrict__ carg, u64* __restrict__ keys, unsigned* __restrict__ done) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* cols = reinterpret_cast<float4*>(smem);         // [kChunk]
  u64* part = reinterpret_cast<u64*>(cols + kChunk);      // [kFwdWarps][kChunk]
  u64* rkey = part + (size_t)kFwdWarps * kChunk;          // [rows]
  __shared__ bool last;
  const int S = gridDim.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xb = x + (size_t)b * N * 3;
  const float* yb = y + (size_t)b * M * 3;
  u64* kb = keys + (size_t)b * M;
  const int row0 = blockIdx.x * rows, row1 = min(N, row0 + rows);
  const int passes = (rows + kFwdWarps * R - 1) / (kFwdWarps * R);
  for (int r = tid; r < rows; r += kFwdThreads) rkey[r] = ~0ull;

  // the warp's rows of a pass; a row past this block's is +inf, its
  // distances +inf (or NaN against a point past M), and its index above
  // every real row's, so it takes no point from a real row
  float x0[R], x1[R], x2[R];
  auto load_rows = [&](int p) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + (p * kFwdWarps + warp) * R + r;
      const bool in = i < row1;
      x0[r] = in ? xb[3 * i] : INFINITY;
      x1[r] = in ? xb[3 * i + 1] : INFINITY;
      x2[r] = in ? xb[3 * i + 2] : INFINITY;
    }
  };
  load_rows(0);

  for (int c0 = 0; c0 < M; c0 += kChunk) {
    const int nc = min(kChunk, M - c0), steps = (nc + 31) / 32;
    // a point past M is +inf: no row takes it, and its keys are never read
#pragma unroll
    for (int u = 0; u < kChunk / kFwdThreads; ++u) {
      const int j = u * kFwdThreads + tid;
      float q0 = INFINITY, q1 = INFINITY, q2 = INFINITY;
      if (j < nc) {
        const float* q = yb + (size_t)(c0 + j) * 3;
        q0 = q[0];
        q1 = q[1];
        q2 = q[2];
      }
      cols[j] = make_float4(q0, q1, q2, 0.f);
    }
    __syncthreads();
    for (int p = 0; p < passes; ++p) {
      if (passes > 1) load_rows(p);
      const int rbase = row0 + (p * kFwdWarps + warp) * R;
      float rb[R];
      int ra[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rb[r] = INFINITY;
        ra[r] = 0;
      }
      u64* mine = part + (size_t)warp * kChunk;
#pragma unroll 4
      for (int s = 0; s < steps; ++s) {
        const int j = s * 32 + lane;
        const float4 q = cols[j];
        float d[R];
#pragma unroll
        for (int r = 0; r < R; ++r) d[r] = pca::sqdist3(x0[r], x1[r], x2[r], q.x, q.y, q.z);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (d[r] < rb[r]) {
            rb[r] = d[r];
            ra[r] = c0 + j;
          }
        }
        // the point's nearest of the warp's rows: a merge tree, the later row
        // winning only on a strictly smaller distance
        float cb[R];
        int ci[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          cb[r] = d[r];
          ci[r] = r;
        }
#pragma unroll
        for (int w = 1; w < R; w *= 2) {
#pragma unroll
          for (int r = 0; r + w < R; r += 2 * w) {
            if (cb[r + w] < cb[r]) {
              cb[r] = cb[r + w];
              ci[r] = ci[r + w];
            }
          }
        }
        const u64 k = key_of(cb[0], (unsigned)(rbase + ci[0]));
        mine[j] = p == 0 ? k : kmin(mine[j], k);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const unsigned bits = __float_as_uint(rb[r]);
        const unsigned m = __reduce_min_sync(kFull, bits);
        const unsigned a = __reduce_min_sync(kFull, bits == m ? (unsigned)ra[r] : kFull);
        const int i = rbase + r;
        if (lane == 0 && i < row1) rkey[i - row0] = kmin(rkey[i - row0], ((u64)m << 32) | a);
      }
    }
    __syncthreads();
    // fold the warps' keys of each point into the cloud's, an integer
    // minimum that gives the same bits in any order
    for (int j = tid; j < nc; j += kFwdThreads) {
      u64 k = part[j];
#pragma unroll
      for (int w = 1; w < kFwdWarps; ++w) k = kmin(k, part[(size_t)w * kChunk + j]);
      atomicMin(kb + c0 + j, k);
    }
    if (c0 + kChunk < M) __syncthreads();  // cols and part are read before the next chunk writes them
  }
  for (int i = row0 + tid; i < row1; i += kFwdThreads) {
    const u64 k = rkey[i - row0];
    rmin[(size_t)b * N + i] = __uint_as_float((unsigned)(k >> 32));
    rarg[(size_t)b * N + i] = (int)(unsigned)k;
  }
  // the cloud's last block to finish writes its points' minima and leaves
  // keys and done as it found them: all ones and 0
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + b, 1u) == (unsigned)(S - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j0 = 0; j0 < M; j0 += kFinal * kFwdThreads) {  // kFinal loads in flight before a store
    u64 k[kFinal];
#pragma unroll
    for (int u = 0; u < kFinal; ++u) {
      const int j = j0 + u * kFwdThreads + tid;
      k[u] = j < M ? __ldcg(kb + j) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < kFinal; ++u) {
      const int j = j0 + u * kFwdThreads + tid;
      if (j >= M) continue;
      cmin[(size_t)b * M + j] = __uint_as_float((unsigned)(k[u] >> 32));
      carg[(size_t)b * M + j] = (int)(unsigned)k[u];
      kb[j] = ~0ull;
    }
  }
  if (tid == 0) done[b] = 0u;
}

template <int R>
cudaError_t fwd_launch(int device, const float* x, const float* y, int B, int N, int M, int S, float* rmin,
                       int* rarg, float* cmin, int* carg, u64* keys, unsigned* done, cudaStream_t s) {
  static size_t raised[64] = {0};  // the dynamic shared memory limit set so far, a device
  const int rows = (N + S - 1) / S;
  const size_t smem = fwd_smem(rows);
  if (device < 0 || device >= 64 || raised[device] < smem) {
    const cudaError_t e = cudaFuncSetAttribute(both_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (device >= 0 && device < 64) raised[device] = smem;
  }
  both_fwd_kernel<R><<<dim3(S, B), kFwdThreads, smem, s>>>(x, y, N, M, rows, rmin, rarg, cmin, carg, keys, done);
  return cudaGetLastError();
}

// Rows a warp: the fewest of 1, 2, 4, 8 that hold a block's rows in one
// pass, kMaxRows past that (more take passes).
int warp_rows(int rows) {
  int R = 1;
  while (R < kMaxRows && rows > kFwdWarps * R) R *= 2;
  return R;
}

// Blocks a cloud: as many as put one block on each SM in one wave, at least
// 32 rows a block.
int cloud_blocks(int device, int B, int N) {
  static int sms[64] = {0};
  if (device < 0 || device >= 64) return 1;
  if (sms[device] == 0 && cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 1;
  return std::max(1, std::min(sms[device] / B, N / 32));
}

// One side of the backward: block tile of points p[i], i in [i0, i0 + 128),
// of P points, against the other side o (O points).  dp_i = 2 g_i (p_i -
// o_{arg_i}) - sum, in ascending j, of 2 og_j (o_j - p_i) over j with
// oarg_j = i.
__device__ __forceinline__ void both_bwd_side(const float* __restrict__ p, const float* __restrict__ o,
                                              const int* __restrict__ arg, const int* __restrict__ oarg,
                                              const float* __restrict__ g, const float* __restrict__ og, int P,
                                              int O, int i0, float4* __restrict__ term, int* __restrict__ who,
                                              int* __restrict__ kept, float* __restrict__ dp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, i = i0 + tid;
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
  if (i < P) {
    p0 = p[3 * i];
    p1 = p[3 * i + 1];
    p2 = p[3 * i + 2];
    const float* q = o + (size_t)arg[i] * 3;
    const float s = __fmul_rn(2.0f, g[i]);
    acc0 = __fmul_rn(s, __fsub_rn(p0, q[0]));
    acc1 = __fmul_rn(s, __fsub_rn(p1, q[1]));
    acc2 = __fmul_rn(s, __fsub_rn(p2, q[2]));
  }
  for (int e0 = 0; e0 < O; e0 += kBwdEntries) {
    // warp w keeps, in order, the entries of [e0 + w L, e0 + (w + 1) L) that
    // name a point of this block: slots [w kBwdPart, ...) of term and who
    const int L = (min(kBwdEntries, O - e0) + kBwdWarps - 1) / kBwdWarps;
    const int lo = e0 + warp * L, hi = min(O, lo + L);
    int n = 0;
    for (int e = lo + lane; e - lane < hi; e += 32) {
      const int t = e < hi ? oarg[e] - i0 : -1;
      const bool hit = (unsigned)t < (unsigned)kBwdThreads;
      const unsigned ballot = __ballot_sync(kFull, hit);
      if (hit) {
        const int slot = warp * kBwdPart + n + __popc(ballot & ((1u << lane) - 1u));
        const float* q = o + (size_t)e * 3;
        term[slot] = make_float4(q[0], q[1], q[2], __fmul_rn(2.0f, og[e]));
        who[slot] = t;
      }
      n += __popc(ballot);
    }
    if (lane == 0) kept[warp] = n;
    __syncthreads();
    for (int w = 0; w < kBwdWarps; ++w) {
      const int nw = kept[w];
      for (int c = w * kBwdPart; c < w * kBwdPart + nw; ++c) {
        if (who[c] != tid) continue;
        const float4 t = term[c];
        acc0 = __fsub_rn(acc0, __fmul_rn(t.w, __fsub_rn(t.x, p0)));
        acc1 = __fsub_rn(acc1, __fmul_rn(t.w, __fsub_rn(t.y, p1)));
        acc2 = __fsub_rn(acc2, __fmul_rn(t.w, __fsub_rn(t.z, p2)));
      }
    }
    __syncthreads();  // the kept entries are read before the next part overwrites them
  }
  if (i < P) {
    dp[3 * i] = acc0;
    dp[3 * i + 1] = acc1;
    dp[3 * i + 2] = acc2;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
    both_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y, const int* __restrict__ rarg,
                    const int* __restrict__ carg, const float* __restrict__ gr, const float* __restrict__ gc,
                    int N, int M, int xblocks, float* __restrict__ dx, float* __restrict__ dy) {
  __shared__ float4 term[kBwdEntries];
  __shared__ int who[kBwdEntries];
  __shared__ int kept[kBwdWarps];
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * N * 3;
  const float* yb = y + (size_t)b * M * 3;
  const int* rb = rarg + (size_t)b * N;
  const int* cb = carg + (size_t)b * M;
  if ((int)blockIdx.x < xblocks) {
    both_bwd_side(xb, yb, rb, cb, gr + (size_t)b * N, gc + (size_t)b * M, N, M, blockIdx.x * kBwdThreads, term,
                  who, kept, dx + (size_t)b * N * 3);
  } else {
    both_bwd_side(yb, xb, cb, rb, gc + (size_t)b * M, gr + (size_t)b * N, M, N,
                  (blockIdx.x - xblocks) * kBwdThreads, term, who, kept, dy + (size_t)b * M * 3);
  }
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  x [B, N, 3]
// and y [B, M, 3] f32; rmin [B, N], cmin [B, M] f32; rarg [B, N], carg
// [B, M] int32; keys [B, M] 64-bit, all ones, and done [B] 32-bit, 0: the
// cloud's running point keys and finished blocks, which the kernel leaves as
// it found them.  Returns a cudaError_t code (0 on success).
int pca_min_both_fwd(int device, const void* x, const void* y, int B, int N, int M, void* rmin, void* rarg,
                     void* cmin, void* carg, void* keys, void* done, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int S = cloud_blocks(device, B, N), rows = (N + S - 1) / S;
  if (fwd_smem(rows) + sizeof(bool) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float *rm = static_cast<float*>(rmin), *cm = static_cast<float*>(cmin);
  int *ra = static_cast<int*>(rarg), *ca = static_cast<int*>(carg);
  u64* kb = static_cast<u64*>(keys);
  unsigned* dn = static_cast<unsigned*>(done);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (warp_rows(rows)) {
    case 1: return (int)fwd_launch<1>(device, xf, yf, B, N, M, S, rm, ra, cm, ca, kb, dn, s);
    case 2: return (int)fwd_launch<2>(device, xf, yf, B, N, M, S, rm, ra, cm, ca, kb, dn, s);
    case 4: return (int)fwd_launch<4>(device, xf, yf, B, N, M, S, rm, ra, cm, ca, kb, dn, s);
    default: return (int)fwd_launch<8>(device, xf, yf, B, N, M, S, rm, ra, cm, ca, kb, dn, s);
  }
}

// x [B, N, 3], y [B, M, 3] f32; rarg [B, N], carg [B, M] int32 (from the
// forward); gr [B, N], gc [B, M] f32 cotangents; dx [B, N, 3], dy [B, M, 3]
// f32 outputs.  Returns a cudaError_t code (0 on success).
int pca_min_both_bwd(int device, const void* x, const void* y, const void* rarg, const void* carg,
                     const void* gr, const void* gc, int B, int N, int M, void* dx, void* dy, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int xblocks = (N + kBwdThreads - 1) / kBwdThreads;
  const dim3 grid(xblocks + (M + kBwdThreads - 1) / kBwdThreads, B);
  both_bwd_kernel<<<grid, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), static_cast<const int*>(rarg),
      static_cast<const int*>(carg), static_cast<const float*>(gr), static_cast<const float*>(gc), N, M,
      xblocks, static_cast<float*>(dx), static_cast<float*>(dy));
  return (int)cudaGetLastError();
}

}  // extern "C"
