// The ball route of the gather + chain + max (PointNet++'s set
// abstractions) with its first layer run once a point, the layers after it
// on the tensor cores, and its input gradients over the winning rows only,
// without atomics on floats, for Hopper (sm_90a).  Plain C interface, loaded
// with ctypes by pointcloudattack_tpu_torch/ops/ball_hoist.py.
//
// Replaces, for the ball route, the TPU kernels of
// pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py:
//   forward  _gather_fwd_pallas (pallas_call at :550, body _gather_fwd_kernel)
//   backward _gather_bwd_pallas (pallas_call at :641, body _gather_bwd_kernel)
// reached through ball_gather_chain_groupmax (_make_ball_gather_op :801).
//
// For src [B, N, Cs], centers [B, G, Cc], xyz [B, N, 3] and layers
// (W_l, b, mean, mul, beta), l < L: each group's K slots are the first K
// points in index order within the radius of centers[..., :3] (a short ball
// padded with its first member, point 0 for an empty ball), row (i, k) is
// built from src[idx[i, k]] and centers[i] by the layout, and the chain runs
// on it: z_l = ((h_l . W_l + b) - mean) * mul + beta, h_l+1 = act(z_l), no
// activation after the last layer; y = the max over the K rows, am the
// lowest k attaining it.  The first layer is affine in the row, so
// h_1 = act(BN(P[idx[i, k]] + Q[i])) with P = src . W_src over the B*N
// points and Q = centers . W_ctr over the B*G centers (the wrapper folds
// W_src and W_ctr, ops/gather_hoist.py::split_weight).  Kernels:
//   slots     the ball query: idx [B, G, K].
//   product   P and Q (one launch); backward dsrc = dP . W_src^T and
//             dctr = dQ . W_ctr^T: gather_hoist.cu's product kernel (its
//             pca_hoist_product), not a kernel of this file.
//   stack     forward: h_1 built in the tile from P and Q, the layers after
//             it as 3xTF32 mma.sync products, y and am from the last
//             layer's accumulators, and each row's hidden sign bits
//             (z_l > 0), bit-packed, a word-aligned run per hidden layer.
//   winners   the rows that win a column, per group ascending, compacted
//             over all groups: a bitmap a group and a scan, then (a second
//             kernel of the same launch call) the rows placed.
//   stack     backward: over tiles of winning rows, the last layer's
//             one-hot cotangent (g on each column's winning row) and the
//             hidden layers back as 3xTF32 products, masked by the saved
//             sign bits, down to d1, the cotangent of P[j] + Q[i].
//   lists     each point's winning rows, a stable counting sort
//             (hoist_common.cuh's, shared with gather_hoist.cu).
//   pull      dP[j] = sum of d1 over j's list and dQ[i] = sum of d1 over
//             group i's winners, each in its list's order.
// No atomic touches a float and every sum has a fixed order, so two calls
// on the same inputs give the same bits.
//
// What bounds it on this card.  At PointNet++'s set abstractions (B=16,
// N=1024) the layers after the first are 97% of the forward's work on every
// row: 2 * rows * sum C_l * C_l+1, from 6.3 GFLOP at SSG's first SA to 25.8
// at MSG's second SA's K=128 branch, against at most 13 MB of operands and
// outputs; as 3xTF32 products they take three TF32 products each, at 495
// TFLOP/s: operations bound it.  The first layer is 2 * B * (N * Cs + G *
// Cc) * C1 (0.2 GFLOP at most) and the ball query 9 operations a tested
// pair.  Backward: only the winning rows carry a cotangent (14-45% of the
// rows at these shapes), each through the hidden layers' products; the
// one-hot product through the last layer costs as much as the forward's on
// those rows, against the sparse expansion's one row of W_L a column.
//
// What the design does about it.
//   * slots: one warp a ball, 8 balls a block; the cloud staged in shared
//     memory 512 points at a time with each point's norm; each lane's
//     distance replays ops/pairwise.py::pairwise_sqdist bit for bit (xx, xy
//     and yy summed over coordinates 0, 1, 2 with __fmul_rn and __fadd_rn,
//     then (xx - 2*xy) + yy, no FMA contraction), a ballot marks the members
//     and a popcount of the lower lanes gives each its slot.  A ball stops
//     once full, a block once all its balls are.
//   * stack forward: a block holds 128 rows, 128 / K whole groups (K <= 128).
//     Activations stay in shared memory, row-major at a stride of 4 (mod
//     32), so the A fragments' 32 lanes read 32 banks.  Weight tiles of 64
//     output columns x 32 inputs stream through a 3-stage cp.async ring; each
//     warp owns 16 rows and splits its fragments into TF32 high and low parts
//     by a mask (chain_common.cuh's split_tf32), three mma.sync m16n8k8 a
//     product (a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 accumulate), the
//     rounding chain_maxpool.cu's product stage holds within Y_TOL.  The last
//     layer's BatchNormed accumulators go through a [128 x 65] staging tile:
//     each (group, column) is scanned by up to 4 threads in row order and the
//     partials joined lowest k first, so ties keep the lowest k.
//   * winners: a warp a group ORs the columns' argmax rows into a K-bit map
//     (__reduce_or_sync); the last block to finish (an integer ticket) scans
//     the counts; then a warp a group writes its winners side by side (the
//     last block placing them all alone took 0.157 ms at MSG's K=128 branch,
//     its stores one scattered line each).  Padding copies of a short ball's
//     first member never win, so 14-45% of the rows remain.
//   * stack backward: a persistent grid over tiles of 64 winning rows; the
//     tile's groups put g on their winning rows (the row's position is the
//     group's offset plus a popcount of its bitmap below k), then the same
//     product routine as forward runs W_l^T (the weight read in place with
//     its strides), the epilogue applying the saved sign and mul.  A row
//     that wins every column costs what any row costs.
//   * pull: threads across (point, unit) and (group, unit), each walking its
//     list in order.
//
// Shapes it takes: 2 <= L <= kMaxLayers, 1 <= K <= 128, every width >= 1,
// hidden widths summing to at most 1024 units, shared memory at the widths
// within 227 KB (a hidden width up to about 512 with C_L up to 1024).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "chain_common.cuh"
#include "hoist_common.cuh"

namespace {

using namespace pca;

constexpr int kBallTile = 512;  // cloud points the ball query stages at a time
constexpr int kFwdRows = 128;   // forward tile: whole groups
constexpr int kBwdRows = 64;    // backward tile: winning rows
constexpr int kNC = 64;         // product: output columns a chunk
constexpr int kKC = 32;         // product: depth of a staged weight tile
constexpr int kLDB = kKC + 4;   // weight tile row stride, = 4 (mod 32): conflict-free B fragments
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kMaxK = 128;
constexpr int kMaxWords = 32;   // sign words a row: at most 1024 hidden units
constexpr int kWinThreads = 1024;
constexpr int kSThreads = 512;  // the stack kernels' block: 16 warps
constexpr int kSWarps = kSThreads / 32;
constexpr int kPullDepth = 4;   // list entries a pull thread loads at once

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride of an activation tile of width c: a multiple of 32 plus 4.
__host__ __device__ inline int act_ld(int c) { return round_up(c, kKC) + 4; }

struct Stack {
  int L;
  int dims[kMaxLayers + 1];
  const float* w[kMaxLayers];  // W_l [dims[l], dims[l+1]], element (i, o) at w[i * s0 + o * s1]
  int s0[kMaxLayers], s1[kMaxLayers];
  const float* b[kMaxLayers];
  const float* mean[kMaxLayers];
  const float* mul[kMaxLayers];
  const float* beta[kMaxLayers];
  int woff[kMaxLayers];  // hidden layer h's (layer h's output, h < L - 1) first sign word in a row
  int words;             // sign words a row
  float slope;
};

__device__ __forceinline__ float bn(float v, float bb, float mm, float mu, float be) {
  return ((v + bb) - mm) * mu + be;
}

// The cotangent dh through the activation whose input's sign bit is `pos`,
// times the layer's mul, as act_bwd_mul.
__device__ __forceinline__ float act_bwd_sign(bool pos, float dh, float mu, float slope) {
  return pos ? dh * mu : (slope == 0.f ? 0.f : (slope * dh) * mu);
}

// ---------------------------------------------------------------------------
// The ball query
// ---------------------------------------------------------------------------

struct SlotArgs {
  const float* xyz;  // [B, N, 3]
  const float* ctr;  // [B, G, Cc]: the balls' centers in columns 0..2
  float r2;
  int N, G, K, Cc;
  int* idx;  // [B, G, K]
};

// The slots of kWarps balls of cloud blockIdx.y, one warp a ball.  The
// squared distance is pairwise_sqdist's, (xx - 2*xy) + yy with each sum
// over the coordinates in order, every operation rounded on its own; a
// point is a member when it is <= r2.  Slots past the ball's members repeat
// its first member, or point 0 when it has none.
__global__ void __launch_bounds__(kThreads) slots_kernel(SlotArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* pts = reinterpret_cast<float4*>(smem);  // [kBallTile]: x, y, z, yy
  int* cnt_s = reinterpret_cast<int*>(pts + kBallTile);  // [kWarps]
  int* idx_s = cnt_s + kWarps;                           // [kWarps][K]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, g0 = blockIdx.x * kWarps, ng = min(kWarps, a.G - g0), K = a.K;
  if (tid < kWarps) cnt_s[tid] = 0;
  for (int p0 = 0; p0 < a.N; p0 += kBallTile) {
    __syncthreads();  // cnt_s settled, the last tile's points read
    bool done = true;
    for (int lg = 0; lg < ng; ++lg) done = done && cnt_s[lg] >= K;
    if (done) break;
    const int np = min(kBallTile, a.N - p0);
    for (int e = tid; e < np; e += kThreads) {
      const float* p = a.xyz + ((size_t)b * a.N + p0 + e) * 3;
      const float x = p[0], y = p[1], z = p[2];
      pts[e] = make_float4(x, y, z, __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
    }
    __syncthreads();
    if (warp < ng) {
      int cnt = cnt_s[warp];  // the same in every lane
      const float* c = a.ctr + ((size_t)b * a.G + g0 + warp) * a.Cc;
      const float cx = c[0], cy = c[1], cz = c[2];
      const float xx = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz));
      for (int j0 = 0; j0 < np && cnt < K; j0 += 32) {
        const int j = j0 + lane;
        bool in = false;
        if (j < np) {
          const float4 p = pts[j];
          const float xy = __fadd_rn(__fadd_rn(__fmul_rn(cx, p.x), __fmul_rn(cy, p.y)), __fmul_rn(cz, p.z));
          in = __fadd_rn(__fsub_rn(xx, __fmul_rn(2.f, xy)), p.w) <= a.r2;
        }
        const unsigned bits = __ballot_sync(0xffffffffu, in);
        const int slot = cnt + __popc(bits & ((1u << lane) - 1u));
        if (in && slot < K) idx_s[warp * K + slot] = p0 + j;
        cnt += __popc(bits);
      }
      __syncwarp();  // every lane has read cnt_s[warp]
      if (lane == 0) cnt_s[warp] = cnt;
    }
  }
  __syncthreads();
  int* out = a.idx + ((size_t)b * a.G + g0) * K;
  for (int e = tid; e < ng * K; e += kThreads) {
    const int lg = e / K, total = cnt_s[lg];
    // slot 0 is a member whenever total > 0
    out[e] = e % K < total ? idx_s[e] : (total > 0 ? idx_s[lg * K] : 0);
  }
}

// ---------------------------------------------------------------------------
// The 3xTF32 tile product
// ---------------------------------------------------------------------------

// T rows a tile: T / 16 of the kSWarps warps along the rows, the rest along
// each 64-column chunk; each warp holds NT 16 x 8 accumulator tiles.
template <int T>
struct Tiling {
  static constexpr int WM = T / 16, WN = kSWarps / WM, NT = 64 / (8 * WN);
};

// f(r, c, v) for each accumulator of this thread: tile row r, column c.
template <int T, class F>
__device__ __forceinline__ void for_frag(const float (&acc)[Tiling<T>::NT][4], int c0, F f) {
  constexpr int WM = Tiling<T>::WM, NT = Tiling<T>::NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        f(wm * 16 + g + 8 * h, c0 + wn * 8 * NT + j * 8 + 2 * t + q, acc[j][2 * h + q]);
}

// The weights of one tile product: W(n, k) at w[n * sn + k * sk], Kdim
// deep, Ncols wide, streamed as [kNC x kKC] tiles, the steps' depth
// fastest.
struct WTiles {
  const float* w;
  int sn, sk, Kdim, Ncols, nk, nsteps;
  bool vec;
};

__device__ __forceinline__ WTiles wtiles(const float* w, int sn, int sk, int Kdim, int Ncols) {
  const int nk = (Kdim + kKC - 1) / kKC;
  return {w, sn, sk, Kdim, Ncols, nk, nk * ((Ncols + kNC - 1) / kNC),
          sk == 1 && (Kdim & 3) == 0 && (sn & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0};
}

// Step `step`'s weight tile into ring slot `slot`, zero-filled past Kdim and
// Ncols (cp.async; the caller commits).
__device__ __forceinline__ void load_wtile(const WTiles& W, int step, int slot, float* ring) {
  const int tid = threadIdx.x;
  const int c0 = (step / W.nk) * kNC, k0 = (step % W.nk) * kKC;
  float* dst = ring + (size_t)slot * kNC * kLDB;
  if (W.vec) {
    for (int e = tid; e < kNC * kKC / 4; e += kSThreads) {
      const int q = e % (kKC / 4), n = e / (kKC / 4), c = c0 + n, k = k0 + 4 * q;
      const bool ok = c < W.Ncols && k < W.Kdim;
      cp_async16(dst + n * kLDB + 4 * q, ok ? W.w + (size_t)c * W.sn + k : W.w, ok ? 16 : 0);
    }
  } else if (W.sk == 1) {  // neighbouring threads along k
    for (int e = tid; e < kNC * kKC; e += kSThreads) {
      const int q = e % kKC, n = e / kKC, c = c0 + n, k = k0 + q;
      const bool ok = c < W.Ncols && k < W.Kdim;
      cp_async4(dst + n * kLDB + q, ok ? W.w + (size_t)c * W.sn + k : W.w, ok ? 4 : 0);
    }
  } else {  // along n
    for (int e = tid; e < kNC * kKC; e += kSThreads) {
      const int n = e % kNC, q = e / kNC, c = c0 + n, k = k0 + q;
      const bool ok = c < W.Ncols && k < W.Kdim;
      cp_async4(dst + n * kLDB + q, ok ? W.w + (size_t)c * W.sn + (size_t)k * W.sk : W.w, ok ? 4 : 0);
    }
  }
}

// The first kStages - 1 weight tiles of a product, started while the block
// does other work (the ring must be free: after tile_product returns, or
// before the first).
__device__ __forceinline__ void start_product(const WTiles& W, float* ring) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < W.nsteps) load_wtile(W, s, s, ring);
    cp_async_commit();
  }
}

// out[r][n] = sum_k A[r][k] * W(n, k) for the T rows of A (shared, row
// stride lda, zero or finite past Kdim up to a multiple of kKC) and the
// Ncols outputs, after start_product(W, ring); epi(c0, acc) takes each
// 64-column chunk (every thread calls it, so it may hold barriers).  The
// weight tiles stream through ring ([kStages][kNC][kLDB] shared floats).
// Ends with a barrier.
template <int T, class Epi>
__device__ __forceinline__ void tile_product(const float* A, int lda, const WTiles& W, float* ring, Epi epi) {
  constexpr int WM = Tiling<T>::WM, NT = Tiling<T>::NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM, g = lane >> 2, t = lane & 3;
  const int nk = W.nk, nsteps = W.nsteps;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tile has landed; the slot refilled below is free
    if (step + kStages - 1 < nsteps) load_wtile(W, step + kStages - 1, (step + kStages - 1) % kStages, ring);
    cp_async_commit();
    const float* Bs = ring + (size_t)(step % kStages) * kNC * kLDB + (wn * 8 * NT + g) * kLDB + t;
    const float* As = A + (size_t)(wm * 16 + g) * lda + (step % nk) * kKC + t;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 8) {
      unsigned ah[4], al[4];
      split_tf32(As[kk], ah[0], al[0]);                // (row g, k t)
      split_tf32(As[8 * lda + kk], ah[1], al[1]);      // (g + 8, t)
      split_tf32(As[kk + 4], ah[2], al[2]);            // (g, t + 4)
      split_tf32(As[8 * lda + kk + 4], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(Bs[j * 8 * kLDB + kk], bh0, bl0);      // (k t, n g)
        split_tf32(Bs[j * 8 * kLDB + kk + 4], bh1, bl1);  // (t + 4, g)
        mma_tf32(acc[j], al, bh0, bh1);
        mma_tf32(acc[j], ah, bl0, bl1);
        mma_tf32(acc[j], ah, bh0, bh1);
      }
    }
    if (step % nk == nk - 1) {
      epi((step / nk) * kNC, acc);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float* p;  // P [B*N, >= C1] at row stride sp
  const float* q;  // Q [B*G, >= C1] at row stride sq
  int sp, sq;
  const int* idx;  // [B*G, K]
  int N, G, K, BG, gpt;  // gpt: groups a tile
  int buf0, buf1;        // the two activation buffers' row capacities, floats
  Stack st;
  float* y;          // [B*G, C_L]
  int* am;           // [B*G, C_L]
  unsigned* signs;   // [B*G*K, words]
};

template <int T>
__global__ void __launch_bounds__(kSThreads) stack_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* cur = sm;
  float* nxt = cur + (size_t)T * a.buf0;
  float* ring = nxt + (size_t)T * a.buf1;
  int* prow = reinterpret_cast<int*>(ring + kStages * kNC * kLDB);  // [T]: each row's row of P
  int* qrow = prow + T;  // [T]: each row's group (row of Q), -1 past the tile's groups
  const Stack& st = a.st;
  const int tid = threadIdx.x, L = st.L, K = a.K;
  const int g0 = blockIdx.x * a.gpt;
  const int rows = a.gpt * K;
  auto valid = [&](int r) { return r < rows && g0 + r / K < a.BG; };
  // layer l's weights, W(n = output, k = input)
  auto fwd_w = [&](int l) { return wtiles(st.w[l], st.s1[l], st.s0[l], st.dims[l], st.dims[l + 1]); };
  start_product(fwd_w(1), ring);  // the first weights land while h_1 is built

  for (int r = tid; r < T; r += kSThreads) {
    int j = 0, bg = -1;
    if (valid(r)) {
      bg = g0 + r / K;
      j = (bg / a.G) * a.N + a.idx[(size_t)bg * K + r % K];
    }
    prow[r] = j;
    qrow[r] = bg;
  }
  __syncthreads();

  // the sign bits of hidden layer h, whose [T][C] activation is H
  auto write_signs = [&](const float* H, int ld, int C, int h) {
    const int nw = (C + 31) / 32;
    for (int e = tid; e < T * nw; e += kSThreads) {
      const int r = e / nw, wd = e - r * nw;
      if (!valid(r)) continue;
      const float* row = H + (size_t)r * ld + 32 * wd;
      const int n = min(32, C - 32 * wd);
      unsigned bits = 0;
      for (int i = 0; i < n; ++i) bits |= (row[i] > 0.f ? 1u : 0u) << i;
      a.signs[((size_t)g0 * K + r) * st.words + st.woff[h] + wd] = bits;
    }
  };

  {  // h_1 = act(BN(P[j] + Q[i])), zero past C1 and on the rows past the groups: a warp a
     // row, lanes across 128-column blocks, kBuild rows' loads in flight before any store
    constexpr int kBuild = 4;
    const int lane = tid & 31, warp = tid >> 5;
    const int C1 = st.dims[1], ld = act_ld(C1), Kp = round_up(C1, kKC);
    for (int cb = 0; cb < Kp; cb += 128) {
      float bb[4], mm[4], mu[4], be[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = cb + 32 * i + lane;
        const bool in = c < C1;
        bb[i] = in ? __ldg(st.b[0] + c) : 0.f;
        mm[i] = in ? __ldg(st.mean[0] + c) : 0.f;
        mu[i] = in ? __ldg(st.mul[0] + c) : 0.f;
        be[i] = in ? __ldg(st.beta[0] + c) : 0.f;
      }
      for (int r0 = warp; r0 < T; r0 += kSWarps * kBuild) {
        float pv[kBuild][4], qv[kBuild][4];
#pragma unroll
        for (int u = 0; u < kBuild; ++u) {
          const int r = r0 + u * kSWarps, bg = qrow[r];
          const float* pr = a.p + (size_t)prow[r] * a.sp;
          const float* qr = a.q + (size_t)(bg < 0 ? 0 : bg) * a.sq;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = cb + 32 * i + lane;
            const bool ok = bg >= 0 && c < C1;
            pv[u][i] = ok ? pr[c] : 0.f;
            qv[u][i] = ok ? qr[c] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBuild; ++u) {
          const int r = r0 + u * kSWarps;
          const bool live = qrow[r] >= 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = cb + 32 * i + lane;
            if (c < Kp)
              cur[(size_t)r * ld + c] =
                  live && c < C1 ? act_fwd(bn(__fadd_rn(pv[u][i], qv[u][i]), bb[i], mm[i], mu[i], be[i]), st.slope)
                                 : 0.f;
          }
        }
      }
    }
    __syncthreads();
    write_signs(cur, ld, C1, 0);
  }

  for (int l = 1; l < L; ++l) {
    const int Cout = st.dims[l + 1], ldi = act_ld(st.dims[l]);
    const float *bb = st.b[l], *mm = st.mean[l], *mu = st.mul[l], *be = st.beta[l];
    if (l < L - 1) {
      const int ldo = act_ld(Cout), Kp = round_up(Cout, kKC);
      tile_product<T>(cur, ldi, fwd_w(l), ring, [&](int c0, auto& acc) {
        for_frag<T>(acc, c0, [&](int r, int c, float v) {
          if (c < Kp)
            nxt[(size_t)r * ldo + c] =
                c < Cout ? act_fwd(bn(v, __ldg(bb + c), __ldg(mm + c), __ldg(mu + c), __ldg(be + c)), st.slope) : 0.f;
        });
      });
      start_product(fwd_w(l + 1), ring);  // the next weights land while the signs are written
      write_signs(nxt, ldo, Cout, l);
      float* tmp = cur; cur = nxt; nxt = tmp;
      continue;
    }
    // the last layer: BatchNormed into the staging tile zs [T][kNC + 1], then
    // the max over each group's rows, column by column
    float* zs = nxt;
    const int CL = Cout;
    int S = 1;  // threads a (group, column): up to 4, each scanning a run of rows
    while (S < 4 && a.gpt * kNC * S * 2 <= kSThreads) S *= 2;
    const int rpt = (K + S - 1) / S, work = a.gpt * kNC * S;
    tile_product<T>(cur, ldi, fwd_w(l), ring, [&](int c0, auto& acc) {
      for_frag<T>(acc, c0, [&](int r, int c, float v) {
        zs[r * (kNC + 1) + (c - c0)] =
            c < CL ? bn(v, __ldg(bb + c), __ldg(mm + c), __ldg(mu + c), __ldg(be + c)) : 0.f;
      });
      __syncthreads();
      for (int base = 0; base < work; base += kSThreads) {  // the same trip count in every thread
        const int e = base + tid, pr = e / S, s = e - pr * S, lg = pr / kNC, cc = pr - lg * kNC;
        const int bg = g0 + lg, c = c0 + cc;
        const bool live = e < work && c < CL && bg < a.BG;
        float best = -INFINITY;
        int arg = INT_MAX;
        if (live) {
          const int k0 = s * rpt, k1 = min(K, k0 + rpt);
          for (int k = k0; k < k1; ++k) {
            const float v = zs[(lg * K + k) * (kNC + 1) + cc];
            if (k == k0 || v > best) {  // strict: a tie keeps the lowest k
              best = v;
              arg = k;
            }
          }
        }
        for (int o = 1; o < S; o <<= 1) {  // the partials of a (group, column) sit in adjacent lanes
          const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
          const int a2 = __shfl_xor_sync(0xffffffffu, arg, o);
          if (v2 > best || (v2 == best && a2 < arg)) {
            best = v2;
            arg = a2;
          }
        }
        if (live && s == 0) {
          a.y[(size_t)bg * CL + c] = best;
          a.am[(size_t)bg * CL + c] = arg;
        }
      }
      __syncthreads();  // zs is written again by the next chunk
    });
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

struct WinArgs {
  const int* am;  // [BG, CL]
  int BG, K, KW, CL;
  unsigned* mask;  // [BG, KW]: the winning k, a bit each
  int* counts;     // [BG]
  int* ticket;     // 0 between launches
  int* off;        // [BG + 1]: winners before each group, then the total
  int* wrow;       // [BG * K]: the winning rows bg * K + k, ascending
};

__global__ void __launch_bounds__(kWinThreads) winners_kernel(WinArgs a) {
  __shared__ int ws[32];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bg = blockIdx.x * (kWinThreads / 32) + warp;
  if (bg < a.BG) {
    unsigned bits[kMaxK / 32] = {0u, 0u, 0u, 0u};
    const int* row = a.am + (size_t)bg * a.CL;
    for (int c = lane; c < a.CL; c += 32) {
      const int k = row[c];
      if ((unsigned)k < (unsigned)a.K) {
#pragma unroll
        for (int w = 0; w < kMaxK / 32; ++w)
          if ((k >> 5) == w) bits[w] |= 1u << (k & 31);
      }
    }
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < kMaxK / 32; ++w) {
      const unsigned m = __reduce_or_sync(0xffffffffu, bits[w]);
      if (w < a.KW) {
        if (lane == 0) a.mask[(size_t)bg * a.KW + w] = m;
        cnt += __popc(m);
      }
    }
    if (lane == 0) a.counts[bg] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(a.ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the offsets
  __threadfence();
  const int tot = block_scan(a.BG, [&](int i) { return __ldcg(a.counts + i); },
                             [&](int i, int p) { a.off[i] = p; }, ws);
  if (tid == 0) {
    a.off[a.BG] = tot;
    *a.ticket = 0;
  }
}

// Each group's winners in ascending k at its offset, a warp a group: lane i
// takes bit i of each word, so a word's winners are written side by side.
__global__ void __launch_bounds__(kWinThreads) winners_place_kernel(WinArgs a) {
  const int lane = threadIdx.x & 31;
  const int bg = blockIdx.x * (kWinThreads / 32) + (threadIdx.x >> 5);
  if (bg >= a.BG) return;
  int p = a.off[bg];
  for (int w = 0; w < a.KW; ++w) {
    const unsigned m = a.mask[(size_t)bg * a.KW + w];
    if ((m >> lane) & 1u) a.wrow[p + __popc(m & ((1u << lane) - 1u))] = bg * a.K + 32 * w + lane;
    p += __popc(m);
  }
}

struct BwdArgs {
  const int* off;          // [BG + 1]
  const int* wrow;         // winning rows, ascending
  const unsigned* mask;    // [BG, KW]
  const int* am;           // [BG, CL]
  const float* g;          // [BG, CL]: dy * mul_L
  const unsigned* signs;   // [BG * K, words]
  int BG, K, KW;
  int buf0, buf1;          // the two cotangent buffers' row capacities, floats
  Stack st;
  float* d1;               // [winners, C1]
};

template <int T>
__global__ void __launch_bounds__(kSThreads) stack_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* buf0 = sm;
  float* buf1 = buf0 + (size_t)T * a.buf0;
  float* ring = buf1 + (size_t)T * a.buf1;
  int* row_s = reinterpret_cast<int*>(ring + kStages * kNC * kLDB);  // [T]: the tile's winning rows
  unsigned* sg = reinterpret_cast<unsigned*>(row_s + T);          // [T][words]: their sign bits
  const Stack& st = a.st;
  const int tid = threadIdx.x, L = st.L, CL = st.dims[L], C1 = st.dims[1], words = st.words, K = a.K;
  const int total = a.off[a.BG], ntiles = (total + T - 1) / T;
  // layer l's weights backward, W(n = input, k = output)
  auto bwd_w = [&](int l) { return wtiles(st.w[l], st.s0[l], st.s1[l], st.dims[l + 1], st.dims[l]); };
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int w0 = tile * T, nv = min(T, total - w0);
    __syncthreads();  // the previous tile is done with every buffer
    start_product(bwd_w(L - 1), ring);  // the first weights land while the one-hot is built
    const int ldL = act_ld(CL);
    for (int r = tid; r < T; r += kSThreads) row_s[r] = r < nv ? a.wrow[w0 + r] : -1;
    for (int e = tid; e < T * ldL; e += kSThreads) buf0[e] = 0.f;
    __syncthreads();
    for (int e = tid; e < T * words; e += kSThreads) {
      const int r = e / words;
      sg[e] = r < nv ? a.signs[(size_t)row_s[r] * words + (e - r * words)] : 0u;
    }
    // the one-hot cotangent: each column of each group in the tile puts g on
    // its winning row, at the group's offset plus the winners below its k
    // (kOneHot columns a thread loaded before any is stored, so their loads overlap)
    constexpr int kOneHot = 4;
    const int bgf = row_s[0] / K, ng = row_s[nv - 1] / K - bgf + 1;
    for (int e0 = 0; e0 < ng * CL; e0 += kSThreads * kOneHot) {
      int pos[kOneHot];
      float gv[kOneHot];
#pragma unroll
      for (int u = 0; u < kOneHot; ++u) {
        const int e = e0 + u * kSThreads + tid, bg = bgf + e / CL, c = e % CL;
        pos[u] = -1;
        gv[u] = 0.f;
        if (e >= ng * CL) continue;
        const int k = a.am[(size_t)bg * CL + c];
        gv[u] = a.g[(size_t)bg * CL + c];
        if ((unsigned)k >= (unsigned)K) continue;
        const unsigned* m = a.mask + (size_t)bg * a.KW;
        int p = a.off[bg] - w0;
        for (int wd = 0; wd < (k >> 5); ++wd) p += __popc(m[wd]);
        pos[u] = p + __popc(m[k >> 5] & ((1u << (k & 31)) - 1u));
      }
#pragma unroll
      for (int u = 0; u < kOneHot; ++u) {
        const int c = (e0 + u * kSThreads + tid) % CL;
        if (pos[u] >= 0 && pos[u] < nv) buf0[(size_t)pos[u] * ldL + c] = gv[u];
      }
    }
    float* cur = buf0;
    float* nxt = buf1;
    int ldc = ldL;
    for (int l = L - 1; l >= 1; --l) {
      // dh[r][n] = sum_k c[r][k] W_l[n][k], then layer l-1's sign and mul
      const int Cout = st.dims[l], woff = st.woff[l - 1];
      const float* mu = st.mul[l - 1];
      if (l > 1) {
        const int ldo = act_ld(Cout), Kp = round_up(Cout, kKC);
        tile_product<T>(cur, ldc, bwd_w(l), ring, [&](int c0, auto& acc) {
          for_frag<T>(acc, c0, [&](int r, int c, float v) {
            if (c >= Kp) return;
            float o = 0.f;
            if (c < Cout) o = act_bwd_sign((sg[r * words + woff + (c >> 5)] >> (c & 31)) & 1u, v, __ldg(mu + c),
                                           st.slope);
            nxt[(size_t)r * ldo + c] = o;
          });
        });
        start_product(bwd_w(l - 1), ring);
        float* tmp = cur; cur = nxt; nxt = tmp;
        ldc = ldo;
      } else {
        tile_product<T>(cur, ldc, bwd_w(l), ring, [&](int c0, auto& acc) {
          for_frag<T>(acc, c0, [&](int r, int c, float v) {
            if (c < Cout && r < nv)
              a.d1[(size_t)(w0 + r) * C1 + c] =
                  act_bwd_sign((sg[r * words + woff + (c >> 5)] >> (c & 31)) & 1u, v, __ldg(mu + c), st.slope);
          });
        });
      }
    }
  }
}

// Cloud b's entries are its winning rows in order: each names the point
// its slot gathered and is stored as its winner index.
struct WinEntries {
  const int* idx;   // [B*G*K]
  const int* wrow;
  const int* off;   // [BG + 1]
  int G;
  __device__ int count(int b) const { return off[(b + 1) * G] - off[b * G]; }
  __device__ int key(int b, int e) const { return idx[wrow[off[b * G] + e]]; }
  __device__ int payload(int b, int e) const { return off[b * G] + e; }
  __device__ size_t base(int b) const { return (size_t)off[b * G]; }
};

struct PullArgs {
  const int* start;  // [B, N + 1], from each cloud's base
  const int* list;   // winner indices
  const int* off;    // [BG + 1]
  const float* d1;   // [winners, C]
  int B, N, G, C, pts, grp, pull_blocks;
  float* dp;  // [B, N, C]
  float* dq;  // [B*G, C]
};

// acc + the d1 rows ent(s), s in [s0, s1), unit c, added in order.
template <class Ent>
__device__ __forceinline__ float sum_rows(const float* __restrict__ d1, int C, int c, int s0, int s1, Ent ent) {
  float acc = 0.f;
  int s = s0;
  for (; s + kPullDepth <= s1; s += kPullDepth) {  // the loads of kPullDepth entries in flight together
    float v[kPullDepth];
#pragma unroll
    for (int u = 0; u < kPullDepth; ++u) v[u] = d1[(size_t)ent(s + u) * C + c];
#pragma unroll
    for (int u = 0; u < kPullDepth; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; s < s1; ++s) acc = __fadd_rn(acc, d1[(size_t)ent(s) * C + c]);
  return acc;
}

__global__ void __launch_bounds__(kThreads) pull_kernel(PullArgs a) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < a.pull_blocks) {  // dP over (point, unit)
    const int nb = (a.N + a.pts - 1) / a.pts, b = blockIdx.x / nb, j0 = (blockIdx.x % nb) * a.pts;
    const int* st = a.start + (size_t)b * (a.N + 1);
    const int* ls = a.list + a.off[b * a.G];
    for (int e = tid; e < a.pts * a.C; e += kThreads) {
      const int lj = e / a.C, c = e - lj * a.C, j = j0 + lj;
      if (j >= a.N) break;  // e only grows
      a.dp[((size_t)b * a.N + j) * a.C + c] = sum_rows(a.d1, a.C, c, st[j], st[j + 1], [&](int s) { return ls[s]; });
    }
  } else {  // dQ over (group, unit)
    const int g0 = (blockIdx.x - a.pull_blocks) * a.grp;
    for (int e = tid; e < a.grp * a.C; e += kThreads) {
      const int lg = e / a.C, c = e - lg * a.C, bg = g0 + lg;
      if (bg >= a.B * a.G) break;
      a.dq[(size_t)bg * a.C + c] = sum_rows(a.d1, a.C, c, a.off[bg], a.off[bg + 1], [](int s) { return s; });
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

int num_sms(int device) {
  static int cached[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (!cached[device]) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n < 1) n = 132;
    cached[device] = n;
  }
  return cached[device];
}

// The stack of L layers: params 5 device pointers a layer (w, b, mean, mul,
// beta), wstrides 2 a layer (w's strides along its input and output
// dimensions, in elements).  False when the shapes are not taken.
bool make_stack(int L, const int* dims, const void* const* params, const int* wstrides, float slope, Stack& st) {
  if (L < 2 || L > kMaxLayers || !(slope >= 0.f && slope <= 1.f)) return false;
  st = Stack{};
  st.L = L;
  st.slope = slope;
  for (int l = 0; l <= L; ++l) {
    if (dims[l] < 1) return false;
    st.dims[l] = dims[l];
  }
  int words = 0;
  for (int l = 0; l < L; ++l) {
    st.w[l] = static_cast<const float*>(params[5 * l]);
    st.b[l] = static_cast<const float*>(params[5 * l + 1]);
    st.mean[l] = static_cast<const float*>(params[5 * l + 2]);
    st.mul[l] = static_cast<const float*>(params[5 * l + 3]);
    st.beta[l] = static_cast<const float*>(params[5 * l + 4]);
    st.s0[l] = wstrides[2 * l];
    st.s1[l] = wstrides[2 * l + 1];
    if (st.s0[l] < 0 || st.s1[l] < 0) return false;
    if (l < L - 1) {
      st.woff[l] = words;
      words += (dims[l + 1] + 31) / 32;
    }
  }
  st.words = words;
  return words <= kMaxWords;
}

// The forward's two activation buffers: buf0 holds h_1 and every second
// hidden activation after it, buf1 the others; the last layer's staging
// tile ([T][kNC + 1]) takes the one its input is not in.
void fwd_bufs(const Stack& st, int& b0, int& b1) {
  b0 = b1 = 0;
  for (int l = 1; l < st.L; ++l) {  // h_l lies in buf (l - 1) % 2
    int& b = (l - 1) % 2 ? b1 : b0;
    b = act_ld(st.dims[l]) > b ? act_ld(st.dims[l]) : b;
  }
  int& z = (st.L - 2) % 2 ? b0 : b1;  // h_{L-1} lies in buf (L - 2) % 2
  z = kNC + 1 > z ? kNC + 1 : z;
}

size_t fwd_smem(const Stack& st) {
  int b0, b1;
  fwd_bufs(st, b0, b1);
  return sizeof(float) * ((size_t)kFwdRows * (b0 + b1) + kStages * kNC * kLDB) + 2 * sizeof(int) * kFwdRows;
}

// The backward's two cotangent buffers: buf0 holds the one-hot [T][C_L] and
// every second product's output after it, buf1 the others (none for L = 2).
void bwd_bufs(const Stack& st, int& b0, int& b1) {
  b0 = act_ld(st.dims[st.L]);
  b1 = 0;
  for (int l = st.L - 1, s = 0; l >= 2; --l, ++s) {
    const int ld = act_ld(st.dims[l]);
    int& b = s % 2 ? b0 : b1;
    b = ld > b ? ld : b;
  }
}

size_t bwd_smem(const Stack& st) {
  int b0, b1;
  bwd_bufs(st, b0, b1);
  return sizeof(float) * ((size_t)kBwdRows * (b0 + b1) + kStages * kNC * kLDB) +
         sizeof(int) * kBwdRows * (1 + (size_t)st.words);
}

size_t slots_smem(int K) { return sizeof(float4) * kBallTile + sizeof(int) * ((size_t)kWarps + (size_t)kWarps * K); }

// The dynamic shared memory a kernel was last allowed, by kernel and device.
template <class Kern>
cudaError_t allow_smem(Kern kernel, int device, size_t smem) {
  struct Fact { const void* fn; int device; size_t smem; };
  static Fact facts[16];
  static int nfacts = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < nfacts; ++i)
    if (facts[i].fn == fn && facts[i].device == device && facts[i].smem >= smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && nfacts < 16) facts[nfacts++] = {fn, device, smem};
  return e;
}

}  // namespace

extern "C" {

// device: the CUDA device index of every pointer and the stream.  xyz [B,
// N, 3] f32, ctr [B, G, Cc] f32 (Cc >= 3; the balls' centers are its first
// three columns), r2 the squared radius (float32 of the double radius *
// radius); idx [B, G, K] int32 receives the slots.  Returns a cudaError_t code.
int pca_ball_slots(int device, const void* xyz, const void* ctr, int B, int N, int G, int K, int Cc, float r2,
                   void* idx, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || G < 1 || K < 1 || Cc < 3) return (int)cudaErrorInvalidValue;
  const size_t smem = slots_smem(K);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(slots_kernel, device, smem);
  if (e != cudaSuccess) return (int)e;
  const SlotArgs a = {static_cast<const float*>(xyz), static_cast<const float*>(ctr), r2, N, G, K, Cc,
                      static_cast<int*>(idx)};
  slots_kernel<<<dim3((G + kWarps - 1) / kWarps, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Sign words a row for these layers (0 for shapes the stack does not take).
int pca_ball_sign_words(int L, const int* dims) {
  Stack st;
  const void* none[5 * kMaxLayers] = {};
  const int strides[2 * kMaxLayers] = {};
  if (L < 2 || L > kMaxLayers || !make_stack(L, dims, none, strides, 0.f, st)) return 0;
  return st.words;
}

// The forward stack: p [B*N, >= dims[1]] f32 at row stride sp, q [B*G, >=
// dims[1]] at row stride sq, idx [B, G, K] int32 in [0, N); params and
// wstrides as make_stack (layer 0's w unread: it is folded into p and q);
// y / am [B, G, dims[L]] f32 / int32; signs [B*G*K, words] uint32.
// Returns a cudaError_t code.
int pca_ball_stack_fwd(int device, const void* p, int sp, const void* q, int sq, const void* idx, int B, int N, int G,
                       int K, int L, const int* dims, const void* const* params, const int* wstrides, float slope,
                       void* y, void* am, void* signs, void* stream) {
  Stack st;
  if (B < 1 || N < 1 || G < 1 || K < 1 || K > kMaxK || !make_stack(L, dims, params, wstrides, slope, st) ||
      sp < dims[1] || sq < dims[1] || (long long)B * G * K * st.words > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(st);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(stack_fwd_kernel<kFwdRows>, device, smem);
  if (e != cudaSuccess) return (int)e;
  const int gpt = kFwdRows / K, BG = B * G;
  FwdArgs a = {static_cast<const float*>(p), static_cast<const float*>(q), sp, sq, static_cast<const int*>(idx),
               N, G, K, BG, gpt, 0, 0, st, static_cast<float*>(y), static_cast<int*>(am),
               static_cast<unsigned*>(signs)};
  fwd_bufs(st, a.buf0, a.buf1);
  stack_fwd_kernel<kFwdRows><<<(BG + gpt - 1) / gpt, kSThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The winning rows of am [BG, CL] int32 (each in [0, K)): mask [BG, ceil(K /
// 32)] uint32, counts [BG] int32 scratch, ticket one int32 that holds 0 (and
// holds 0 again after the launch), off [BG + 1] int32, wrow [BG * K] int32
// (the first off[BG] entries written).  Returns a cudaError_t code.
int pca_ball_winners(int device, const void* am, int BG, int K, int CL, void* mask, void* counts, void* ticket,
                     void* off, void* wrow, void* stream) {
  if (BG < 1 || K < 1 || K > kMaxK || CL < 1 || (long long)BG * K > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const WinArgs a = {static_cast<const int*>(am), BG, K, (K + 31) / 32, CL, static_cast<unsigned*>(mask),
                     static_cast<int*>(counts), static_cast<int*>(ticket), static_cast<int*>(off),
                     static_cast<int*>(wrow)};
  const int per = kWinThreads / 32, blocks = (BG + per - 1) / per;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  winners_kernel<<<blocks, kWinThreads, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  winners_place_kernel<<<blocks, kWinThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// d1 [off[BG], dims[1]] f32, the cotangent of each winning row's first-layer
// output P[j] + Q[i], for g = dy * mul_L [BG, dims[L]] f32 and am [BG,
// dims[L]] int32, from the winners (off, wrow, mask of pca_ball_winners)
// and the forward's signs; params and wstrides as pca_ball_stack_fwd.
// Returns a cudaError_t code.
int pca_ball_stack_bwd(int device, const void* off, const void* wrow, const void* mask, const void* am, const void* g,
                       const void* signs, int BG, int K, int L, const int* dims, const void* const* params,
                       const int* wstrides, float slope, void* d1, void* stream) {
  Stack st;
  if (BG < 1 || K < 1 || K > kMaxK || !make_stack(L, dims, params, wstrides, slope, st))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(st);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(stack_bwd_kernel<kBwdRows>, device, smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stack_bwd_kernel<kBwdRows>, kSThreads, smem);
  if (e != cudaSuccess) return (int)e;
  BwdArgs a = {static_cast<const int*>(off), static_cast<const int*>(wrow), static_cast<const unsigned*>(mask),
               static_cast<const int*>(am), static_cast<const float*>(g), static_cast<const unsigned*>(signs),
               BG, K, (K + 31) / 32, 0, 0, st, static_cast<float*>(d1)};
  bwd_bufs(st, a.buf0, a.buf1);
  const long long bound = ((long long)BG * (K < dims[L] ? K : dims[L]) + kBwdRows - 1) / kBwdRows;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * num_sms(device);
  const int grid = (int)(bound < cap ? (bound > 0 ? bound : 1) : cap);
  stack_bwd_kernel<kBwdRows><<<grid, kSThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The parts the reverse-list build splits a cloud's winners into at N
// points (0: N is too large for one block's shared memory).
int pca_ball_lists_parts(int N) { return N < 1 ? 0 : pca::hoist::lists_parts(N); }

// Each point's winning rows: start [B, N + 1] int32 (point j's entries of
// cloud b are list[off[b * G] + start[b, j] ...]) and list [BG * K] int32,
// the winner indices in ascending order, for idx [B, G, K] int32 in [0, N)
// and the winners (off, wrow).  parts from pca_ball_lists_parts(N).
// Returns a cudaError_t code.
int pca_ball_lists(int device, const void* idx, const void* off, const void* wrow, int B, int N, int G, int parts,
                   void* start, void* list, void* stream) {
  if (B < 1 || N < 1 || G < 1 || parts < 1 || parts > pca::hoist::lists_parts(N)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const WinEntries src = {static_cast<const int*>(idx), static_cast<const int*>(wrow), static_cast<const int*>(off), G};
  return (int)pca::hoist::launch_lists(src, B, N, parts, static_cast<int*>(start), static_cast<int*>(list),
                                       static_cast<cudaStream_t>(stream));
}

// dP [B, N, C] f32, each point's sum of d1 [winners, C] over its list, and
// dQ [B*G, C] f32, each group's sum over its winners, each in order from 0.
// Returns a cudaError_t code.
int pca_ball_pull(int device, const void* start, const void* list, const void* off, const void* d1, int B, int N,
                  int G, int C, void* dp, void* dq, void* stream) {
  if (B < 1 || N < 1 || G < 1 || C < 1 || (long long)B * G * C > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int pts = C >= kThreads ? 1 : kThreads / C;
  const long long pull_blocks = (long long)B * ((N + pts - 1) / pts);
  const long long q_blocks = ((long long)B * G + pts - 1) / pts;
  if (pull_blocks + q_blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const PullArgs a = {static_cast<const int*>(start), static_cast<const int*>(list), static_cast<const int*>(off),
                      static_cast<const float*>(d1), B, N, G, C, pts, pts, (int)pull_blocks,
                      static_cast<float*>(dp), static_cast<float*>(dq)};
  pull_kernel<<<(unsigned)(pull_blocks + q_blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
