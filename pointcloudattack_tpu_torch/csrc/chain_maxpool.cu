// Fused per-point Dense -> eval-BatchNorm (-> ReLU) chain with a max and a
// first-index argmax over the points, and its input gradient, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// pointcloudattack_tpu_torch/ops/chain_maxpool.py.
//
// Replaces the TPU kernels of pointcloudattack_tpu/ops/pallas/dense_max_kernel.py:
//   forward  _chain_fwd_pallas (pallas_call at :188, body _chain_fwd_kernel)
//   backward _chain_bwd_pallas (pallas_call at :216, body _chain_bwd_kernel)
// both reached through mlp_chain_maxpool.  For x [B, N, C0] and layers
// (W_l, b, mean, mul, beta) it computes, per point,
//   z_l = (h_l @ W_l + b_l - mean_l) * mul_l + beta_l,  h_l+1 = relu(z_l)
// (no ReLU after the last layer), then y[b, c] = max_n z_L[b, n, c] and
// idx[b, c] = the lowest n attaining it.  The backward takes
// g = dy * mul_L and returns dx [B, N, C0].  Every weight is read as the
// [out, in] row-major matrix a module holds (W_l is its transposed view).
//
// What bounds it on this card.  At PointNet's spine (B=64, N=1024, chain
// 3 -> 64 -> 128 -> 1024) one forward is 2 * 65,536 * (3*64 + 64*128 +
// 128*1024) ~= 18.3 GFLOP, 94% of it in the 128 -> 1024 layer, against
// 0.8 MB of input and 0.5 MB of output: operations bound it.  At
// PointNet++'s last set abstraction ([16, 128, 259] -> 256 -> 512 -> 1024)
// the hidden layers are 27% of 3 GFLOP.  The backward's least work is
// small: only the rows that win a column have a cotangent (9,771 of 65,536
// at the spine), and each column adds one row of W_L to one row.
//
// What the design does about it.
//   Forward, three launches:
//   * hidden stage: f32 FFMA (chain_common.cuh's register tiles, the weight
//     tiles staged transposed from [out, in], the next tile's loads in
//     flight during the FMAs) runs the hidden layers once a row and writes
//     the last hidden activation, tile by tile as [K][T], to an L2-resident
//     scratch; the tile height is picked so the grid fills the 132 SMs
//     where the shape allows, and a narrow chain's kernel holds no register
//     tile wider than 4 columns a thread, so two blocks share an SM.
//   * product stage: the wide layer on the tensor cores, mma.sync m16n8k8
//     TF32 with a 3xTF32 split (a = a_hi + a_lo, a*b ~= a_hi*b_hi +
//     a_hi*b_lo + a_lo*b_hi, f32 accumulate; each part keeps the top 10
//     mantissa bits by a mask, since cvt.rna's conversions bounded the
//     stage).  A block keeps its 128 (64, 32 when K is wide) rows of A
//     resident in shared memory, split once into its two parts where they
//     fit, and streams [128 x 32] weight tiles through a 3-stage cp.async
//     ring, so each weight tile is read once per 128 rows and its loads
//     overlap the MMAs.  The output columns split over blocks where the
//     rows alone give fewer blocks than SMs.  The epilogue applies the
//     BatchNorm and takes each column's (max, lowest row) on the
//     accumulators: in the thread, over the lanes, over the two row warps.
//   * reduce: the partials of the row tiles in tile order with a strict
//     '>' (argmax_reduce_kernel), so ties keep the lowest row.
//   Backward, two launches and a memset, work in proportion to the
//   winning rows, no atomics on values (two backwards give the same bits):
//   * lists stage, one block a cloud: a bitonic sort of the keys
//     (idx[c] << s) | c (a key a thread, partners in a warp by shuffles)
//     gives the columns grouped by winning row, rows and columns
//     ascending; a scan marks each row's first column, giving the winners
//     in ascending order and where each one's columns start; the last block
//     to finish turns the per-cloud counts into offsets of a packed winner
//     array.
//   * rows stage, a persistent grid over tiles of packed winners: the
//     hidden layers again with the forward's hidden-stage arithmetic (the
//     same ReLU signs), then the cotangent sum_c g[c] * W_L[:, c] over the
//     row's columns, the tile's (column, cotangent) pairs loaded by the
//     block at once and its columns split evenly over the 8 warps, eight
//     rows of W_L in flight a warp (a row that wins every column spreads
//     over the block), the pieces added in warp order; then the hidden
//     layers backward as small dense products; dx of every other row is 0
//     (a memset).  The tile's latency chain bounds it, so a narrow chain's
//     kernel keeps to 128 registers and two blocks share an SM.
//
// Shapes it takes: 1 <= L <= kMaxLayers, every width >= 1, the width
// entering the last layer <= 1024, dims[L] <= 32768, N << ceil(log2
// dims[L]) < 2^31; shared memory must fit at the smallest tiles.

#include <cstdint>

#include "chain_common.cuh"

namespace {

using namespace pca;

constexpr int kBN = 128;               // product stage: output columns a chunk
constexpr int kKC = 32;                // product stage: depth of a staged weight tile
constexpr int kStages = 3;             // cp.async ring depth
constexpr int kLDB = kKC + 4;          // weight tile row stride, = 4 (mod 32): conflict-free fragments
constexpr int kListThreads = 1024;
constexpr int kMaxListCols = 32768;    // lists stage: keys held in shared memory
constexpr int kOffSmem = 4096;         // rows stage: clouds whose offsets it keeps in shared memory

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// Hidden layers, f32 FFMA, weights [out, in] row-major.  The forward's
// hidden stage and the backward's recompute both run hidden_layer_wt, so a
// unit's value, and the side of 0 it falls on, is the same bits in both.
// ---------------------------------------------------------------------------

// The staged tile holds W^T as [KT][32 * TN]; groups of 4 columns are
// swizzled by the row, so that the transposing stores and the float4 reads
// of a row are both (nearly) free of bank conflicts.
__device__ __forceinline__ int swz(int kk, int cc) { return cc ^ ((kk & 7) << 2); }

template <int TN>
__device__ __forceinline__ void load_cols_swz(const float* wrow, int lane, int kk, float (&bv)[TN]) {
  const int m = kk & 7;
  if constexpr (TN == 8) {
    const float4 b0 = *reinterpret_cast<const float4*>(wrow + ((lane ^ m) << 2));
    const float4 b1 = *reinterpret_cast<const float4*>(wrow + 128 + ((lane ^ m) << 2));
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
  } else if constexpr (TN == 4) {
    const float4 b0 = *reinterpret_cast<const float4*>(wrow + ((lane ^ m) << 2));
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
  } else {
    const float2 b0 = *reinterpret_cast<const float2*>(wrow + ((lane << 1) ^ (m << 2)));
    bv[0] = b0.x; bv[1] = b0.y;
  }
}

// acc[i][j] = sum_k aT[k][warp*TM + i] * W[k][c0 + chunk_col<TN>(lane, j)],
// k ascending, each a fmaf from 0 (gemm_chunk's arithmetic), with W held
// [ncols][K] (kTrans: a forward layer's [out, in] weight) or [K][ncols] (a
// backward product through it).  Each thread holds its share of the next
// weight tile in registers while the block computes on the current one, so
// the loads overlap the FMAs.  Starts with a barrier, as gemm_chunk.
template <int TM, int TN, bool kTrans>
__device__ __forceinline__ void gemm_chunk2(const float* aT, int K, const float* __restrict__ w, int ncols,
                                            int c0, float* wtile, float (&acc)[TM][TN]) {
  // KT: the staged tile's depth, the same 16 KB deeper for a narrow chunk read
  // row by row (a transposing store would then meet bank conflicts)
  constexpr int T = 8 * TM, CW = 32 * TN, KT = kTrans ? kKTile : kKTile * 8 / TN, PER = KT * CW / kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = ((kTrans ? K : ncols) & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  float pre[PER];
  auto load = [&](int k0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < PER / 4; ++q) {
        const int e = tid + q * kThreads;
        int c, k;
        if (kTrans) { c = c0 + e / (KT / 4); k = k0 + 4 * (e % (KT / 4)); }
        else { c = c0 + 4 * (e % (CW / 4)); k = k0 + e / (CW / 4); }
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < ncols && k < K)
          v = __ldg(reinterpret_cast<const float4*>(kTrans ? w + (size_t)c * K + k : w + (size_t)k * ncols + c));
        pre[4 * q] = v.x; pre[4 * q + 1] = v.y; pre[4 * q + 2] = v.z; pre[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + q * kThreads;
        int c, k;
        if (kTrans) { c = c0 + e / KT; k = k0 + e % KT; }
        else { c = c0 + e % CW; k = k0 + e / CW; }
        pre[q] = (c < ncols && k < K) ? __ldg(kTrans ? w + (size_t)c * K + k : w + (size_t)k * ncols + c) : 0.f;
      }
    }
  };
  auto store = [&]() {
    if (vec) {
#pragma unroll
      for (int q = 0; q < PER / 4; ++q) {
        const int e = tid + q * kThreads;
        if (kTrans) {
          const int cc = e / (KT / 4), r = 4 * (e % (KT / 4));
#pragma unroll
          for (int u = 0; u < 4; ++u) wtile[(r + u) * CW + swz(r + u, cc)] = pre[4 * q + u];
        } else {
          const int kk = e / (CW / 4), cc = 4 * (e % (CW / 4));
          *reinterpret_cast<float4*>(wtile + kk * CW + swz(kk, cc)) =
              make_float4(pre[4 * q], pre[4 * q + 1], pre[4 * q + 2], pre[4 * q + 3]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + q * kThreads;
        const int kk = kTrans ? e % KT : e / CW, cc = kTrans ? e / KT : e % CW;
        wtile[kk * CW + swz(kk, cc)] = pre[q];
      }
    }
  };
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  load(0);
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
    store();
    __syncthreads();
    if (k0 + KT < K) load(k0 + KT);
    const float* a = aT + (size_t)k0 * T + warp * TM;
    const int kn = min(KT, K - k0);
    auto step = [&](int kk) {
      float av[TM], bv[TN];
      load_rows<TM>(a + kk * T, av);
      load_cols_swz<TN>(wtile + kk * CW, lane, kk, bv);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    };
    if (kn == KT) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < kn; ++kk) step(kk);
    }
  }
}

template <int TM, int TN, bool kTrans, class Epi>
__device__ __forceinline__ void layer_pass2_tn(const float* aT, int K, const float* __restrict__ w, int ncols,
                                               float* wtile, Epi& epi) {
  float acc[TM][TN];
  for (int c0 = 0; c0 < ncols; c0 += 32 * TN) {
    gemm_chunk2<TM, TN, kTrans>(aT, K, w, ncols, c0, wtile, acc);
    epi(c0, acc);
  }
}

// One layer pass over ncols output columns, in chunks of 32 * TN columns
// with TN picked by the width, as layer_pass, at most kMaxTN (a kernel for
// narrow chains then holds no wider register tile); epi(c0, acc) takes each
// chunk.
template <int TM, bool kTrans, int kMaxTN, class Epi>
__device__ __forceinline__ void layer_pass2(const float* aT, int K, const float* __restrict__ w, int ncols,
                                            float* wtile, Epi epi) {
  if constexpr (kMaxTN >= 8) {
    if (ncols > 128) return layer_pass2_tn<TM, 8, kTrans>(aT, K, w, ncols, wtile, epi);
  }
  if constexpr (kMaxTN >= 4) {
    if (ncols > 64) return layer_pass2_tn<TM, 4, kTrans>(aT, K, w, ncols, wtile, epi);
  }
  layer_pass2_tn<TM, 2, kTrans>(aT, K, w, ncols, wtile, epi);
}

// Layer l (Dense + eval-BN + ReLU) from in [dims[l]][T] into out
// [dims[l+1]][T], both shared; ch.wt[l] is its [out, in] weight.
template <int TM, int kMaxTN>
__device__ __forceinline__ void hidden_layer_wt(const Chain& ch, int l, const float* in, float* out,
                                                float* wtile) {
  constexpr int T = 8 * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = ch.dims[l + 1];
  layer_pass2<TM, true, kMaxTN>(in, ch.dims[l], ch.wt[l], C, wtile, [&](int c0, auto& acc) {
    constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + chunk_col<TN>(lane, j);
      if (c >= C) continue;
      const float bb = __ldg(ch.b[l] + c), mm = __ldg(ch.mean[l] + c), mu = __ldg(ch.mul[l] + c),
                  be = __ldg(ch.beta[l] + c);
      float h[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) h[i] = act_fwd((acc[i][j] + bb - mm) * mu + be, ch.slope);
      store_rows<TM>(out + c * T + warp * TM, h);
    }
  });
}

// The layers below the last, backward, as chain_common.cuh's
// chain_bwd_hidden but through layer_pass2: gin ([dims[L-1]][T]) holds the
// cotangent at layer L-2's matmul output; store(r, k, v) receives the input
// cotangent of row r, column k.
template <int TM, int kMaxTN, class Store>
__device__ __forceinline__ void bwd_hidden(const Chain& ch, float* const* act, float* gin, float* gout,
                                           float* wtile, Store store) {
  constexpr int T = 8 * TM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = ch.L - 2; l >= 0; --l) {
    const int C = ch.dims[l];
    layer_pass2<TM, false, kMaxTN>(gin, ch.dims[l + 1], ch.wt[l], C, wtile, [&](int c0, auto& acc) {
      constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + chunk_col<TN>(lane, j);
        if (c >= C) continue;
        if (l > 0) {
          const float mu = __ldg(ch.mul[l - 1] + c);
          float hv[TM], v[TM];
          load_rows<TM>(act[l] + c * T + warp * TM, hv);
#pragma unroll
          for (int i = 0; i < TM; ++i) v[i] = act_bwd_mul(hv[i], acc[i][j], mu, ch.slope);
          store_rows<TM>(gout + c * T + warp * TM, v);
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) store(warp * TM + i, c, acc[i][j]);
        }
      }
    });
    float* t = gin; gin = gout; gout = t;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The hidden layers of T = 8 * TM rows of one cloud; writes the last
// hidden activation (x itself when L == 1) as H[b][tile] = [Kp][T], rows
// past dims[L-1] zero.  Rows past N run on zero inputs; the product stage
// ignores them.
template <int TM, int kMaxTN>
__global__ void __launch_bounds__(kThreads, kMaxTN <= 4 ? 2 : 1)
    hidden_kernel(const float* __restrict__ x, int N, Chain ch, int Kp, float* __restrict__ H) {
  constexpr int T = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, b = blockIdx.y, nth = gridDim.x, row0 = tile * T;
  const int L = ch.L, C0 = ch.dims[0], Cm = ch.dims[L - 1];
  int maxw = C0;
  for (int l = 1; l < L; ++l) maxw = max(maxw, ch.dims[l]);
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + (size_t)maxw * T;
  float* wtile = nxt + (size_t)maxw * T;

  const float* xb = x + ((size_t)b * N + row0) * C0;
  fill_tile<TM>(C0, [&](int r, int k) { return (row0 + r < N) ? xb[(size_t)r * C0 + k] : 0.f; }, cur);
  for (int l = 0; l < L - 1; ++l) {
    hidden_layer_wt<TM, kMaxTN>(ch, l, cur, nxt, wtile);
    float* t = cur; cur = nxt; nxt = t;
  }
  __syncthreads();
  float* out = H + ((size_t)b * nth + tile) * Kp * T;
  for (int e = threadIdx.x; e < Kp * T; e += kThreads) out[e] = (e / T < Cm) ? cur[e] : 0.f;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// x = hi + lo + e, |e| < 2^-20 |x|: hi keeps the 10 mantissa bits of TF32
// and lo those of x - hi (exact in f32), both by dropping the 13 low bits.
// A mask and a subtraction: cvt.rna's rounding costs a conversion-unit
// instruction per part, which bounded the product stage.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct WideArgs {
  const float* H;  // [B][nth][Kp][T]
  int nth, T, Kp, N, nmt;
  const float* wt;  // [CL][K]
  int K, CL, cps;   // cps: 128-column chunks a block
  const float *b, *mean, *mul, *beta;
  float* part_v;  // [B][nmt][CL]
  int* part_i;
};

// The last layer of BM = 32 * MT rows of one cloud (grid.x: nmt row tiles
// of each cloud) over cps chunks of 128 columns (grid.y), each row's
// (max, lowest row) per column into the partials.  8 warps, 2 x 4, each
// (16 * MT) x 32 of a chunk.  kPre: A is split into its two TF32 parts once,
// in shared memory, rather than by each of the 4 column warps at every
// chunk (where the two copies fit).
template <int MT, bool kPre>
__global__ void __launch_bounds__(kThreads) wide_kernel(WideArgs a) {
  constexpr int BM = 32 * MT, LDA = BM + 8;  // LDA = 8 (mod 32): conflict-free A fragments
  extern __shared__ __align__(16) float sm[];
  float* As = sm;                                    // [Kp][LDA], A transposed (kPre: its high parts)
  unsigned* Al = reinterpret_cast<unsigned*>(As + (kPre ? (size_t)a.Kp * LDA : 0));  // kPre: the low parts
  float* Bs = reinterpret_cast<float*>(Al) + (size_t)a.Kp * LDA;  // [kStages][kBN][kLDB]
  float* red_v = Bs + kStages * kBN * kLDB;          // [2][kBN]
  int* red_i = reinterpret_cast<int*>(red_v + 2 * kBN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int mtile = blockIdx.x % a.nmt, b = blockIdx.x / a.nmt, m0 = mtile * BM;
  const int nchunks = (a.CL + kBN - 1) / kBN;
  const int ch0 = blockIdx.y * a.cps, ch1 = min(nchunks, ch0 + a.cps);
  if (ch0 >= ch1) return;
  const int nks = a.Kp / kKC, nsteps = (ch1 - ch0) * nks;
  const bool vecb = (a.K & 3) == 0 && (reinterpret_cast<uintptr_t>(a.wt) & 15) == 0;

  {  // A: BM / T hidden tiles, zero past the cloud's last
    const int per = a.T >> 2, ntl = BM / a.T, total = a.Kp * ntl * per;
    for (int e = tid; e < total; e += kThreads) {
      const int q = e % per, rest = e / per, j = rest % ntl, k = rest / ntl;
      const int th = m0 / a.T + j;
      const bool ok = th < a.nth;
      const float* src = a.H + (((size_t)b * a.nth + (ok ? th : 0)) * a.Kp + k) * a.T + 4 * q;
      cp_async16(As + (size_t)k * LDA + j * a.T + 4 * q, src, ok ? 16 : 0);
    }
  }
  auto load_b = [&](int step, int slot) {
    const int c0 = (ch0 + step / nks) * kBN, k0 = (step % nks) * kKC;
    float* dst = Bs + (size_t)slot * kBN * kLDB;
    if (vecb) {
      for (int e = tid; e < kBN * kKC / 4; e += kThreads) {
        const int q = e % (kKC / 4), n = e / (kKC / 4), c = c0 + n, k = k0 + 4 * q;
        const bool ok = c < a.CL && k < a.K;
        cp_async16(dst + n * kLDB + 4 * q, a.wt + (ok ? (size_t)c * a.K + k : 0), ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBN * kKC; e += kThreads) {
        const int q = e % kKC, n = e / kKC, c = c0 + n, k = k0 + q;
        const bool ok = c < a.CL && k < a.K;
        cp_async4(dst + n * kLDB + q, a.wt + (ok ? (size_t)c * a.K + k : 0), ok ? 4 : 0);
      }
    }
  };
  load_b(0, 0);
  cp_async_commit();  // group 0: A and the first weight tile
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < nsteps) load_b(s, s);
    cp_async_commit();
  }

  if (kPre) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    for (int e = tid; e < a.Kp * LDA; e += kThreads) {
      unsigned hi, lo;
      split_tf32(As[e], hi, lo);
      As[e] = __uint_as_float(hi);
      Al[e] = lo;
    }
  }

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tile has landed; the slot refilled below is free
    if (step + kStages - 1 < nsteps) load_b(step + kStages - 1, (step + kStages - 1) % kStages);
    cp_async_commit();
    const float* Bst = Bs + (size_t)(step % kStages) * kBN * kLDB + (wn * 32 + g) * kLDB + t;
    const float* Ast = As + (size_t)((step % nks) * kKC + t) * LDA + wm * (16 * MT) + g;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(Bst[j * 8 * kLDB + kk], bh[j][0], bl[j][0]);
        split_tf32(Bst[j * 8 * kLDB + kk + 4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* ap = Ast + (size_t)kk * LDA + i * 16;
        unsigned ah[4], al[4];
        if (kPre) {
          const unsigned* lp = Al + (ap - As);
          ah[0] = __float_as_uint(ap[0]); ah[1] = __float_as_uint(ap[8]);
          ah[2] = __float_as_uint(ap[4 * LDA]); ah[3] = __float_as_uint(ap[4 * LDA + 8]);
          al[0] = lp[0]; al[1] = lp[8]; al[2] = lp[4 * LDA]; al[3] = lp[4 * LDA + 8];
        } else {
          split_tf32(ap[0], ah[0], al[0]);
          split_tf32(ap[8], ah[1], al[1]);
          split_tf32(ap[4 * LDA], ah[2], al[2]);
          split_tf32(ap[4 * LDA + 8], ah[3], al[3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
          mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
          mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
    if (step % nks != nks - 1) continue;

    // epilogue of a 128-column chunk: BN, then (max, lowest row) per column
    const int c0 = (ch0 + step / nks) * kBN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int cl = wn * 32 + j * 8 + 2 * t + q, c = c0 + cl;
        float best = -INFINITY;
        int arg = INT_MAX;
        if (c < a.CL) {
          const float bb = __ldg(a.b + c), mm = __ldg(a.mean + c), mu = __ldg(a.mul + c),
                      be = __ldg(a.beta + c);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // rows ascending
              const int row = m0 + wm * (16 * MT) + i * 16 + g + 8 * h;
              const float z = (acc[i][j][2 * h + q] + bb - mm) * mu + be;
              if (row < a.N && z > best) { best = z; arg = row; }
            }
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // over the 8 lanes g of this column
          const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
          const int i2 = __shfl_xor_sync(0xffffffffu, arg, o);
          if (v2 > best || (v2 == best && i2 < arg)) { best = v2; arg = i2; }
        }
        if (g == 0) {
          red_v[wm * kBN + cl] = best;
          red_i[wm * kBN + cl] = arg;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    __syncthreads();
    if (tid < kBN && c0 + tid < a.CL) {  // the upper row warp's rows come later: strict '>'
      float best = red_v[tid];
      int arg = red_i[tid];
      if (red_v[kBN + tid] > best) { best = red_v[kBN + tid]; arg = red_i[kBN + tid]; }
      const size_t o = ((size_t)b * a.nmt + mtile) * a.CL + c0 + tid;
      a.part_v[o] = best;
      a.part_i[o] = arg;
    }
    // red_* are written again only after the next step's barrier
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Exclusive prefix sums of val(0..n-1) by the block, each thread a
// contiguous run; out(i, prefix) for each i; returns the total.  ws: 32
// shared ints.  Every thread of the block must call it.
template <class Val, class Out>
__device__ int block_scan(int n, Val val, Out out, int* ws) {
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int per = (n + nt - 1) / nt, lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += val(i);
  int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane < nw) ws[lane] = v;
  }
  __syncthreads();
  int run = incl - s + (warp ? ws[warp - 1] : 0);
  const int total = ws[nw - 1];
  for (int i = lo; i < hi; ++i) {
    const int v = val(i);
    out(i, run);
    run += v;
  }
  __syncthreads();
  return total;
}

struct ListArgs {
  const int* idx;  // [B][CL]
  int B, N, CL, P, shift, wcap;
  int* counts;  // [B], then the ticket
  int* off;     // [B + 1]: winners before each cloud, then the total
  int* wrow;    // [B][wcap]: each cloud's winning rows, ascending; -1 past its count
  int* cstart;  // [B][wcap]: where each winner's columns start in cols
  int* cols;    // [B * CL]: each cloud's columns, grouped by winning row
};

__global__ void __launch_bounds__(kListThreads) lists_kernel(ListArgs a) {
  extern __shared__ int keys[];  // [P], and [2P] when P <= the block's threads
  __shared__ int ws[32];
  __shared__ bool last;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int* id = a.idx + (size_t)b * a.CL;
  // bitonic sort, ascending
  if (a.P <= nt) {  // a key a thread: partners within a warp by shuffles, others through shared memory
    int key = tid < a.CL ? (id[tid] << a.shift) | tid : INT_MAX;
    int flip = 0;  // which half of keys the next exchange goes through
    for (int k = 2; k <= a.P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        int other;
        if (j >= 32) {
          int* xb = keys + flip * a.P;
          if (tid < a.P) xb[tid] = key;
          __syncthreads();
          other = tid < a.P ? xb[tid ^ j] : INT_MAX;
          flip ^= 1;
        } else {
          other = __shfl_xor_sync(0xffffffffu, key, j);
        }
        key = (((tid & j) == 0) == ((tid & k) == 0)) ? min(key, other) : max(key, other);
      }
    }
    __syncthreads();
    if (tid < a.P) keys[tid] = key;
  } else {
    for (int i = tid; i < a.P; i += nt) keys[i] = i < a.CL ? (id[i] << a.shift) | i : INT_MAX;
    __syncthreads();
    for (int k = 2; k <= a.P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < a.P; i += nt) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const int u = keys[i], v = keys[ixj];
            if ((u > v) == ((i & k) == 0)) { keys[i] = v; keys[ixj] = u; }
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  const int mask = (1 << a.shift) - 1;
  int* cl = a.cols + (size_t)b * a.CL;
  for (int i = tid; i < a.CL; i += nt) cl[i] = keys[i] & mask;
  auto first = [&](int i) { return (i == 0 || (keys[i] >> a.shift) != (keys[i - 1] >> a.shift)) ? 1 : 0; };
  int* wr = a.wrow + (size_t)b * a.wcap;
  int* cs = a.cstart + (size_t)b * a.wcap;
  const int nwin = block_scan(a.CL, first, [&](int i, int p) {
    if (first(i)) { wr[p] = keys[i] >> a.shift; cs[p] = b * a.CL + i; }
  }, ws);
  for (int i = nwin + tid; i < a.wcap; i += nt) { wr[i] = -1; cs[i] = -1; }
  // the last block to finish turns the counts into offsets
  if (tid == 0) {
    a.counts[b] = nwin;
    __threadfence();
    last = atomicAdd(a.counts + a.B, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    const int tot = block_scan(a.B, [&](int i) { return __ldcg(a.counts + i); },
                               [&](int i, int p) { a.off[i] = p; }, ws);
    if (tid == 0) a.off[a.B] = tot;
  }
}

struct RowsArgs {
  const float* x;
  int B, N, wcap;
  Chain ch;
  const int *off, *wrow, *cstart, *cols;
  const float* g;  // [B][CL]
  float* dx;
};

// The cotangent at the last layer's input of each tile row: sum over the
// row's columns c, ascending, of g[c] * W_L[:, c] into gsum [T][Cm + 1].
// The tile's columns [ecs[0], ecs[T]) split evenly over the warps; a warp
// writes a row whose first column it holds into gsum, and the piece of a
// row that began before its share into head[warp]; the pieces are added
// in warp order afterwards.  Lanes take units k = q * 32 + lane.
// Row r's sum out of acc (then zeroed): into gsum if the warp's share
// [s0, ...) holds the row's first column, else into the warp's head.
template <int Q>
__device__ __forceinline__ void flush_row(float (&acc)[Q], const int* ecs, int s0, int r, float* gsum,
                                          float* head, int* hrow, int Cm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* dst = ecs[r] >= s0 ? gsum + (size_t)r * (Cm + 1) : head + (size_t)warp * Cm;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = q * 32 + lane;
    if (k < Cm) dst[k] = acc[q];
    acc[q] = 0.f;
  }
  if (ecs[r] < s0 && lane == 0) hrow[warp] = r;
}

// A warp's share [s0, s1) of the tile's columns into acc, rows flushed as
// they end; kSmem: every (column, cotangent) of the share is in the
// prefetched ecol / egv (from entry E0), else read from device memory.
template <int Q, int NB, bool kSmem>
__device__ __forceinline__ void expand_share(const RowsArgs& a, const int* ecs, int s0, int s1, int E0,
                                             const int* ecol, const float* egv, const float* wl, float (&acc)[Q],
                                             int& r, float* gsum, float* head, int* hrow) {
  const int lane = threadIdx.x & 31;
  const int L = a.ch.L, Cm = a.ch.dims[L - 1], CL = a.ch.dims[L];
  for (int e0 = s0; e0 < s1; e0 += NB) {
    float wv[NB][Q];  // NB columns' rows of W_L, loaded before any is used
    int cs[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int e = e0 + u;
      cs[u] = e < s1 ? (kSmem ? ecol[e - E0] : __ldg(a.cols + e)) : 0;
      const float* w = wl + (size_t)cs[u] * Cm;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int k = q * 32 + lane;
        wv[u][q] = (e < s1 && k < Cm) ? __ldg(w + k) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int e = e0 + u;
      if (e >= s1) break;
      while (e >= ecs[r + 1]) flush_row<Q>(acc, ecs, s0, r++, gsum, head, hrow, Cm);
      const float gi = kSmem ? egv[e - E0] : __ldg(a.g + (size_t)(e / CL) * CL + cs[u]);
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[q] = fmaf(gi, wv[u][q], acc[q]);
    }
  }
}

template <int Q>
__device__ __forceinline__ void expand(const RowsArgs& a, int T, const int* ecs, float* gsum, float* head,
                                       int* hrow, float* wtile) {
  constexpr int NB = Q <= 4 ? 8 : (Q <= 16 ? 4 : 2);  // columns in flight a lane
  constexpr int kPreE = kKTile * kChunk / 2;          // entries the idle weight tile holds
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.ch.L, Cm = a.ch.dims[L - 1], CL = a.ch.dims[L];
  const float* wl = a.ch.wt[L - 1];  // [CL][Cm]: column c of W_L is row c
  const int E0 = ecs[0], E1 = ecs[T], per = (E1 - E0 + kWarps - 1) / kWarps;
  const int s0 = E0 + warp * per, s1 = min(E1, s0 + per);
  // the tile's first kPreE (column, cotangent) pairs, loaded by the block at once
  int* ecol = reinterpret_cast<int*>(wtile);
  float* egv = wtile + kPreE;
  __syncthreads();  // the last hidden layer is done with the weight tile
  for (int i = tid; i < min(E1 - E0, kPreE); i += kThreads) {
    const int c = __ldg(a.cols + E0 + i);
    ecol[i] = c;
    egv[i] = __ldg(a.g + (size_t)((E0 + i) / CL) * CL + c);
  }
  __syncthreads();
  if (lane == 0) hrow[warp] = -1;
  if (s0 >= s1) return;
  int r = 0;
  while (ecs[r + 1] <= s0) ++r;
  float acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.f;
  if (s1 - E0 <= kPreE)
    expand_share<Q, NB, true>(a, ecs, s0, s1, E0, ecol, egv, wl, acc, r, gsum, head, hrow);
  else
    expand_share<Q, NB, false>(a, ecs, s0, s1, E0, ecol, egv, wl, acc, r, gsum, head, hrow);
  flush_row<Q>(acc, ecs, s0, r, gsum, head, hrow, Cm);
}

// Q: the expansion's units a lane, ceil(dims[L-1] / 32) rounded up to 4, 16
// or 32; kMaxTN: the widest register tile its layer passes need (4: no width
// above 128); template arguments, so each kernel holds only its own
// registers.
template <int TM, int Q, int kMaxTN>
__global__ void __launch_bounds__(kThreads, kMaxTN <= 4 ? 2 : 1) rows_kernel(RowsArgs a) {
  constexpr int T = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const Chain& ch = a.ch;
  const int tid = threadIdx.x;
  const int L = ch.L, C0 = ch.dims[0], Cm = ch.dims[L - 1], CL = ch.dims[L];
  int maxg = L == 1 ? C0 : 1;
  for (int l = 1; l < L; ++l) maxg = max(maxg, ch.dims[l]);
  float* act[kMaxLayers];  // act[0]: x rows; act[l]: h_l
  float* p = reinterpret_cast<float*>(smem);
  for (int l = 0; l < L; ++l) { act[l] = p; p += (size_t)ch.dims[l] * T; }
  float* gin = p;  p += (size_t)maxg * T;
  float* gout = p; p += (size_t)maxg * T + T;
  float* wtile = p; p += kKTile * kChunk;
  int* ecs = reinterpret_cast<int*>(p);  // [T + 1]: each row's first column in cols
  int* rcl = ecs + T + 1;                // [T]: the row's cloud, -1 past the winners
  int* rrow = rcl + T;                   // [T]: its row in the cloud
  int* hrow = rrow + T;                  // [kWarps]
  int* soff = hrow + kWarps;             // [B + 1] when B < kOffSmem
  float* gsum = gout;  // [T][Cm + 1] until the mask pass
  float* head = gin;   // [kWarps][Cm] until the mask pass

  const int* off = a.off;
  if (a.B < kOffSmem) {
    for (int i = tid; i <= a.B; i += kThreads) soff[i] = a.off[i];
    off = soff;
  }
  __syncthreads();
  const int total = off[a.B], ntiles = (total + T - 1) / T;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile is done with every buffer
    for (int r = tid; r <= T; r += kThreads) {
      const int pk = tile * T + r;
      int e = a.B * CL, cl = -1, row = 0;
      if (pk < total) {
        int lo = 0, hi = a.B - 1;  // the last cloud with off <= pk
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (off[mid] <= pk) lo = mid; else hi = mid - 1;
        }
        const size_t s = (size_t)lo * a.wcap + (pk - off[lo]);
        e = a.cstart[s];
        cl = lo;
        row = a.wrow[s];
      }
      ecs[r] = e;
      if (r < T) { rcl[r] = cl; rrow[r] = row; }
    }
    __syncthreads();
    fill_tile<TM>(C0, [&](int r, int k) {
      return rcl[r] >= 0 ? a.x[((size_t)rcl[r] * a.N + rrow[r]) * C0 + k] : 0.f;
    }, act[0]);
    for (int l = 0; l < L - 1; ++l) hidden_layer_wt<TM, kMaxTN>(ch, l, act[l], act[l + 1], wtile);
    expand<Q>(a, T, ecs, gsum, head, hrow, wtile);
    __syncthreads();
    for (int k = tid; k < Cm; k += kThreads)
      for (int w = 0; w < kWarps; ++w)
        if (hrow[w] >= 0) gsum[(size_t)hrow[w] * (Cm + 1) + k] += head[(size_t)w * Cm + k];
    __syncthreads();
    auto store = [&](int r, int k, float v) {
      if (rcl[r] >= 0) a.dx[((size_t)rcl[r] * a.N + rrow[r]) * C0 + k] = v;
    };
    if (L == 1) {
      for_tile<TM>(C0, [&](int r, int k) { store(r, k, gsum[(size_t)r * (Cm + 1) + k]); });
      continue;
    }
    const float* hl = act[L - 1];
    const float* mu = ch.mul[L - 2];
    fill_tile<TM>(Cm, [&](int r, int k) {
      return rcl[r] >= 0 ? act_bwd_mul(hl[k * T + r], gsum[(size_t)r * (Cm + 1) + k], __ldg(mu + k), ch.slope)
                         : 0.f;
    }, gin);
    bwd_hidden<TM, kMaxTN>(ch, act, gin, gout, wtile, store);
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

bool check_dims(int B, int N, int L, const int* dims) {
  if (B < 1 || B > 65535 || N < 1 || L < 1 || L > kMaxLayers) return false;
  for (int l = 0; l <= L; ++l)
    if (dims[l] < 1) return false;
  return dims[L - 1] <= kMaxRowWidth && dims[L] <= kMaxListCols && (long long)B * dims[L] < INT_MAX;
}

struct FwdPlan {
  int tm, tn, T, nth, Kp, mt, pre, nmt, nsplit, cps;
  size_t smem_h, smem_w, h_floats, parts;
};

// Tile sizes of the forward: product-stage rows BM = 32 * mt, the largest
// whose tiles fit, with A split once (pre) where that fits; hidden-stage
// rows T <= BM, the largest that fits and gives at least one block an SM,
// else the smallest that fits, and its widest register tile tn; column
// splits until the product stage has a block an SM.
bool fwd_plan(int B, int N, int L, const int* dims, int nsm, FwdPlan& p) {
  if (!check_dims(B, N, L, dims)) return false;
  const int Cm = dims[L - 1], CL = dims[L];
  p.Kp = round_up(Cm, kKC);
  p.mt = 0;
  for (int mt = 4; mt >= 1 && !p.mt; mt >>= 1)
    for (int pre = 1; pre >= 0; --pre) {
      const size_t s =
          sizeof(float) * ((1 + pre) * (size_t)p.Kp * (32 * mt + 8) + kStages * kBN * kLDB + 4 * kBN);
      if (s <= kMaxSmem) { p.mt = mt; p.pre = pre; p.smem_w = s; break; }
    }
  if (!p.mt) return false;
  const int BM = 32 * p.mt;
  p.nmt = (N + BM - 1) / BM;
  const int nchunks = (CL + kBN - 1) / kBN;
  int split = 1;
  while (split < nchunks && (long long)p.nmt * B * split < nsm) split *= 2;
  p.cps = (nchunks + split - 1) / split;
  p.nsplit = (nchunks + p.cps - 1) / p.cps;
  p.parts = (size_t)B * p.nmt * CL;
  int maxw = dims[0], wide = 0;
  for (int l = 1; l < L; ++l) {
    maxw = max(maxw, dims[l]);
    wide = max(wide, dims[l]);
  }
  p.tn = wide <= 128 ? 4 : 8;
  p.tm = 0;
  for (int tm = 8; tm >= 2; tm >>= 1) {
    const int T = 8 * tm;
    const size_t bytes = sizeof(float) * (2 * (size_t)maxw * T + kKTile * kChunk);
    if (T > BM || bytes > kMaxSmem) continue;
    p.tm = tm;
    p.smem_h = bytes;
    if ((long long)B * ((N + T - 1) / T) >= nsm) break;
  }
  if (!p.tm) return false;
  p.T = 8 * p.tm;
  p.nth = (N + p.T - 1) / p.T;
  p.h_floats = (size_t)B * p.nth * p.Kp * p.T;
  return true;
}

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

size_t rows_smem(int B, int L, const int* dims, int tm) {
  const size_t T = 8 * (size_t)tm;
  int maxg = L == 1 ? dims[0] : 1;
  for (int l = 1; l < L; ++l) maxg = max(maxg, dims[l]);
  size_t f = 0;
  for (int l = 0; l < L; ++l) f += dims[l] * T;
  f += 2 * maxg * T + T + kKTile * kChunk;
  return sizeof(float) * f + sizeof(int) * (3 * T + 1 + kWarps + (B < kOffSmem ? B + 1 : 0));
}

// The rows stage's tile: the tallest that fits; 0 if none does.
int rows_tm(int B, int L, const int* dims) {
  for (int tm = 4; tm >= 2; tm >>= 1)
    if (rows_smem(B, L, dims, tm) <= kMaxSmem) return tm;
  return 0;
}

Chain chain_from(int L, const int* dims, const void* const* params) {
  Chain ch = make_chain(L, dims, params, nullptr);
  for (int l = 0; l < L; ++l) {  // every weight arrives [out, in]
    ch.wt[l] = ch.w[l];
    ch.w[l] = nullptr;
  }
  return ch;
}

// What a kernel was last allowed and how many of its blocks fit an SM, by
// kernel and device: each is asked of the runtime once, not on every launch.
struct KernelFacts {
  const void* fn;
  int device;
  size_t smem;
  int per_sm;
};
KernelFacts g_facts[64];
int g_nfacts = 0;

KernelFacts& facts(const void* fn) {
  int device = 0;
  cudaGetDevice(&device);
  for (int i = 0; i < g_nfacts; ++i)
    if (g_facts[i].fn == fn && g_facts[i].device == device) return g_facts[i];
  KernelFacts& f = g_facts[g_nfacts < 63 ? g_nfacts++ : 63];
  f = {fn, device, 0, 0};
  return f;
}

template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  KernelFacts& f = facts(reinterpret_cast<const void*>(kernel));
  if (f.smem >= smem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) { f.smem = smem; f.per_sm = 0; }
  return e;
}

// Blocks of `kernel` an SM holds at `smem` bytes (after allow_smem).
template <class K>
cudaError_t blocks_per_sm(K kernel, size_t smem, int& per_sm) {
  KernelFacts& f = facts(reinterpret_cast<const void*>(kernel));
  if (!f.per_sm || f.smem != smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    f.smem = smem;
  }
  per_sm = f.per_sm;
  return cudaSuccess;
}

template <int TM, int kMaxTN>
cudaError_t launch_hidden(const float* x, int B, int N, const Chain& ch, const FwdPlan& p, float* H,
                          cudaStream_t s) {
  cudaError_t e = allow_smem(hidden_kernel<TM, kMaxTN>, p.smem_h);
  if (e != cudaSuccess) return e;
  hidden_kernel<TM, kMaxTN><<<dim3(p.nth, B), kThreads, p.smem_h, s>>>(x, N, ch, p.Kp, H);
  return cudaGetLastError();
}

template <int MT, bool kPre>
cudaError_t launch_wide(const WideArgs& a, int B, const FwdPlan& p, cudaStream_t s) {
  cudaError_t e = allow_smem(wide_kernel<MT, kPre>, p.smem_w);
  if (e != cudaSuccess) return e;
  wide_kernel<MT, kPre><<<dim3(p.nmt * B, p.nsplit), kThreads, p.smem_w, s>>>(a);
  return cudaGetLastError();
}

template <int TM, int Q, int kMaxTN>
cudaError_t launch_rows(const RowsArgs& a, int device, int bound_rows, cudaStream_t s) {
  const size_t smem = rows_smem(a.B, a.ch.L, a.ch.dims, TM);
  cudaError_t e = allow_smem(rows_kernel<TM, Q, kMaxTN>, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = blocks_per_sm(rows_kernel<TM, Q, kMaxTN>, smem, per_sm);
  if (e != cudaSuccess) return e;
  const int tiles = (bound_rows + 8 * TM - 1) / (8 * TM);
  const int grid = max(1, min(tiles, max(1, per_sm) * num_sms(device)));
  rows_kernel<TM, Q, kMaxTN><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_rows_q(const RowsArgs& a, int device, int bound_rows, cudaStream_t s) {
  const Chain& ch = a.ch;
  int wide = 0;  // the widest output of a layer pass: the hidden layers' both ways
  for (int l = 0; l < ch.L - 1; ++l) wide = max(wide, max(ch.dims[l], ch.dims[l + 1]));
  const int Cm = ch.dims[ch.L - 1];
  if (Cm <= 128 && wide <= 128) return launch_rows<TM, 4, 4>(a, device, bound_rows, s);
  if (Cm <= 128) return launch_rows<TM, 4, 8>(a, device, bound_rows, s);
  if (Cm <= 512) return launch_rows<TM, 16, 8>(a, device, bound_rows, s);
  return launch_rows<TM, kMaxRowWidth / 32, 8>(a, device, bound_rows, s);
}

}  // namespace

extern "C" {

size_t pca_chain_max_smem(void) { return kMaxSmem; }

const char* pca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of scratch pca_chain_fwd needs on `device`; 0 for shapes it does
// not take.
size_t pca_chain_fwd_workspace(int device, int B, int N, int L, const int* dims) {
  FwdPlan p;
  if (!fwd_plan(B, N, L, dims, num_sms(device), p)) return 0;
  return align256(sizeof(float) * p.h_floats) + 2 * align256(sizeof(float) * p.parts);
}

// device: the CUDA device index of every pointer and the stream.
// x [B, N, dims[0]]; params: 5 device pointers per layer (w^T [dims[l+1],
// dims[l]] row-major, b, mean, mul, beta [dims[l+1]]); ws: the workspace
// (pca_chain_fwd_workspace bytes); y / idx [B, dims[L]].  Returns a
// cudaError_t code (0 on success).
int pca_chain_fwd(int device, const void* x, int B, int N, int L, const int* dims,
                  const void* const* params, void* ws, void* y, void* idx, void* stream) {
  FwdPlan p;
  if (!fwd_plan(B, N, L, dims, num_sms(device), p)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);  // this library's runtime keeps its own current device
  if (e != cudaSuccess) return (int)e;
  const Chain ch = chain_from(L, dims, params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  float* H = reinterpret_cast<float*>(w);
  float* part_v = reinterpret_cast<float*>(w + align256(sizeof(float) * p.h_floats));
  int* part_i = reinterpret_cast<int*>(w + align256(sizeof(float) * p.h_floats) +
                                       align256(sizeof(float) * p.parts));
  const float* xf = static_cast<const float*>(x);
  switch (p.tm * 10 + p.tn) {
    case 84: e = launch_hidden<8, 4>(xf, B, N, ch, p, H, s); break;
    case 88: e = launch_hidden<8, 8>(xf, B, N, ch, p, H, s); break;
    case 44: e = launch_hidden<4, 4>(xf, B, N, ch, p, H, s); break;
    case 48: e = launch_hidden<4, 8>(xf, B, N, ch, p, H, s); break;
    case 24: e = launch_hidden<2, 4>(xf, B, N, ch, p, H, s); break;
    default: e = launch_hidden<2, 8>(xf, B, N, ch, p, H, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  const int l = L - 1;
  const WideArgs a = {H, p.nth, p.T, p.Kp, N, p.nmt, ch.wt[l], dims[l], dims[L], p.cps,
                      ch.b[l], ch.mean[l], ch.mul[l], ch.beta[l], part_v, part_i};
  switch (p.mt * 2 + p.pre) {
    case 9: e = launch_wide<4, true>(a, B, p, s); break;
    case 8: e = launch_wide<4, false>(a, B, p, s); break;
    case 5: e = launch_wide<2, true>(a, B, p, s); break;
    case 4: e = launch_wide<2, false>(a, B, p, s); break;
    case 3: e = launch_wide<1, true>(a, B, p, s); break;
    default: e = launch_wide<1, false>(a, B, p, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  const int total = B * dims[L];
  argmax_reduce_kernel<float><<<(total + 255) / 256, 256, 0, s>>>(
      part_v, part_i, p.nmt, dims[L], total, static_cast<float*>(y), static_cast<int*>(idx));
  return (int)cudaGetLastError();
}

// The winner lists of idx int32 [B, CL] (each entry a row in [0, N)):
// counts int32 [B + 1] scratch; off [B + 1], wrow and cstart [B,
// min(N, CL)], cols [B, CL] as ListArgs says.  Returns a cudaError_t code.
int pca_chain_lists(int device, const void* idx, int B, int N, int CL, void* counts, void* off, void* wrow,
                    void* cstart, void* cols, void* stream) {
  int shift = 0;
  while ((1 << shift) < CL) ++shift;
  int P = 32;  // whole warps of keys
  while (P < CL) P <<= 1;
  if (B < 1 || B > 65535 || N < 1 || CL < 1 || CL > kMaxListCols || ((long long)N << shift) > INT_MAX ||
      (long long)B * CL >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counts);
  e = cudaMemsetAsync(cnt + B, 0, sizeof(int), s);  // the ticket
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(int) * (P <= kListThreads ? 2 * P : P);
  e = allow_smem(lists_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const ListArgs a = {static_cast<const int*>(idx), B, N, CL, P, shift, min(N, CL), cnt,
                      static_cast<int*>(off), static_cast<int*>(wrow), static_cast<int*>(cstart),
                      static_cast<int*>(cols)};
  lists_kernel<<<B, kListThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// dx [B, N, dims[0]] of the chain for g = dy * mul_L [B, dims[L]], from
// the lists of pca_chain_lists: 0 on every row that wins no column.  x and
// params as pca_chain_fwd.  Returns a cudaError_t code.
int pca_chain_rows(int device, const void* x, int B, int N, int L, const int* dims, const void* const* params,
                   const void* off, const void* wrow, const void* cstart, const void* cols, const void* g,
                   void* dx, void* stream) {
  if (!check_dims(B, N, L, dims)) return (int)cudaErrorInvalidValue;
  const int tm = rows_tm(B, L, dims);
  if (!tm) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(dx, 0, sizeof(float) * (size_t)B * N * dims[0], s);
  if (e != cudaSuccess) return (int)e;
  const RowsArgs a = {static_cast<const float*>(x), B, N, min(N, dims[L]), chain_from(L, dims, params),
                      static_cast<const int*>(off), static_cast<const int*>(wrow),
                      static_cast<const int*>(cstart), static_cast<const int*>(cols),
                      static_cast<const float*>(g), static_cast<float*>(dx)};
  const int bound_rows = B * min(N, dims[L]);
  e = tm == 4 ? launch_rows_q<4>(a, device, bound_rows, s) : launch_rows_q<2>(a, device, bound_rows, s);
  return (int)e;
}

}  // extern "C"
