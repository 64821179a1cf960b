// Neighbour gather + per-point Dense -> eval-BatchNorm -> activation chain
// + a max or a mean over each group's K neighbours, and its input
// gradients, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// pointcloudattack_tpu_torch/ops/gather_chain.py.
//
// Replaces the TPU kernels of pointcloudattack_tpu/ops/pallas/gather_chain_kernel.py:
//   forward  _gather_fwd_pallas (pallas_call at :550, bodies _gather_fwd_kernel
//            and _gather_mean_fwd_kernel)
//   backward _gather_bwd_pallas (pallas_call at :641, body _gather_bwd_kernel)
// reached through gather_chain_groupmax (max pool) and gather_chain_groupmean
// (mean pool); ball_gather_chain_groupmax (the ball query, _make_ball_gather_op)
// runs ball_hoist.cu, which keeps this kernel's ball query.  For src [B, N, Cs], centers
// [B, G, Cc] and idx [B, G, K] it builds each group's K rows from a layout
// of segments, in order:
//   diff   (lo, hi, ctr_lo): src[idx, lo:hi] - centers[g, ctr_lo:ctr_lo+w]
//   pass   (lo, hi):         src[idx, lo:hi]
//   center (lo, hi):         centers[g, lo:hi], the same on every row
// with pre_act, applies the activation to the built rows, and runs the
// chain on them with the activation max(z, slope * z) (ReLU at slope 0,
// LeakyReLU otherwise) between layers.  Max pool: none after the last
// layer; y [B, G, C_L] is the max over K, with am [B, G, C_L] int32, the
// lowest k attaining it.  Mean pool: every layer activated, y the sum of
// the K rows in ascending k, divided by K; no argmax.  The backward takes
// g = dy * mul_L (max) or dy * mul_L / K (mean) and returns dsrc [B, N, Cs]
// (diff and pass columns, scattered by idx) and dctr [B, G, Cc] (center
// columns summed over K, diff columns summed over K with a minus sign);
// with pre_act the row cotangent is first masked by the rows' sign.
//
// What bounds it on this card.  Per call the chain is 2 * B*G*K * sum of
// C_l*C_l+1 flops: 1.2 GFLOP at PointNet++ SSG's first SA (16 x 512 x 32
// rows, 3 -> 64 -> 64 -> 128) and 3.3 GFLOP at its second (16 x 128 x 64
// rows, 131 -> 128 -> 128 -> 256), against at most 4.5 MB of src, idx and
// output.  So it is bound by f32 FMA issue, as chain_maxpool.cu is.  The
// unfused version writes the grouped [B, G, K, C0] rows and every layer's
// [B, G, K, C] map to device memory and reads them back (268 MB for SSG's
// second SA's 256-wide last layer alone); this kernel writes none of them.
// CurveNet's residual LPFAs (one layer C -> C, C = 16 to 128, K = 20) read
// only the sources, the centers and the indices: 2 * K * C * C flops a
// group against about 8 * C + 4 * K bytes, so operations bound them too.
//
// What the design does about it.
//   * The grouped rows never exist in device memory: a block loads the f32
//     source rows directly by index into its shared [C0][T] input tile
//     (the TPU kernel's bf16 three-limb one-hot gather was a trick for its
//     matrix unit).  Odd input widths (3, 131, 323) are the depth of the
//     first layer's product and are masked there, with no padded copy.
//   * The chain is chain_common.cuh's register-tiled f32 layer pass, shared
//     with chain_maxpool.cu and group_chain.cu, with its slope.
//   * A block owns a tile of T = 8 * TM rows: T / K whole groups when
//     K <= T (K a multiple of TM, so each warp's rows lie in one group), or
//     one chunk of T rows of a group when K > T (max pool only).  Chunked
//     groups write a (max, first argmax) partial per chunk; a second small
//     kernel reduces them in chunk order with a strict '>', so ties keep
//     the lowest k, deterministically.  The mean's last layer goes to a
//     padded shared [C_L][T + 1] buffer, and one thread per (group, column)
//     sums the group's rows in ascending k, as group_chain.cu does.
//   * Backward: recompute the rows and the activation masks; the max puts
//     the cotangent on each column's argmax row, the mean recomputes the
//     last layer and puts act'(z_L) * g on every row; either [C_L][T]
//     cotangent runs back through W_L^T as a dense product (a group whose K
//     rows repeat one point has one row that wins every column; a sparse
//     expansion leaves that row's warp all the work: it measured 1.5-8.6x
//     slower than this at PointNet++'s shapes on an H100), then through the
//     layers, then the row cotangent is split by the layout.  dctr is summed
//     per group in row order and written once per group (per chunk, then
//     summed in chunk order by a second kernel): deterministic.  dsrc takes
//     f32 atomicAdd from every row that gathered a point; the order of
//     those adds changes from run to run, so dsrc may vary in its last bits
//     (about 1e-7 relative per duplicated index).  A deterministic scatter
//     is left for a later change.

#include "chain_common.cuh"

namespace {

using namespace pca;

constexpr int kMaxSegs = 4;
enum SegKind { kDiff = 0, kPass = 1, kCenter = 2 };

struct Layout {
  int n;
  int kind[kMaxSegs];
  int lo[kMaxSegs];
  int hi[kMaxSegs];
  int ctr[kMaxSegs];  // diff: first center column
};

// How the tiles of T rows cover the groups of K rows.
struct Groups {
  int N, G, K, Cs, Cc;
  int seg;     // rows of one group in a tile: min(K, T)
  int gpb;     // groups per tile: T / K when K <= T, else 1
  int chunks;  // tiles per group: ceil(K / T) when K > T, else 1
};

Groups make_groups(int N, int G, int K, int Cs, int Cc, int tm) {
  const int T = 8 * tm;
  Groups q = {N, G, K, Cs, Cc, 0, 1, 1};
  if (K <= T) {
    q.seg = K;
    q.gpb = T / K;
  } else {
    q.seg = T;
    q.chunks = (K + T - 1) / T;
  }
  return q;
}

// Row r of block bx's tile: its group g and neighbour k; false for a row
// past the last group, past K, or past the tile's whole groups.
__device__ __forceinline__ bool tile_row(const Groups& q, int bx, int r, int& g, int& k) {
  const int lg = r / q.seg;
  g = (bx / q.chunks) * q.gpb + lg;
  k = (bx % q.chunks) * q.seg + r % q.seg;
  return lg < q.gpb && g < q.G && k < q.K;
}

// The segment holding input column col: its index and the column within it.
__device__ __forceinline__ int find_seg(const Layout& lay, int col, int& j) {
  int s = 0, off = 0;
  while (s < lay.n - 1 && col >= off + (lay.hi[s] - lay.lo[s])) {
    off += lay.hi[s] - lay.lo[s];
    ++s;
  }
  j = col - off;
  return s;
}

// The group rows of block bx, cloud b, into the shared [C0][T] tile xT;
// pidx(g, k) is the point row k of group g gathers.  With pre_act the
// rows go through the activation.
template <int TM, class Pidx>
__device__ __forceinline__ void build_rows(const float* __restrict__ src,
                                           const float* __restrict__ ctr, const Groups& q,
                                           const Layout& lay, int C0, int b, int bx, int pre_act,
                                           float slope, Pidx pidx, float* xT) {
  fill_tile<TM>(C0, [&](int r, int col) {
    int g, k, j;
    if (!tile_row(q, bx, r, g, k)) return 0.f;
    const int s = find_seg(lay, col, j);
    const float* crow = ctr + ((size_t)b * q.G + g) * q.Cc;
    float v;
    if (lay.kind[s] == kCenter) {
      v = crow[lay.lo[s] + j];
    } else {
      v = src[((size_t)b * q.N + pidx(g, k)) * q.Cs + lay.lo[s] + j];
      if (lay.kind[s] == kDiff) v = __fsub_rn(v, crow[lay.ctr[s] + j]);
    }
    return pre_act ? act_fwd(v, slope) : v;
  }, xT);
}

// The forward.  kMean: the mean pool, y written directly (K <= T); else the
// max pool into part_v / part_i (y and am when a group is one chunk).
template <int TM, bool kMean>
__global__ void __launch_bounds__(kThreads, 2)
    gather_fwd_kernel(const float* __restrict__ src, const float* __restrict__ ctr,
                      const int* __restrict__ idx, Groups q, Layout lay, Chain ch, int pre_act,
                      float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int T = 8 * TM, TP = T + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bx = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = ch.L, C0 = ch.dims[0], C = ch.dims[L];
  const int g0 = (bx / q.chunks) * q.gpb, chunk = bx % q.chunks;
  const int ng = min(q.gpb, q.G - g0);

  int maxw = C0;
  for (int l = 1; l < L; ++l) maxw = max(maxw, ch.dims[l]);
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + (size_t)maxw * T;
  float* wtile = nxt + (size_t)maxw * T;
  float* red_v = wtile + kKTile * kChunk;  // mean: the [C][TP] last layer
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * kChunk);

  build_rows<TM>(src, ctr, q, lay, C0, b, bx, pre_act, ch.slope,
                 [&](int g, int k) { return idx[((size_t)b * q.G + g) * q.K + k]; }, cur);

  if constexpr (kMean) {
    float* zs = red_v;
    for (int l = 0; l < L - 1; ++l) {
      hidden_layer<TM>(ch, l, cur, nxt, wtile);
      float* t = cur; cur = nxt; nxt = t;
    }
    const int l = L - 1;
    layer_pass<TM>(cur, ch.dims[l], ch.w[l], C, wtile, [&](int c0, auto& acc) {
      constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + chunk_col<TN>(lane, j);
        if (c >= C) continue;
        const float bb = ch.b[l][c], mm = ch.mean[l][c], mu = ch.mul[l][c], be = ch.beta[l][c];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          zs[c * TP + warp * TM + i] = act_fwd((acc[i][j] + bb - mm) * mu + be, ch.slope);
      }
    });
    __syncthreads();
    // one thread per (group, column), the group's rows in ascending k
    for (int e = threadIdx.x; e < ng * C; e += kThreads) {
      const int s = e / C, c = e % C;
      const float* col = zs + c * TP + s * q.K;
      float sum = col[0];
      for (int k = 1; k < q.K; ++k) sum += col[k];
      part_v[((size_t)b * q.G + g0 + s) * C + c] = sum / (float)q.K;
    }
  } else {
    chain_fwd_max<TM>(
        ch, cur, nxt, wtile, red_v, red_i, q.seg,
        [&](int r) {
          int g, k;
          return tile_row(q, bx, r, g, k) ? k : -1;
        },
        [&](int s, int c, float v, int a) {
          const int g = g0 + s;
          if (s >= q.gpb || g >= q.G) return;
          const size_t o = (((size_t)b * q.G + g) * q.chunks + chunk) * C + c;
          part_v[o] = v;
          part_i[o] = a;
        });
  }
}

template <int TM, bool kMean>
__global__ void __launch_bounds__(kThreads)
    gather_bwd_kernel(const float* __restrict__ src, const float* __restrict__ ctr,
                      const int* __restrict__ idx, Groups q, Layout lay, Chain ch, int pre_act,
                      const int* __restrict__ am, const float* __restrict__ g,
                      float* __restrict__ dsrc, float* __restrict__ dctr_part) {
  constexpr int T = 8 * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bx = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = ch.L, C0 = ch.dims[0], CL = ch.dims[L];
  const int g0 = (bx / q.chunks) * q.gpb, chunk = bx % q.chunks;

  // act[0] = rows, act[l] = h_l (the activated output of layer l-1), l < L
  float* act[kMaxLayers];
  float* p = reinterpret_cast<float*>(smem);
  int maxg = 1;
  for (int l = 0; l < L; ++l) {
    act[l] = p;
    p += (size_t)ch.dims[l] * T;
    if (l > 0) maxg = max(maxg, ch.dims[l]);
  }
  float* gin = p;
  float* gout = gin + (size_t)maxg * T;  // also the [CL][T] cotangent
  float* wtile = gout + (size_t)max(maxg, CL) * T;
  int* am_s = reinterpret_cast<int*>(wtile + kKTile * kChunk);
  float* g_s = reinterpret_cast<float*>(am_s) + align16(q.gpb * CL * sizeof(int)) / sizeof(float);

  build_rows<TM>(src, ctr, q, lay, C0, b, bx, pre_act, ch.slope,
                 [&](int gg, int k) { return idx[((size_t)b * q.G + gg) * q.K + k]; }, act[0]);
  for (int e = threadIdx.x; e < q.gpb * CL; e += kThreads) {
    const int gg = g0 + e / CL;
    const size_t o = ((size_t)b * q.G + gg) * CL + e % CL;
    if (!kMean) am_s[e] = gg < q.G ? am[o] : -1;
    g_s[e] = gg < q.G ? g[o] : 0.f;
  }
  // the row cotangent replaces the rows, column by column; with pre_act
  // through the rows' activation (the activated row has the raw row's sign)
  float* drow = act[0];
  auto store = [&](int r, int k, float v) {
    float* d = drow + k * T + r;
    *d = pre_act ? act_bwd_mul(*d, v, 1.f, ch.slope) : v;
  };
  if constexpr (kMean) {
    for (int l = 0; l < L - 1; ++l) hidden_layer<TM>(ch, l, act[l], act[l + 1], wtile);
    __syncthreads();
    // recompute the last layer: every row's cotangent is act'(z_L) * g
    const int l = L - 1;
    layer_pass<TM>(act[l], ch.dims[l], ch.w[l], CL, wtile, [&](int c0, auto& acc) {
      constexpr int TN = sizeof(acc[0]) / sizeof(float);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = c0 + chunk_col<TN>(lane, j);
        if (c >= CL) continue;
        const float bb = ch.b[l][c], mm = ch.mean[l][c], mu = ch.mul[l][c], be = ch.beta[l][c];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = warp * TM + i;
          int gg, k;
          const float z = (acc[i][j] + bb - mm) * mu + be;
          gout[c * T + r] = tile_row(q, bx, r, gg, k)
                                ? act_bwd_mul(z, g_s[(r / q.seg) * CL + c], 1.f, ch.slope)
                                : 0.f;
        }
      }
    });
    chain_bwd_dense<TM>(ch, act, gin, gout, wtile, store);
  } else {
    chain_bwd_tile<TM, true>(
        ch, act, gin, gout, wtile,
        [&](int r) {
          int gg, k;
          if (!tile_row(q, bx, r, gg, k)) return HitRow{nullptr, nullptr, 0};
          const int lg = r / q.seg;
          return HitRow{am_s + lg * CL, g_s + lg * CL, k};
        },
        store);
  }
  __syncthreads();

  // diff and pass columns scatter into dsrc
  for_tile<TM>(C0, [&](int r, int col) {
    int gg, k, j;
    if (!tile_row(q, bx, r, gg, k)) return;
    const int s = find_seg(lay, col, j);
    if (lay.kind[s] == kCenter) return;
    const int pt = idx[((size_t)b * q.G + gg) * q.K + k];
    atomicAdd(dsrc + ((size_t)b * q.N + pt) * q.Cs + lay.lo[s] + j, drow[col * T + r]);
  });

  // center and diff columns reduce over the group's rows into dctr,
  // segments in order, rows in order
  const int nrows = min(q.seg, q.K - chunk * q.seg);
  for (int e = threadIdx.x; e < q.gpb * q.Cc; e += kThreads) {
    const int lg = e / q.Cc, cc = e % q.Cc, gg = g0 + lg;
    if (gg >= q.G) continue;
    float acc = 0.f;
    int off = 0;
    for (int s = 0; s < lay.n; ++s) {
      const int w = lay.hi[s] - lay.lo[s];
      const int base = lay.kind[s] == kDiff ? lay.ctr[s] : lay.lo[s];
      if (lay.kind[s] != kPass && cc >= base && cc < base + w) {
        const float* col = drow + (size_t)(off + cc - base) * T + lg * q.seg;
        float t = 0.f;
        for (int r = 0; r < nrows; ++r) t += col[r];
        acc = lay.kind[s] == kDiff ? acc - t : acc + t;
      }
      off += w;
    }
    dctr_part[(((size_t)b * q.G + gg) * q.chunks + chunk) * q.Cc + cc] = acc;
  }
}

// partials [R, chunks, C] -> out [R, C], summed in chunk order.
__global__ void sum_chunks_kernel(const float* __restrict__ part, int chunks, int C,
                                  int total, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const float* p = part + (size_t)(e / C) * chunks * C + e % C;
  float acc = p[0];
  for (int t = 1; t < chunks; ++t) acc += p[(size_t)t * C];
  out[e] = acc;
}

// Dynamic shared memory of one block.  Forward: chain_common.cuh's forward
// buffers, the mean's [C_L][T + 1] last layer in place of the max's
// partials.  Backward: the dense backward's buffers.
size_t gather_smem(int L, const int* dims, int K, int tm, int bwd, int mean) {
  const int T = 8 * tm;
  const int gpb = K <= T ? T / K : 1;
  if (bwd) return chain_smem_bytes(L, dims, tm, 1, gpb, true);
  int maxw = dims[0];
  for (int l = 1; l < L; ++l) maxw = dims[l] > maxw ? dims[l] : maxw;
  size_t s = 2 * align16(sizeof(float) * maxw * T) + align16(sizeof(float) * kKTile * kChunk);
  s += mean ? align16(sizeof(float) * dims[L] * (T + 1)) : 2 * align16(sizeof(float) * kWarps * kChunk);
  return s;
}

int check_gather(int B, int N, int G, int K, int Cs, int Cc, int nseg, const int* seg, int L,
                 const int* dims, float slope, int mean, int tm, int bwd, Layout* lay) {
  if (B < 1 || B > 65535 || N < 1 || G < 1 || K < 1 || Cs < 1 || Cc < 1) return 1;
  if (L < 1 || L > kMaxLayers || nseg < 1 || nseg > kMaxSegs) return 1;
  if (!(slope >= 0.f && slope <= 1.f)) return 1;
  if (tm != 8 && tm != 4 && tm != 2) return 1;
  if (K <= 8 * tm && K % tm) return 1;  // a warp's rows must lie in one group
  if (mean && K > 8 * tm) return 1;     // the mean takes whole groups
  for (int l = 0; l <= L; ++l)
    if (dims[l] < 1) return 1;
  if (bwd && dims[L - 1] > kMaxRowWidth) return 1;
  int c0 = 0;
  lay->n = nseg;
  for (int s = 0; s < nseg; ++s) {
    const int kind = seg[4 * s], lo = seg[4 * s + 1], hi = seg[4 * s + 2], cl = seg[4 * s + 3];
    if (kind < kDiff || kind > kCenter || lo < 0 || hi <= lo) return 1;
    if (kind == kCenter ? hi > Cc : hi > Cs) return 1;
    if (kind == kDiff && (cl < 0 || cl + hi - lo > Cc)) return 1;
    lay->kind[s] = kind; lay->lo[s] = lo; lay->hi[s] = hi; lay->ctr[s] = cl;
    c0 += hi - lo;
  }
  if (c0 != dims[0]) return 1;
  if (gather_smem(L, dims, K, tm, bwd, mean) > kMaxSmem) return 1;
  return 0;
}

template <int TM, bool kMean>
cudaError_t launch_gather_fwd(const float* src, const float* ctr, const int* idx, int B,
                              const Groups& q, const Layout& lay, const Chain& ch, int pre_act,
                              float* pv, int* pi, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(gather_fwd_kernel<TM, kMean>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(q.chunks * ((q.G + q.gpb - 1) / q.gpb), B);
  gather_fwd_kernel<TM, kMean><<<grid, kThreads, smem, s>>>(src, ctr, idx, q, lay, ch, pre_act, pv, pi);
  return cudaGetLastError();
}

template <bool kMean>
cudaError_t dispatch_fwd(int tm, const float* src, const float* ctr, const int* idx, int B,
                         const Groups& q, const Layout& lay, const Chain& ch, int pre_act,
                         float* pv, int* pi, size_t smem, cudaStream_t s) {
  switch (tm) {
    case 8: return launch_gather_fwd<8, kMean>(src, ctr, idx, B, q, lay, ch, pre_act, pv, pi, smem, s);
    case 4: return launch_gather_fwd<4, kMean>(src, ctr, idx, B, q, lay, ch, pre_act, pv, pi, smem, s);
    default: return launch_gather_fwd<2, kMean>(src, ctr, idx, B, q, lay, ch, pre_act, pv, pi, smem, s);
  }
}

template <int TM, bool kMean>
cudaError_t launch_gather_bwd(const float* src, const float* ctr, const int* idx, int B,
                              const Groups& q, const Layout& lay, const Chain& ch, int pre_act,
                              const int* am, const float* g, float* dsrc, float* dctr_part,
                              size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(gather_bwd_kernel<TM, kMean>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(q.chunks * ((q.G + q.gpb - 1) / q.gpb), B);
  gather_bwd_kernel<TM, kMean><<<grid, kThreads, smem, s>>>(src, ctr, idx, q, lay, ch, pre_act, am, g,
                                                            dsrc, dctr_part);
  return cudaGetLastError();
}

template <bool kMean>
cudaError_t dispatch_bwd(int tm, const float* src, const float* ctr, const int* idx, int B,
                         const Groups& q, const Layout& lay, const Chain& ch, int pre_act,
                         const int* am, const float* g, float* dsrc, float* dctr_part, size_t smem,
                         cudaStream_t s) {
  switch (tm) {
    case 8: return launch_gather_bwd<8, kMean>(src, ctr, idx, B, q, lay, ch, pre_act, am, g, dsrc, dctr_part, smem, s);
    case 4: return launch_gather_bwd<4, kMean>(src, ctr, idx, B, q, lay, ch, pre_act, am, g, dsrc, dctr_part, smem, s);
    default: return launch_gather_bwd<2, kMean>(src, ctr, idx, B, q, lay, ch, pre_act, am, g, dsrc, dctr_part, smem, s);
  }
}

// The max forward's epilogue when a group spans several chunks: the
// partials reduced in chunk order into y and am.
cudaError_t reduce_chunks(const Groups& q, int B, int C, float* pv, int* pi, void* y, void* am,
                          cudaStream_t s) {
  if (q.chunks == 1) return cudaSuccess;
  const int total = B * q.G * C;
  argmax_reduce_kernel<float><<<(total + 255) / 256, 256, 0, s>>>(
      pv, pi, q.chunks, C, total, static_cast<float*>(y), static_cast<int*>(am));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at TM = tm (mean: the mean pool);
// the caller picks the largest tm that fits pca_chain_max_smem() (and
// divides K when K <= 8*tm; 8*tm >= K for the mean).
size_t pca_gather_smem(int L, const int* dims, int K, int tm, int bwd, int mean) {
  return gather_smem(L, dims, K, tm, bwd, mean);
}

// device: the CUDA device index of every pointer and the stream.
// src [B, N, Cs] f32, ctr [B, G, Cc] f32, idx [B, G, K] int32 in [0, N);
// seg: nseg segments of 4 ints (kind 0 diff / 1 pass / 2 center, lo, hi,
// ctr_lo); dims [L+1] with dims[0] the layout's width; params as in
// pca_chain_fwd; slope in [0, 1]; pre_act: activate the built rows; mean:
// 0 max pool, 1 mean pool (K <= 8*tm).  Max: with chunks = ceil(K / (8*tm))
// > 1 (K > 8*tm), part_v / part_i are scratch [B, G, chunks, C_L];
// otherwise they are unused; y / am [B, G, C_L].  Mean: y [B, G, C_L]; am,
// part_v and part_i unused.  Returns a cudaError_t code (0 on success).
int pca_gather_fwd(int device, const void* src, const void* ctr, const void* idx, int B, int N,
                   int G, int K, int Cs, int Cc, int nseg, const int* seg, int L,
                   const int* dims, const void* const* params, float slope, int pre_act, int mean,
                   void* part_v, void* part_i, void* y, void* am, int tm, void* stream) {
  Layout lay;
  if (check_gather(B, N, G, K, Cs, Cc, nseg, seg, L, dims, slope, mean, tm, 0, &lay))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Groups q = make_groups(N, G, K, Cs, Cc, tm);
  Chain ch = make_chain(L, dims, params, nullptr);
  ch.slope = slope;
  const size_t smem = gather_smem(L, dims, K, tm, 0, mean);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(src);
  const float* cf = static_cast<const float*>(ctr);
  const int* ii = static_cast<const int*>(idx);
  if (mean)
    return (int)dispatch_fwd<true>(tm, sf, cf, ii, B, q, lay, ch, pre_act, static_cast<float*>(y), nullptr,
                                   smem, s);
  // one chunk per group: the tiles write y and am directly
  float* pv = static_cast<float*>(q.chunks > 1 ? part_v : y);
  int* pi = static_cast<int*>(q.chunks > 1 ? part_i : am);
  e = dispatch_fwd<false>(tm, sf, cf, ii, B, q, lay, ch, pre_act, pv, pi, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_chunks(q, B, dims[L], pv, pi, y, am, s);
}

// src, ctr, idx, seg, dims, params, slope, pre_act, mean as in
// pca_gather_fwd; wts: per layer W_l transposed, [dims[l+1], dims[l]]
// row-major; g [B, G, C_L]: dy * mul_L (max) or dy * mul_L / K (mean); am
// int32 [B, G, C_L] (max; unused for the mean).  dsrc [B, N, Cs] must hold
// zeros (the kernel adds into it).  With chunks > 1, dctr_part is scratch
// [B, G, chunks, Cc]; otherwise it is unused.  dctr [B, G, Cc].  Returns a
// cudaError_t code.
int pca_gather_bwd(int device, const void* src, const void* ctr, const void* idx, int B, int N,
                   int G, int K, int Cs, int Cc, int nseg, const int* seg, int L,
                   const int* dims, const void* const* params, const void* const* wts, float slope,
                   int pre_act, int mean, const void* am, const void* g, void* dsrc, void* dctr_part,
                   void* dctr, int tm, void* stream) {
  Layout lay;
  if (check_gather(B, N, G, K, Cs, Cc, nseg, seg, L, dims, slope, mean, tm, 1, &lay))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Groups q = make_groups(N, G, K, Cs, Cc, tm);
  Chain ch = make_chain(L, dims, params, wts);
  ch.slope = slope;
  const size_t smem = gather_smem(L, dims, K, tm, 1, mean);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(src);
  const float* cf = static_cast<const float*>(ctr);
  const int* ii = static_cast<const int*>(idx);
  const int* ai = static_cast<const int*>(am);
  const float* gf = static_cast<const float*>(g);
  float* ds = static_cast<float*>(dsrc);
  float* dp = static_cast<float*>(q.chunks > 1 ? dctr_part : dctr);
  e = mean ? dispatch_bwd<true>(tm, sf, cf, ii, B, q, lay, ch, pre_act, ai, gf, ds, dp, smem, s)
           : dispatch_bwd<false>(tm, sf, cf, ii, B, q, lay, ch, pre_act, ai, gf, ds, dp, smem, s);
  if (e != cudaSuccess || q.chunks == 1) return (int)e;
  const int total = B * G * Cc;
  sum_chunks_kernel<<<(total + 255) / 256, 256, 0, s>>>(dp, q.chunks, Cc, total,
                                                         static_cast<float*>(dctr));
  return (int)cudaGetLastError();
}

}  // extern "C"
