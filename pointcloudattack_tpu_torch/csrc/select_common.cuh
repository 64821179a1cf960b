// Exact top-k selection of one row of distances by one warp, for Hopper
// (sm_90a): the selection of csrc/knn.cu's self-kNN and of kappa.cu's
// curvature forward.
//
// The row lies in shared memory.  The k smallest (distance, index) pairs
// are found in lexicographic order, so ties go to the lower index whatever
// order the lanes work in, and the picks and their order are those of a
// stable ascending sort.
//
//   1. A bound.  While the row was written, it was split into 64 shares
//      (any split) and the smallest value of each share kept: 64 values of
//      64 distinct entries (+inf for an empty share).  Their k-th smallest
//      (k <= 64) has at least k entries at or below it; on the path's
//      clouds at k = 17-21, a few more than k.
//   2. A gather.  One pass over the row with float4 loads: the entries at
//      or below the bound go, placed by ballots, to the warp's buffer of
//      kCap pairs.
//   3. A sort.  The gathered pairs, 32, 64 or 128 of them padded with
//      (+inf, INT_MAX), are sorted in registers by a bitonic network across
//      the warp (element p at lane p % 32, slot p / 32); the first k are
//      the answer.
// Past k = 64, or where more than kCap entries lie at or below the bound
// (a row of many exact duplicates), the warp falls back to k passes over the
// row, pass t taking the smallest pair after pass t-1's.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace pca {
namespace sel {

constexpr int kCap = 128;        // pairs a warp's buffer holds
constexpr int kShares = 64;      // shares of a row whose minima bound it
constexpr int kMaxSortK = kShares;  // the largest k the bound serves
constexpr unsigned kFull = 0xffffffffu;

// (v, i) comes before (bv, bi) in (distance, index) order.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// (v, i) comes after (pv, pi).
__device__ __forceinline__ bool after(float v, int i, float pv, int pi) {
  return v > pv || (v == pv && i > pi);
}

// Sorts the warp's 32 * E pairs (element p = e * 32 + lane in v[e], j[e])
// ascending in (value, index), by a bitonic network: exchanges within a
// lane where the partner is E-slots away, shuffles across lanes otherwise.
// Every lane of the warp must call it.
template <int E>
__device__ __forceinline__ void warp_sort(float (&v)[E], int (&j)[E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int es = stride >> 5;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & es) continue;
          const bool up = ((e * 32 + lane) & size) == 0;
          const int f = e | es;
          const bool swap = up ? before(v[f], j[f], v[e], j[e]) : before(v[e], j[e], v[f], j[f]);
          if (swap) {
            const float tv = v[e];
            const int tj = j[e];
            v[e] = v[f];
            j[e] = j[f];
            v[f] = tv;
            j[f] = tj;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ov = __shfl_xor_sync(kFull, v[e], stride);
          const int oj = __shfl_xor_sync(kFull, j[e], stride);
          const bool up = ((e * 32 + lane) & size) == 0, lower = (lane & stride) == 0;
          // the lower lane keeps the first of the two where the run ascends
          if (lower == up ? before(ov, oj, v[e], j[e]) : before(v[e], j[e], ov, oj)) {
            v[e] = ov;
            j[e] = oj;
          }
        }
      }
    }
  }
}

// warp_sort on values alone: only the order of the values is needed.
template <int E>
__device__ __forceinline__ void warp_sort_values(float (&v)[E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int es = stride >> 5;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & es) continue;
          const bool up = ((e * 32 + lane) & size) == 0;
          const int f = e | es;
          const float lo = fminf(v[e], v[f]), hi = fmaxf(v[e], v[f]);
          v[e] = up ? lo : hi;
          v[f] = up ? hi : lo;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float o = __shfl_xor_sync(kFull, v[e], stride);
          const bool up = ((e * 32 + lane) & size) == 0, lower = (lane & stride) == 0;
          v[e] = lower == up ? fminf(v[e], o) : fmaxf(v[e], o);
        }
      }
    }
  }
}

// The bound of step 1: the k-th smallest of the 64 share minima in
// shares[0, 64) (k <= 64).
__device__ __forceinline__ float sample_bound(const float* shares, int k) {
  const int lane = threadIdx.x & 31;
  float v[2] = {shares[lane], shares[lane + 32]};
  warp_sort_values<2>(v);
  return __shfl_sync(kFull, k > 32 ? v[1] : v[0], (k - 1) & 31);
}

// Step 2: the entries of row[0, N) at or below tau into (bv, bi), in any
// order; row holds N4 = N rounded up to 4 floats, 16-byte aligned.  Returns
// their count, or -1 past kCap.
__device__ __forceinline__ int gather(const float* row, int N, int N4, float tau, float* bv, int* bi) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int j0 = 0; j0 < N4; j0 += 128) {
    const int j = j0 + 4 * lane;
    float4 d = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    if (j < N4) d = *reinterpret_cast<const float4*>(row + j);
    // the pads past N are +inf: they pass only a bound of +inf, hence j < N
    const float dv[4] = {d.x, d.y, d.z, d.w};
    bool pv[4];
    unsigned m[4];
    int total = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      pv[u] = j + u < N && dv[u] <= tau;
      m[u] = __ballot_sync(kFull, pv[u]);
      total += __popc(m[u]);
    }
    if (total == 0) continue;
    if (base + total > kCap) return -1;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // slot u of every lane, then slot u + 1: any order serves the sort
      if (pv[u]) {
        const int at = base + __popc(m[u] & below);
        bv[at] = dv[u];
        bi[at] = j + u;
      }
      base += __popc(m[u]);
    }
  }
  __syncwarp();
  return base;
}

// Step 3: sorts the c gathered pairs and writes the first k indices.
template <int E>
__device__ __forceinline__ void sort_write(const float* bv, const int* bi, int c, int k, int* out) {
  const int lane = threadIdx.x & 31;
  float v[E];
  int j[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e * 32 + lane;
    v[e] = p < c ? bv[p] : INFINITY;
    j[e] = p < c ? bi[p] : INT_MAX;
  }
  warp_sort<E>(v, j);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e * 32 + lane < k) out[e * 32 + lane] = j[e];
}

// The fallback: k warp-wide passes over row[0, N), pass t taking the
// smallest pair after pass t-1's.
__device__ __forceinline__ void k_passes(const float* row, int N, int k, int* out) {
  const int lane = threadIdx.x & 31;
  float pv = -INFINITY;
  int pi = -1;
  for (int t = 0; t < k; ++t) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int jj = lane; jj < N; jj += 32) {
      const float v = row[jj];
      if (after(v, jj, pv, pi) && before(v, jj, bv, bi)) {
        bv = v;
        bi = jj;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) out[t] = bi;
    pv = bv;
    pi = bi;
  }
}

// The k smallest pairs of row[0, N) (N4 floats, the pads +inf) into
// out[0, k), given the row's 64 share minima; (bv, bi) the warp's buffer of
// kCap pairs.  Every lane of the warp calls it; the row and its minima must
// be visible to the whole warp.
__device__ __forceinline__ void select_row(const float* row, int N, int N4, int k, const float* shares, float* bv,
                                           int* bi, int* out) {
  const int c = k <= kMaxSortK ? gather(row, N, N4, sample_bound(shares, k), bv, bi) : -1;
  if (c < 0)
    k_passes(row, N, k, out);
  else if (c <= 32)
    sort_write<1>(bv, bi, c, k, out);
  else if (c <= 64)
    sort_write<2>(bv, bi, c, k, out);
  else
    sort_write<4>(bv, bi, c, k, out);
  __syncwarp();  // the buffer is free for the next row
}

}  // namespace sel
}  // namespace pca
