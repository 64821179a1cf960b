// The kernel the hoisted-first-layer routes (gather_hoist.cu's one-layer
// gather max and ball_hoist.cu's ball set abstraction) and the curvature
// backward (kappa.cu) share, for Hopper (sm_90a):
//   lists    a stable counting sort of each cloud's entries by the point they
//            name: G blocks a cloud (1 for the hoisted routes), 1024 threads,
//            block g taking the g-th contiguous part of the entries; each of
//            up to 32 warps takes a contiguous part of the block's, counts
//            them by point in shared memory (a count per part and point),
//            then places them in order, __match_any_sync ranking the lanes
//            that share a point.  With G > 1 each block also counts all of
//            its cloud's entries by point, and those before its own part,
//            for the points' starts and its own offsets.
//            Which entries a cloud has, the point each names, what is stored
//            for it and where the cloud's list starts come from a Src
//            (count, key, payload, base), so every caller runs one kernel.
// Each source that includes this header gets its own instance, launched
// through its own C entry points.  Both routes' products (P and Q, dsrc and
// dctr) run gather_hoist.cu's product kernel, through pca_hoist_product.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"

namespace pca {
namespace hoist {
namespace {

constexpr int kListThreads = 1024;            // the lists' block: 32 warps, up to 32 parts
constexpr int kListWarps = kListThreads / 32;

// The number of parts (warps) whose per-point counts fit one block's shared
// memory beside `arrays` more arrays of N (the offsets; with G > 1 also the
// earlier blocks' counts): at most kListWarps, 0 when not even one does.
int lists_parts(int N, int arrays = 1) {
  const size_t ints = kMaxSmem / sizeof(int);
  if ((size_t)arrays * N + 1 >= ints) return 0;
  const size_t parts = (ints - (size_t)arrays * N - 1) / (size_t)N;
  return parts < (size_t)kListWarps ? (int)parts : kListWarps;
}

size_t lists_smem(int N, int parts, int arrays = 1) { return sizeof(int) * ((size_t)(parts + arrays) * N); }

// Cloud b's entries e in [0, src.count(b)) each name a point src.key(b, e)
// (outside [0, N): not listed); point j's entries, in ascending e, go to
// list[src.base(b) + start[b, j] ...], each stored as src.payload(b, e);
// start [B, N + 1], start[b, N] the entries listed.  Block (b, g) of G
// places the g-th part of the entries.
template <class Src>
__global__ void __launch_bounds__(kListThreads) lists_kernel(Src src, int N, int parts, int* __restrict__ start,
                                                             int* __restrict__ list) {
  extern __shared__ int sm[];
  int* hist = sm;                          // [parts][N]: counts, then each part's cursor
  int* off = sm + (size_t)parts * N;       // [N]: counts, then each point's first slot
  int* pre = off + N;                      // [N], G > 1: the counts of the entries before this block's
  __shared__ int wsum[kListWarps];
  const int b = blockIdx.x, g = blockIdx.y, G = gridDim.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = src.count(b), share = (E + G - 1) / G;
  const int lo0 = min(E, g * share), hi0 = min(E, lo0 + share);  // this block's entries
  int* st = start + (size_t)b * (N + 1);
  int* ls = list + src.base(b);
  const int L = (hi0 - lo0 + parts - 1) / parts;  // entries a part

  for (int e = tid; e < parts * N; e += kListThreads) hist[e] = 0;
  if (G > 1) {  // the cloud's count of each point, and of the entries before this block's
    for (int j = tid; j < N; j += kListThreads) off[j] = pre[j] = 0;
    __syncthreads();
    for (int e = tid; e < E; e += kListThreads) {
      const int j = src.key(b, e);
      if ((unsigned)j >= (unsigned)N) continue;
      atomicAdd(&off[j], 1);
      if (e < lo0) atomicAdd(&pre[j], 1);
    }
  }
  __syncthreads();
  if (warp < parts) {  // count each part's entries by point
    const int lo = lo0 + warp * L, hi = min(hi0, lo + L);
#pragma unroll 4
    for (int e = lo + lane; e < hi; e += 32) {
      const int j = src.key(b, e);
      if ((unsigned)j < (unsigned)N) atomicAdd(&hist[warp * N + j], 1);
    }
  }
  __syncthreads();
  for (int j = tid; j < N; j += kListThreads) {  // each part's offset within the point's list
    int run = 0;
    for (int p = 0; p < parts; ++p) {
      const int c = hist[p * N + j];
      hist[p * N + j] = run;
      run += c;
    }
    if (G == 1) off[j] = run;
  }
  __syncthreads();
  // exclusive scan of the counts: a contiguous run of points a thread
  const int per = (N + kListThreads - 1) / kListThreads;
  const int lo = min(N, tid * per), hi = min(N, lo + per);
  int s = 0;
  for (int j = lo; j < hi; ++j) s += off[j];
  int incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int run = incl - s;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int j = lo; j < hi; ++j) {
    const int c = off[j];
    off[j] = G > 1 ? run + pre[j] : run;
    if (g == 0) st[j] = run;
    run += c;
  }
  if (g == 0 && tid == kListThreads - 1) st[N] = run;  // the entries listed
  __syncthreads();
  for (int e = tid; e < parts * N; e += kListThreads) hist[e] += off[e % N];
  __syncthreads();
  if (warp < parts) {  // place each part's entries in order
    int* cur = hist + warp * N;
    const int lo2 = lo0 + warp * L, hi2 = min(hi0, lo2 + L);
    int next = lo2 + lane < hi2 ? src.key(b, lo2 + lane) : -1;  // the next step's point, loaded a step ahead
    for (int e0 = lo2; e0 < hi2; e0 += 32) {
      const int e = e0 + lane;
      int j = next;
      next = e + 32 < hi2 ? src.key(b, e + 32) : -1;
      const bool ok = (unsigned)j < (unsigned)N;
      if (!ok) j = -1 - lane;  // a lane with no point groups with no other
      const unsigned peers = __match_any_sync(0xffffffffu, j);
      if (ok) ls[cur[j] + __popc(peers & ((1u << lane) - 1u))] = src.payload(b, e);
      __syncwarp();  // every lane has read its cursor
      if (ok && lane == __ffs(peers) - 1) cur[j] += __popc(peers);
      __syncwarp();
    }
  }
}

// lists_kernel<Src> over B clouds at `parts` (from lists_parts(N), or with
// G > 1 lists_parts(N, 2)), G blocks a cloud; returns a cudaError_t.
template <class Src>
cudaError_t launch_lists(const Src& src, int B, int N, int parts, int* start, int* list, cudaStream_t s,
                         int G = 1) {
  const size_t smem = lists_smem(N, parts, G > 1 ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(lists_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  lists_kernel<Src><<<dim3(B, G), kListThreads, smem, s>>>(src, N, parts, start, list);
  return cudaGetLastError();
}

}  // namespace
}  // namespace hoist
}  // namespace pca
