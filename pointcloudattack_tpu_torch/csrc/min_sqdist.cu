// Per-row nearest-neighbour squared distance (the Chamfer row min) for
// Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// pointcloudattack_tpu_torch/ops/chamfer.py.
//
// Replaces the TPU kernel pointcloudattack_tpu/ops/pallas/chamfer_kernel.py::
// _min_rows_pallas_2d (pallas_call at :103, body _kernel), reached from
// min_sqdist_rows (:356) by the single-direction Chamfer and Hausdorff
// distances (the KNN attack's per-iteration distance term).  For x [B, N, 3]
// and y [B, M, 3] it writes mins [B, N], min_j |x_i - y_j|^2, and
// argmin [B, N] int32, the first j attaining it.
//
// Numerics.  The distance is the TPU kernel's per-coordinate form
// ((dx*dx + dy*dy) + dz*dz) with every product and sum rounded on its own
// (sqdist_common.cuh's sqdist3), in the order of the plain PyTorch version,
// so the mins agree bit for bit.  fminf returns one of its inputs, so each
// minimum below is one of the row's distances, bits and all, and the argmin
// is the first j whose distance equals it: the plain version's.
//
// What bounds it on this card.  At the KNN attack's shape (B=64,
// N=M=1024) it is 67.1 M pairs at 8 operations a pair (3 subtractions,
// 3 products, 2 sums): 0.54 G operations against about 2 MB of input and
// output, a bound near 0.008 ms by operations.  Uncontracted, every
// operation issues as one instruction, so the least time is twice that,
// 0.016 ms; a running minimum adds at least one more instruction a pair.
//
// What the design does about it.  The selection is off the pair's chain: a
// lane folds a chunk of kChunk distances of each of its rows into the
// row's running minimum with fminf (9 instructions a pair), and only once a
// chunk does it compare the result with the minimum held before the chunk,
// keeping the start of the last chunk that lowered it.  That chunk holds
// the split's first j attaining its minimum (a later chunk that only ties
// lowers nothing).  A lane holds R rows (one broadcast shared load of a y
// point feeds R pairs), and the S warps of a row group split each staged
// tile of y by chunks (split s takes chunks s, s + S, ...).  The splits'
// (minimum, index) pairs merge in lexicographic order, smaller distance
// first, then smaller index, which is exact and keeps the first index on
// ties; a chunk's start stands in for the index inside it, since a row's
// chunks are disjoint.  Only then is the winning chunk's distances
// recomputed from shared memory, once a row, for the first equal one (a
// tile that another follows resolves its chunks before it leaves shared
// memory).  A split that saw only +inf keeps index 0, as the plain version
// does for an all-infinite row.  The
// launch takes the first (R, S) of kPlans whose grid puts a block on about
// every SM, so B = 64, 16 and 8 all fill the card.  y streams through
// shared memory in tiles of kTile points stored as float4; ragged N and M
// are masked, not padded.  The [N, M] matrix never exists.

#include "sqdist_common.cuh"

namespace {

constexpr int kWarps = 8;  // a block: kWarps / S row groups of S warps
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;  // y points a staged tile: 16 KB as float4
constexpr int kChunk = 8;    // distances a lane folds into a row's minimum between two compares
static_assert(kTile % kChunk == 0, "a chunk never straddles two tiles");

struct Plan {
  int R, S;  // rows a lane, warps (splits of y) a row group
};
// In order of preference: the most rows a lane, then the fewest splits.
constexpr Plan kPlans[] = {{4, 4}, {4, 8}, {2, 8}, {1, 8}};

// The offset in [0, kChunk) of the first point of the staged chunk
// ys[c0, c0 + kChunk) whose distance to (q0, q1, q2) is d; the chunk holds
// one.  It scans from the chunk's end, so the lowest such offset stays; the
// reads are clamped into the tile's nj points and the entries past them
// masked.
__device__ __forceinline__ int first_equal(const float4* ys, int c0, int nj, float q0, float q1, float q2, float d) {
  int at = 0;
#pragma unroll
  for (int c = kChunk - 1; c >= 0; --c) {
    const float4 p = ys[min(c0 + c, nj - 1)];
    if (c0 + c < nj && pca::sqdist3(q0, q1, q2, p.x, p.y, p.z) == d) at = c;
  }
  return at;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    min_rows_kernel(const float* __restrict__ x, const float* __restrict__ y, int N, int M, int S,
                    float* __restrict__ mins, int* __restrict__ argmin) {
  __shared__ float4 ys[kTile];
  __shared__ float part_d[kWarps][32 * R];
  __shared__ int part_j[kWarps][32 * R];
  __shared__ bool part_open[kWarps][32 * R];
  __shared__ float part_x[kWarps][32 * R][3];  // a group's rows, for the rescan after the merge
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = warp % S, g = warp / S;
  const int row0 = (blockIdx.x * (kWarps / S) + g) * 32 * R;  // the group's rows: row0 + lane + 32 r
  const float* xb = x + (size_t)b * N * 3;
  const float* yb = y + (size_t)b * M * 3;

  float q[R][3], best[R];
  int arg[R];     // the first j attaining best (0 while best is +inf), or where open the start of its chunk
  bool open[R];   // arg is the start of a chunk of the last tile, rescanned after the merge
  int first[R];   // in the staged tile: the start of the last chunk that lowered best, -1 if none did
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + lane + 32 * r;
    q[r][0] = q[r][1] = q[r][2] = 0.f;
    if (i < N) {
      q[r][0] = xb[3 * i];
      q[r][1] = xb[3 * i + 1];
      q[r][2] = xb[3 * i + 2];
    }
    best[r] = INFINITY;
    arg[r] = 0;
    open[r] = false;
  }
  int j0 = 0, nj = min(kTile, M);  // the staged tile

  for (;; j0 += kTile) {
    nj = min(kTile, M - j0);
    __syncthreads();  // the previous tile's reads are done
    for (int j = tid; j < nj; j += kThreads) {
      const float* p = yb + (size_t)(j0 + j) * 3;
      ys[j] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) first[r] = -1;
    int c0 = s * kChunk;
    for (; c0 + kChunk <= nj; c0 += S * kChunk) {
      float low[R];
#pragma unroll
      for (int r = 0; r < R; ++r) low[r] = best[r];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float4 p = ys[c0 + c];
#pragma unroll
        for (int r = 0; r < R; ++r) low[r] = fminf(low[r], pca::sqdist3(q[r][0], q[r][1], q[r][2], p.x, p.y, p.z));
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (low[r] < best[r]) first[r] = c0;
        best[r] = low[r];
      }
    }
    if (c0 < nj) {  // the tile's last, partial chunk: at most one a split
      float low[R];
#pragma unroll
      for (int r = 0; r < R; ++r) low[r] = best[r];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c0 + c < nj) {
          const float4 p = ys[c0 + c];
#pragma unroll
          for (int r = 0; r < R; ++r)
            low[r] = fminf(low[r], pca::sqdist3(q[r][0], q[r][1], q[r][2], p.x, p.y, p.z));
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (low[r] < best[r]) first[r] = c0;
        best[r] = low[r];
      }
    }
    if (j0 + kTile >= M) {  // the last tile: its winning chunks wait for the merge
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (first[r] >= 0) {
          arg[r] = j0 + first[r];
          open[r] = true;
        }
      }
      break;
    }
    // Another tile follows: the first j of this tile's winning chunk whose
    // distance is the minimum, while the tile is staged.
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (first[r] >= 0) arg[r] = j0 + first[r] + first_equal(ys, first[r], nj, q[r][0], q[r][1], q[r][2], best[r]);
  }

  // Merge the group's S splits row by row in lexicographic (distance,
  // index) order.  An open split's chunk start stands in for its index: the
  // chunks of a row's splits are disjoint and each holds its split's first
  // index of the minimum, so the order is the same.  The winner's chunk, if
  // open, is rescanned once, from the last tile, still staged.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    part_d[warp][lane + 32 * r] = best[r];
    part_j[warp][lane + 32 * r] = arg[r];
    part_open[warp][lane + 32 * r] = open[r];
    if (s == 0) {
      part_x[g][lane + 32 * r][0] = q[r][0];
      part_x[g][lane + 32 * r][1] = q[r][1];
      part_x[g][lane + 32 * r][2] = q[r][2];
    }
  }
  __syncthreads();
  for (int u = s * 32 + lane; u < 32 * R; u += 32 * S) {
    const int i = row0 + u;
    if (i >= N) break;
    float d = part_d[g * S][u];
    int j = part_j[g * S][u];
    bool o = part_open[g * S][u];
    for (int v = 1; v < S; ++v) {
      const float dv = part_d[g * S + v][u];
      const int jv = part_j[g * S + v][u];
      if (dv < d || (dv == d && jv < j)) {
        d = dv;
        j = jv;
        o = part_open[g * S + v][u];
      }
    }
    if (o) j += first_equal(ys, j - j0, nj, part_x[g][u][0], part_x[g][u][1], part_x[g][u][2], d);
    mins[(size_t)b * N + i] = d;
    argmin[(size_t)b * N + i] = j;
  }
}

template <int R>
cudaError_t launch(const float* x, const float* y, int B, int N, int M, int S, float* mins, int* argmin,
                   cudaStream_t stream) {
  const int rows = kWarps / S * 32 * R;
  min_rows_kernel<R><<<dim3((N + rows - 1) / rows, B), kThreads, 0, stream>>>(x, y, N, M, S, mins, argmin);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// device: CUDA device index of the pointers and the stream.  x [B, N, 3]
// and y [B, M, 3] f32; mins [B, N] f32, argmin [B, N] int32.  Returns a
// cudaError_t code (0 on success).
int pca_min_rows(int device, const void* x, const void* y, int B, int N, int M, void* mins,
                 void* argmin, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  static int sms[64] = {0};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  // the first plan whose grid puts a block on about every SM, else the one with the most blocks
  Plan plan = kPlans[0];
  for (const Plan& p : kPlans) {
    plan = p;
    const long long rows = kWarps / p.S * 32 * p.R;
    if ((long long)B * ((N + rows - 1) / rows) * 100 >= 95LL * sms[device]) break;
  }
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* mf = static_cast<float*>(mins);
  int* af = static_cast<int*>(argmin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan.R) {
    case 4: return (int)launch<4>(xf, yf, B, N, M, plan.S, mf, af, s);
    case 2: return (int)launch<2>(xf, yf, B, N, M, plan.S, mf, af, s);
    default: return (int)launch<1>(xf, yf, B, N, M, plan.S, mf, af, s);
  }
}

}  // extern "C"
