// Ball query: one warp per centroid, scanning the cloud in index order.
//
// Replaces pointseg/ops/pallas/ballquery.py::ball_query_pallas (kernel
// `_ballquery_kernel`). Same raw result: for each centroid, the K
// nearest points with d^2 <= r^2 in ascending (d^2, index) order,
// followed, when fewer than K are in the ball, by the lowest-index
// points outside it in ascending index order (the Pallas kernel's
// `1e8 + 16*col` sentinels); `in_ball` marks the first group. The
// Python wrapper then applies the repeat filler. d^2 is the Gram form
// max((|q|^2 - 2 q.c) + |c|^2, 0) in f32, written with __fmul_rn and
// __fadd_rn so that it rounds as the plain PyTorch version does.
//
// What bounds it on the H100: the B*C*N distance evaluations (9 flops
// each) and the selection; the cloud is only 12 bytes a point and is
// read once per block from L2. At the slice's SA1 shape
// (B=8, C=1024, N=4096) that is 34M distances, a few microseconds of
// arithmetic; the selection's serial insertions and the warp-level
// shuffles set the time.
//
// What the design does about it: the top-K list lives in registers
// across the warp's lanes (lane j holds the j-th nearest), so inserting
// a candidate is one ballot plus one shuffle, and no (C, N) distance
// block is ever stored. kWarps centroids of one cloud share a block and
// stage the cloud through shared memory in kTile-point tiles, so any N
// fits. Points are visited in ascending index, so a candidate that ties
// a listed distance goes behind it, and the first K points outside the
// ball are the fillers. K is at most 32 (one lane per slot).

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void ball_query_kernel(const float* __restrict__ centroids,
                                  const float* __restrict__ coords,
                                  const bool* __restrict__ mask,
                                  int* __restrict__ out_idx,
                                  bool* __restrict__ out_in_ball,
                                  int C, int N, int K, float r2) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], s2[kTile];
  __shared__ int s_fill[kWarps][32];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  const bool active = c < C;  // uniform across the warp
  const unsigned lanes_below = (1u << lane) - 1u;

  float qx = 0.f, qy = 0.f, qz = 0.f, q2 = 0.f;
  if (active) {
    const float* q = centroids + (static_cast<size_t>(b) * C + c) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
    q2 = sqnorm(qx, qy, qz);
  }

  // lane j holds the j-th nearest in-ball point so far; empty = (+inf, INT_MAX)
  float list_d = CUDART_INF_F;
  int list_i = INT_MAX;
  int count = 0;  // in-ball points seen
  int nfill = 0;  // out-of-ball points seen (the first K are kept)

  const float* pts = coords + static_cast<size_t>(b) * N * 3;
  const bool* valid = mask ? mask + static_cast<size_t>(b) * N : nullptr;

  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float x = pts[3 * (base + i)];
      const float y = pts[3 * (base + i) + 1];
      const float z = pts[3 * (base + i) + 2];
      sx[i] = x;
      sy[i] = y;
      sz[i] = z;
      s2[i] = sqnorm(x, y, z);
    }
    __syncthreads();
    if (!active) continue;

    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool here = j < n;
      float d = CUDART_INF_F;
      bool inside = false;
      if (here) {
        const float cross = __fadd_rn(
            __fadd_rn(__fmul_rn(qx, sx[j]), __fmul_rn(qy, sy[j])), __fmul_rn(qz, sz[j]));
        d = fmaxf(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), s2[j]), 0.f);
        inside = d <= r2 && (valid == nullptr || valid[base + j]);
      }
      const unsigned in_bits = __ballot_sync(kFull, inside);
      const unsigned out_bits = __ballot_sync(kFull, here && !inside);

      if (nfill < K) {
        if (here && !inside) {
          const int slot = nfill + __popc(out_bits & lanes_below);
          if (slot < K) s_fill[warp][slot] = base + j;
        }
        nfill += __popc(out_bits);
      }

      unsigned pending = in_bits;
      while (pending) {
        const int src = __ffs(pending) - 1;
        pending &= pending - 1;
        const float cd = __shfl_sync(kFull, d, src);
        const int ci = base + j0 + src;
        ++count;
        const float last = __shfl_sync(kFull, list_d, K - 1);
        if (!(cd < last)) continue;  // a tie keeps the lower listed index
        const unsigned behind = __ballot_sync(kFull, list_d > cd);
        const int pos = __ffs(behind) - 1;
        const float up_d = __shfl_up_sync(kFull, list_d, 1);
        const int up_i = __shfl_up_sync(kFull, list_i, 1);
        if (lane > pos) {
          list_d = up_d;
          list_i = up_i;
        } else if (lane == pos) {
          list_d = cd;
          list_i = ci;
        }
      }
    }
  }

  if (!active) return;
  __syncwarp();
  const int m = min(count, K);
  if (lane < K) {
    const size_t o = (static_cast<size_t>(b) * C + c) * K + lane;
    out_idx[o] = lane < m ? list_i : s_fill[warp][lane - m];
    out_in_ball[o] = lane < m;
  }
}

}  // namespace

// centroids (B, C, 3) f32, coords (B, N, 3) f32, mask (B, N) bool or null,
// out_idx (B, C, K) i32, out_in_ball (B, C, K) bool. Needs 1 <= K <= 32, K <= N.
extern "C" int pointseg_ball_query(const void* centroids, const void* coords,
                                   const void* mask, void* out_idx, void* out_in_ball,
                                   int B, int C, int N, int K, float r2, void* stream) {
  const dim3 grid((C + kWarps - 1) / kWarps, B);
  ball_query_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centroids), static_cast<const float*>(coords),
      static_cast<const bool*>(mask), static_cast<int*>(out_idx),
      static_cast<bool*>(out_in_ball), C, N, K, r2);
  return static_cast<int>(cudaGetLastError());
}
