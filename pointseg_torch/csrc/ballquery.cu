// Ball query: one warp per centroid, two selection schemes.
//
// Replaces pointseg/ops/pallas/ballquery.py::ball_query_pallas (kernel
// `_ballquery_kernel`, here `ball_query_kernel`) and
// ::ball_query_pallas_2l (`_ballquery_kernel_2l` with
// pointseg/ops/pallas/select2l.py::two_level_extract, here
// `ball_query_two_level_kernel`). Same raw result for both: for each
// centroid, the K nearest points with d^2 <= r^2 in ascending
// (d^2, index) order, followed, when fewer than K are in the ball, by the
// lowest-index points outside it in ascending index order; `in_ball`
// marks the first group. The Python wrapper then applies the repeat
// filler. d^2 is the Gram form max((|q|^2 - 2 q.c) + |c|^2, 0) in f32,
// written with __fmul_rn and __fadd_rn so that it rounds as the plain
// PyTorch version does. A point outside the ball, excluded by the mask or
// at a NaN distance is a non-member and takes the key +inf, which is how
// the plain version orders it (`where(inside, d2, inf)` under a stable
// sort); the Pallas kernels' finite `1e8 + 16*col` sentinels, which
// misplace a real d^2 above 1e7, are not carried over.
//
// What bounds it on the H100: the B*C*N distance evaluations (10 flops
// each) and the selection; the cloud is only 12 bytes a point and is
// read once per block from L2. At the SA1 shape (B=8, C=1024, N=4096)
// that is 34M distances, a few microseconds of arithmetic; the
// selection's serial steps and the warp-level shuffles set the time.
//
// Both kernels: kWarps centroids of one cloud share a block and stage the
// cloud through shared memory in kTile-point tiles, so any N fits, and no
// (C, N) distance block is ever stored. K is at most 32 (one lane per
// output slot).
//
// Flat selection (kernel 2): the top-K list lives in registers across the
// warp's lanes (lane j holds the j-th nearest), so inserting a candidate
// is one ballot plus one shuffle. Points are visited in ascending index,
// so a candidate that ties a listed distance goes behind it, and the
// first K points outside the ball are the fillers.
//
// Two-level selection (kernel 6): lane l owns the strided columns
// {32 w + l}, which are the points it measures anyway, so pass one needs
// no traffic between lanes: each lane keeps a sorted stack of its
// `Depth` first columns by (key, column) in registers. Then K rounds pick
// the first head across the warp, pop it, and refill a lane whose stack
// ran dry although it has columns left: the warp rescans that lane's
// columns (N/32 of them, read from global memory) for the first entry
// behind the last one consumed. An empty stack slot is told from a
// non-member by the lane's `have` count, not by its key. The result never
// depends on Depth, only the time; fillers come one per lane (columns
// 0..K-1), so sparse balls do not drain a stack faster than dense ones.

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

// (|q|^2 - 2 q.c) + |c|^2 before the clamp at 0: NaN for a NaN coordinate,
// which `<= r2` then refuses (fmaxf would turn it into 0).
__device__ __forceinline__ float gram_sqdist(float qx, float qy, float qz, float q2, float x,
                                             float y, float z, float c2) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, x), __fmul_rn(qy, y)), __fmul_rn(qz, z));
  return __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), c2);
}

// One tile of the cloud in shared memory, with the points' squared norms.
struct Tile {
  float x[kTile], y[kTile], z[kTile], n2[kTile];
};

// Loads points [base, base + n) of the cloud; ends with a block-wide barrier.
__device__ __forceinline__ void load_tile(Tile& t, const float* pts, int base, int n) {
  __syncthreads();  // the previous tile is no longer read
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = pts[3 * (base + i)];
    const float y = pts[3 * (base + i) + 1];
    const float z = pts[3 * (base + i) + 2];
    t.x[i] = x;
    t.y[i] = y;
    t.z[i] = z;
    t.n2[i] = sqnorm(x, y, z);
  }
  __syncthreads();
}

// ---------------------------------------------------------------- kernel 2

__global__ void ball_query_kernel(const float* __restrict__ centroids,
                                  const float* __restrict__ coords,
                                  const bool* __restrict__ mask,
                                  int* __restrict__ out_idx,
                                  bool* __restrict__ out_in_ball,
                                  int C, int N, int K, float r2) {
  __shared__ Tile tile;
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
    load_tile(tile, pts, base, n);
    if (!active) continue;

    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      const bool here = j < n;
      float d = CUDART_INF_F;
      bool inside = false;
      if (here) {
        const float raw =
            gram_sqdist(qx, qy, qz, q2, tile.x[j], tile.y[j], tile.z[j], tile.n2[j]);
        d = fmaxf(raw, 0.f);
        inside = raw <= r2 && (valid == nullptr || valid[base + j]);
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

// ---------------------------------------------------------------- kernel 6

// (key ascending, column ascending): is (v, c) in front of (bv, bc)?
__device__ __forceinline__ bool in_front(float v, int c, float bv, int bc) {
  return v < bv || (v == bv && c < bc);
}

__device__ __forceinline__ void warp_first(float& v, int& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oc = __shfl_xor_sync(kFull, c, off);
    if (in_front(ov, oc, v, c)) {
      v = ov;
      c = oc;
    }
  }
}

// A point's selection key: its clamped d^2 when it is in the ball (never
// NaN, never above r2), +inf otherwise.
__device__ __forceinline__ float ball_key(float raw, float r2, bool valid) {
  return (raw <= r2 && valid) ? fmaxf(raw, 0.f) : CUDART_INF_F;
}

template <int Depth>
__global__ void ball_query_two_level_kernel(const float* __restrict__ centroids,
                                            const float* __restrict__ coords,
                                            const bool* __restrict__ mask,
                                            int* __restrict__ out_idx,
                                            bool* __restrict__ out_in_ball,
                                            int C, int N, int K, float r2) {
  __shared__ Tile tile;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  const bool active = c < C;  // uniform across the warp

  float qx = 0.f, qy = 0.f, qz = 0.f, q2 = 0.f;
  if (active) {
    const float* q = centroids + (static_cast<size_t>(b) * C + c) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
    q2 = sqnorm(qx, qy, qz);
  }
  const float* pts = coords + static_cast<size_t>(b) * N * 3;
  const bool* valid = mask ? mask + static_cast<size_t>(b) * N : nullptr;

  // level 1: the first `have` (at most Depth) of this lane's columns
  // {32 w + lane} by (key, column), sorted
  float sv[Depth];
  int sc[Depth];
#pragma unroll
  for (int t = 0; t < Depth; ++t) {
    sv[t] = CUDART_INF_F;
    sc[t] = INT_MAX;
  }
  int have = 0;

  for (int base = 0; base < N; base += kTile) {  // kTile is a multiple of 32
    const int n = min(kTile, N - base);
    load_tile(tile, pts, base, n);
    if (!active) continue;
    for (int j = lane; j < n; j += 32) {
      const float raw =
          gram_sqdist(qx, qy, qz, q2, tile.x[j], tile.y[j], tile.z[j], tile.n2[j]);
      const float v = ball_key(raw, r2, valid == nullptr || valid[base + j]);
      // A lane visits its columns in ascending order, so the candidate
      // goes in front of a listed entry only on a strictly smaller key,
      // and behind the last one only while a slot is empty.
      if (have == Depth && !(v < sv[Depth - 1])) continue;
      // insertion chain, deepest level first so each step reads old levels
#pragma unroll
      for (int t = Depth - 1; t >= 0; --t) {
        const int up = t > 0 ? t - 1 : 0;
        if (t > 0 && (up >= have || v < sv[up])) {
          sv[t] = sv[up];
          sc[t] = sc[up];
        } else if (t >= have || v < sv[t]) {
          sv[t] = v;
          sc[t] = base + j;
        }
      }
      if (have < Depth) ++have;
    }
  }
  if (!active) return;

  // level 2: K rounds over the lane heads
  const int owned = (N - lane + 31) / 32;  // columns this lane owns
  int taken = 0;                           // of which consumed
  float last_v = 0.f;                      // the last one consumed
  int last_c = -1;
  int picked = 0;  // lane j keeps round j's column and whether it is a member
  bool picked_in = false;

  for (int j = 0; j < K; ++j) {
    unsigned dry = __ballot_sync(kFull, have == 0 && taken < owned);
    while (dry) {
      const int l = __ffs(dry) - 1;
      dry &= dry - 1;
      // the warp rescans lane l's columns for its first entry behind
      // (last_v, last_c), which exists: the lane has columns left. Lane t
      // takes the columns 32 (t + 32 m) + l.
      const float lv = __shfl_sync(kFull, last_v, l);
      const int lc = __shfl_sync(kFull, last_c, l);
      float bv = CUDART_INF_F;
      int bc = INT_MAX;
      for (int col = 32 * lane + l; col < N; col += 1024) {
        const float x = pts[3 * col], y = pts[3 * col + 1], z = pts[3 * col + 2];
        const float raw = gram_sqdist(qx, qy, qz, q2, x, y, z, sqnorm(x, y, z));
        const float v = ball_key(raw, r2, valid == nullptr || valid[col]);
        if (in_front(lv, lc, v, col) && in_front(v, col, bv, bc)) {
          bv = v;
          bc = col;
        }
      }
      warp_first(bv, bc);
      if (lane == l) {
        sv[0] = bv;
        sc[0] = bc;
        have = 1;
      }
    }

    const bool offers = have > 0;
    const int mine = sc[0];
    float hv = offers ? sv[0] : CUDART_INF_F;
    int hc = offers ? mine : INT_MAX;
    warp_first(hv, hc);  // K <= N: some lane still offers a column
    if (lane == j) {
      picked = hc;
      picked_in = hv < CUDART_INF_F;
    }
    if (offers && mine == hc) {  // pop this lane's head
      last_v = sv[0];
      last_c = sc[0];
#pragma unroll
      for (int t = 0; t + 1 < Depth; ++t) {
        sv[t] = sv[t + 1];
        sc[t] = sc[t + 1];
      }
      sv[Depth - 1] = CUDART_INF_F;
      sc[Depth - 1] = INT_MAX;
      --have;
      ++taken;
    }
  }

  if (lane < K) {
    const size_t o = (static_cast<size_t>(b) * C + c) * K + lane;
    out_idx[o] = picked;
    out_in_ball[o] = picked_in;
  }
}

template <typename Kernel>
int launch_ball_query(Kernel kernel, const void* centroids, const void* coords, const void* mask,
                      void* out_idx, void* out_in_ball, int B, int C, int N, int K, float r2,
                      void* stream) {
  const dim3 grid((C + kWarps - 1) / kWarps, B);
  kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centroids), static_cast<const float*>(coords),
      static_cast<const bool*>(mask), static_cast<int*>(out_idx),
      static_cast<bool*>(out_in_ball), C, N, K, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// centroids (B, C, 3) f32, coords (B, N, 3) f32, mask (B, N) bool or null,
// out_idx (B, C, K) i32, out_in_ball (B, C, K) bool. Needs 1 <= K <= 32, K <= N.
extern "C" int pointseg_ball_query(const void* centroids, const void* coords,
                                   const void* mask, void* out_idx, void* out_in_ball,
                                   int B, int C, int N, int K, float r2, void* stream) {
  return launch_ball_query(ball_query_kernel, centroids, coords, mask, out_idx, out_in_ball, B,
                           C, N, K, r2, stream);
}

// As pointseg_ball_query, by the two-level selection with per-lane stacks
// of `depth` entries: 4 or 5 in use, 1 to force refills in tests.
extern "C" int pointseg_ball_query_2l(const void* centroids, const void* coords,
                                      const void* mask, void* out_idx, void* out_in_ball,
                                      int B, int C, int N, int K, float r2, int depth,
                                      void* stream) {
  switch (depth) {
    case 1:
      return launch_ball_query(ball_query_two_level_kernel<1>, centroids, coords, mask, out_idx,
                               out_in_ball, B, C, N, K, r2, stream);
    case 4:
      return launch_ball_query(ball_query_two_level_kernel<4>, centroids, coords, mask, out_idx,
                               out_in_ball, B, C, N, K, r2, stream);
    case 5:
      return launch_ball_query(ball_query_two_level_kernel<5>, centroids, coords, mask, out_idx,
                               out_in_ball, B, C, N, K, r2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
