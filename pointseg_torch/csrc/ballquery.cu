// Ball query: two selection kernels.
//
// Replaces pointseg/ops/pallas/ballquery.py::ball_query_pallas (kernel
// `_ballquery_kernel`, here `ball_query_kernel`) and
// ::ball_query_pallas_2l (`_ballquery_kernel_2l` with
// pointseg/ops/pallas/select2l.py::two_level_extract, here
// `ball_query_two_level_kernel`). Same raw result for both: for each
// centroid, the K nearest points with d^2 <= r^2 in ascending
// (d^2, index) order, followed, when fewer than K are in the ball, by the
// lowest-index points outside it in ascending index order; `in_ball`
// marks the first group. With `repeat` the kernels write the repeat
// filler themselves (slot 0's index in every slot outside the ball), so
// `ball_query(filler="repeat")` is one launch. d^2 is the Gram form
// max((|q|^2 - 2 q.c) + |c|^2, 0) in f32, written with __fmul_rn and
// __fadd_rn so that it rounds as the plain PyTorch version does. A point
// outside the ball, excluded by the mask or at a NaN distance is a
// non-member, which is how the plain version orders it (`where(inside,
// d2, inf)` under a stable sort); the Pallas kernels' finite
// `1e8 + 16*col` sentinels, which misplace a real d^2 above 1e7, are not
// carried over. K is at most 32 (one lane per output slot).
//
// What bounds it on the H100: the B*C*N distance evaluations. Kept exact
// (no fused multiply-add), a pair costs 8 rounded FP instructions and one
// compare; at the SA1 shape (B=8, C=1024, N=4096) that is 34M pairs, some
// 9 us of issue at 132 SMs x 128 lanes. The cloud is 12 bytes a point,
// read from L2 once a block. The selection is rare work beside it where
// balls are sparse (training), and bounded by the top-K's threshold where
// they are dense (evaluation, r = 0.8).
//
// Flat selection (kernel 2): a warp takes G centroids and its lanes 32
// neighbouring points, so one 16-byte shared-memory load of a point
// (x, y, z, |p|^2, NaN when masked) serves G distances; two chunks of 32
// points an iteration give 2G independent rounding chains, and one vote
// asks whether any of the G balls took any of the 64 points. Only then a
// ballot for each centroid compacts its members, in index order, into a
// 32-entry staging list in shared memory; a full list is sorted once (a
// bitonic network, 15 shuffle steps) and merged into the kept top-32 in
// the lanes (5 more). Once K are kept, a point is taken only when its d^2
// is strictly below the K-th (a later point loses a tie), so a ball of
// thousands of members merges a few hundred. A ball of fewer than K
// members (training's usual case) never merges: each member's slot is
// its rank by (d^2, index) in the staging list, and the fillers need no
// pass of their own, lane count + j taking the j-th index not among the
// members. The evaluation buckets have too few centroids for their
// points, so S warps may share a centroid, each scanning every S-th
// 32-point chunk, and merge their lists at the end; pick_flat sizes G, S
// and the warps a block from the shape. The result depends on none of
// them.
//
// Two-level selection (kernel 6): kWarps centroids of one cloud share a
// block and stage the cloud through shared memory in kTile-point tiles.
// Lane l owns the strided columns
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

#include "launch.cuh"

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

// Kernel 6's tile of the cloud in shared memory, with the points' squared norms.
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

// (d, i) sorts before (bd, bi): ascending d^2, ties to the lower index.
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// One compare-exchange step of a bitonic network over one (d, i) a lane:
// the lane keeps the smaller of itself and its partner `lane ^ j` when it
// is the lower lane of a pair that sorts ascending, else the larger.
__device__ __forceinline__ void exchange(float& d, int& i, int j, bool ascending) {
  const float od = __shfl_xor_sync(kFull, d, j);
  const int oi = __shfl_xor_sync(kFull, i, j);
  const bool low = (threadIdx.x & j) == 0;
  if (before(od, oi, d, i) == (low == ascending)) {
    d = od;
    i = oi;
  }
}

// Sorts the warp's 32 (d, i), one a lane, ascending across the lanes.
__device__ __forceinline__ void sort32(float& d, int& i) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) exchange(d, i, j, (lane & k) == 0);
  }
}

// Sorts a bitonic sequence of 32 (d, i) ascending.
__device__ __forceinline__ void merge32(float& d, int& i) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) exchange(d, i, j, true);
}

// Sorts 32 ints, one a lane, ascending.
__device__ __forceinline__ void sort32(int& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, j);
      const bool low = (lane & j) == 0;
      if ((o < v) == (low == ((lane & k) == 0))) v = o;
    }
  }
}

// The flat kernel's tile: a point a float4, (x, y, z, |p|^2), |p|^2 NaN for
// a point the mask excludes, so that d^2 <= r^2 refuses it as it refuses a
// NaN coordinate. Padded with NaN points to a whole number of 32-point
// chunks.
constexpr int kFlatTile = 1024;
constexpr int kMaxFlatLists = 64;  // warps x centroids a warp, a block
constexpr int kMaxFlatWarps = 16;

// One warp's selection state for one centroid.
struct Ball {
  float qx, qy, qz, q2;
  float lim;   // a point is taken while its raw d^2 <= lim
  int count;   // members seen (exact while below K)
  int staged;  // entries in the staging list
  float kd;    // lane l: the l-th entry of the kept list (+inf: empty)
  int ki;
};

// Merges the staged entries (buf[0, staged), in index order) into the kept
// list. When the list holds K entries, lim becomes the largest float below
// the K-th d^2: a later point has a larger index, so at an equal d^2 it
// loses to the K-th, and only a strictly smaller one can enter.
__device__ __forceinline__ void flush(Ball& s, int2* buf, int K) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const int2 e = lane < s.staged ? buf[lane] : make_int2(__float_as_int(CUDART_INF_F), INT_MAX);
  __syncwarp();  // read before the next entries overwrite it
  float d = __int_as_float(e.x);
  int i = e.y;
  sort32(d, i);
  // the 32 smallest of two ascending lists, as a bitonic sequence
  const float od = __shfl_sync(kFull, d, 31 - lane);
  const int oi = __shfl_sync(kFull, i, 31 - lane);
  if (before(od, oi, s.kd, s.ki)) {
    s.kd = od;
    s.ki = oi;
  }
  merge32(s.kd, s.ki);
  s.staged = 0;
  const float kth = __shfl_sync(kFull, s.kd, K - 1);
  if (__shfl_sync(kFull, s.ki, K - 1) != INT_MAX) {
    // below +0 lies -0's neighbour, the smallest negative float: raw < 0
    s.lim = kth > 0.f ? __int_as_float(__float_as_int(kth) - 1) : __int_as_float(0x80000001);
  }
}

// The members of one 32-point chunk, `bits` by lane, go to the staging list
// in index order; a full list is merged into the kept one first.
__device__ __forceinline__ void take(Ball& s, int2* buf, unsigned bits, float raw, int idx,
                                     int K) {
  const int lane = threadIdx.x & 31;
  const int n = __popc(bits);
  s.count += n;
  if (s.staged + n > 32) flush(s, buf, K);
  if ((bits >> lane) & 1u) {
    const int pos = s.staged + __popc(bits & ((1u << lane) - 1u));
    buf[pos] = make_int2(__float_as_int(raw > 0.f ? raw : 0.f), idx);  // -0 and < 0 as +0
  }
  s.staged += n;
}

// One ball's K slots from its sorted kept list (all its members when fewer
// than K: the fillers are then the lowest indices outside it, lane
// count + j taking the j-th by stepping over the members in index order).
__device__ __forceinline__ void write_ball(const Ball& s, int* out_idx, bool* out_in_ball,
                                           int K, int repeat) {
  const int lane = threadIdx.x & 31;
  int idx = s.ki;
  if (s.count < K) {
    int member = lane < s.count ? s.ki : INT_MAX;
    sort32(member);
    int f = lane - s.count;
    for (int t = 0; t < s.count; ++t) f += __shfl_sync(kFull, member, t) <= f;
    if (lane >= s.count) idx = f;
  }
  const int m = min(s.count, K);
  const int first = __shfl_sync(kFull, idx, 0);
  if (lane < K) {
    out_idx[lane] = (repeat && lane >= m) ? first : idx;
    out_in_ball[lane] = lane < m;
  }
}

// The same for a ball of fewer than K members, all still in the staging
// list in index order (no merge has run): a member's slot is its rank by
// (d^2, index), counted over the list, and the fillers step over the
// list. Cheaper than sorting when, as in training, a ball has a few.
__device__ __forceinline__ void write_sparse(const Ball& s, const int2* buf, int* out_idx,
                                             bool* out_in_ball, int K, int repeat) {
  const int lane = threadIdx.x & 31;
  const int count = s.count;
  const bool member = lane < count;
  __syncwarp();  // the members' entries, written by other lanes
  const int2 mine = buf[member ? lane : 0];
  const float md = __int_as_float(mine.x);
  int rank = 0;
  int f = lane - count;
  for (int t = 0; t < count; ++t) {
    const int2 e = buf[t];
    rank += before(__int_as_float(e.x), e.y, md, mine.y);
    f += e.y <= f;
  }
  const unsigned nearest = __ballot_sync(kFull, member && rank == 0);
  const int first = nearest ? __shfl_sync(kFull, mine.y, __ffs(nearest) - 1)
                            : __shfl_sync(kFull, f, 0);
  if (lane < K) {
    const int slot = member ? rank : lane;
    out_idx[slot] = member ? mine.y : (repeat ? first : f);
    out_in_ball[slot] = member;
  }
}

// G centroids a warp; a block of W warps holds W / S groups of S warps, and
// the S warps of a group share its G centroids, each scanning every S-th
// 32-point chunk of the cloud.
template <int G>
__launch_bounds__(kMaxFlatWarps * 32)
__global__ void ball_query_kernel(const float* __restrict__ centroids,
                                  const float* __restrict__ coords,
                                  const bool* __restrict__ mask, int* __restrict__ out_idx,
                                  bool* __restrict__ out_in_ball, int C, int N, int K,
                                  float r2, int repeat, int S) {
  extern __shared__ float4 smem[];
  float4* tile = smem;
  int2* lists = reinterpret_cast<int2*>(tile + kFlatTile);  // [warp][g][32]
  int* counts = reinterpret_cast<int*>(lists + (blockDim.x >> 5) * G * 32);  // [warp][g]

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = warp % S;
  const int c0 = (blockIdx.x * (blockDim.x >> 5) / S + warp / S) * G;
  int2* buf = lists + warp * G * 32;

  Ball s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    s[g].qx = s[g].qy = s[g].qz = s[g].q2 = CUDART_NAN_F;  // past C: a ball with no member
    if (c0 + g < C) {
      const float* q = centroids + (static_cast<size_t>(b) * C + c0 + g) * 3;
      s[g].qx = q[0];
      s[g].qy = q[1];
      s[g].qz = q[2];
      s[g].q2 = sqnorm(s[g].qx, s[g].qy, s[g].qz);
    }
    s[g].lim = r2;
    s[g].count = 0;
    s[g].staged = 0;
    s[g].kd = CUDART_INF_F;
    s[g].ki = INT_MAX;
  }

  const float* pts = coords + static_cast<size_t>(b) * N * 3;
  const bool* valid = mask ? mask + static_cast<size_t>(b) * N : nullptr;
  for (int base = 0; base < N; base += kFlatTile) {
    const int n = min(kFlatTile, N - base);
    const int chunks = (n + 31) >> 5;
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < chunks * 32; t += blockDim.x) {
      float4 p = make_float4(0.f, 0.f, 0.f, CUDART_NAN_F);
      if (t < n) {
        const float* src = pts + 3 * (base + t);
        p.x = __ldg(src);
        p.y = __ldg(src + 1);
        p.z = __ldg(src + 2);
        p.w = (valid == nullptr || valid[base + t]) ? sqnorm(p.x, p.y, p.z) : CUDART_NAN_F;
      }
      tile[t] = p;
    }
    __syncthreads();

    // two chunks an iteration: twice the independent chains a warp
    for (int k = slice; k < chunks; k += 2 * S) {
      const bool second = k + S < chunks;  // uniform across the warp
      const float4 p0 = tile[32 * k + lane];
      const float4 p1 =
          second ? tile[32 * (k + S) + lane] : make_float4(0.f, 0.f, 0.f, CUDART_NAN_F);
      float raw0[G], raw1[G];
      bool hit = false;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        raw0[g] = gram_sqdist(s[g].qx, s[g].qy, s[g].qz, s[g].q2, p0.x, p0.y, p0.z, p0.w);
        raw1[g] = gram_sqdist(s[g].qx, s[g].qy, s[g].qz, s[g].q2, p1.x, p1.y, p1.z, p1.w);
        hit |= (raw0[g] <= s[g].lim) | (raw1[g] <= s[g].lim);
      }
      if (!__any_sync(kFull, hit)) continue;  // most chunks of most balls
      const int idx = base + 32 * k + lane;
#pragma unroll
      for (int g = 0; g < G; ++g) {  // the first chunk's members before the second's
        const unsigned bits = __ballot_sync(kFull, raw0[g] <= s[g].lim);
        if (bits) take(s[g], buf + g * 32, bits, raw0[g], idx, K);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const unsigned bits = __ballot_sync(kFull, raw1[g] <= s[g].lim);
        if (bits) take(s[g], buf + g * 32, bits, raw1[g], idx + 32 * S, K);
      }
    }
  }

  const size_t row = (static_cast<size_t>(b) * C + c0) * K;  // the first centroid's slots
  if (S == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (c0 + g >= C) break;
      if (s[g].count < K) {
        write_sparse(s[g], buf + g * 32, out_idx + row + g * K, out_in_ball + row + g * K, K,
                     repeat);
      } else {
        flush(s[g], buf + g * 32, K);
        write_ball(s[g], out_idx + row + g * K, out_in_ball + row + g * K, K, repeat);
      }
    }
    return;
  }

  // the group's first warp merges the S kept lists
#pragma unroll
  for (int g = 0; g < G; ++g) {
    flush(s[g], buf + g * 32, K);
    buf[g * 32 + lane] = make_int2(__float_as_int(s[g].kd), s[g].ki);
    if (lane == 0) counts[warp * G + g] = s[g].count;
  }
  __syncthreads();
  if (slice != 0) return;
  for (int o = 1; o < S; ++o) {
    const int2* other = lists + (warp + o) * G * 32;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int2 e = other[g * 32 + 31 - lane];
      if (before(__int_as_float(e.x), e.y, s[g].kd, s[g].ki)) {
        s[g].kd = __int_as_float(e.x);
        s[g].ki = e.y;
      }
      merge32(s[g].kd, s[g].ki);
      s[g].count += counts[(warp + o) * G + g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (c0 + g >= C) break;
    write_ball(s[g], out_idx + row + g * K, out_in_ball + row + g * K, K, repeat);
  }
}

// Centroids a warp (G), warps a block (W) and warps a centroid (S) for a
// shape, from the sweep that chip_smoke.py prints (NVIDIA H100 80GB HBM3,
// 700 W): a warp scans at most 4096 points (S from N / 4096), and G is the
// largest of 4, 2, 1 that still gives 2048 warps (4096 when the cloud is
// split), so the training stages above 1024 centroids take 4 a warp,
// the small ones 1, the evaluation buckets 2 or 4 over 4 or 16 warps.
void pick_flat(int B, int C, int N, int& G, int& W, int& S) {
  const long long balls = static_cast<long long>(B) * C;
  S = 1;
  while (S < kMaxFlatWarps && N / S > 4096) S <<= 1;
  const long long wanted = S > 1 ? 4096 : 2048;
  G = 4;
  while (G > 1 && balls / G * S < wanted) G >>= 1;
  W = G == 4 ? 16 : 8;
  W = W > S ? W : S;
}

template <int G>
int launch_flat(const void* centroids, const void* coords, const void* mask, void* out_idx,
                void* out_in_ball, int B, int C, int N, int K, float r2, int repeat, int W, int S,
                cudaStream_t stream) {
  const int per_block = W / S * G;
  const size_t smem = kFlatTile * sizeof(float4) + W * G * (32 * sizeof(int2) + sizeof(int));
  const dim3 grid((C + per_block - 1) / per_block, B);
  ball_query_kernel<G><<<grid, W * 32, smem, stream>>>(
      static_cast<const float*>(centroids), static_cast<const float*>(coords),
      static_cast<const bool*>(mask), static_cast<int*>(out_idx),
      static_cast<bool*>(out_in_ball), C, N, K, r2, repeat, S);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- kernel 6

__device__ __forceinline__ void warp_first(float& v, int& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oc = __shfl_xor_sync(kFull, c, off);
    if (before(ov, oc, v, c)) {
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
                                            int C, int N, int K, float r2, int repeat) {
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
        if (before(lv, lc, v, col) && before(v, col, bv, bc)) {
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

  const int first = __shfl_sync(kFull, picked, 0);
  if (lane < K) {
    const size_t o = (static_cast<size_t>(b) * C + c) * K + lane;
    out_idx[o] = (repeat && !picked_in) ? first : picked;
    out_in_ball[o] = picked_in;
  }
}

template <typename Kernel>
int launch_ball_query(Kernel kernel, const void* centroids, const void* coords, const void* mask,
                      void* out_idx, void* out_in_ball, int B, int C, int N, int K, float r2,
                      int repeat, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const dim3 grid((C + kWarps - 1) / kWarps, B);
  kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centroids), static_cast<const float*>(coords),
      static_cast<const bool*>(mask), static_cast<int*>(out_idx),
      static_cast<bool*>(out_in_ball), C, N, K, r2, repeat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// centroids (B, C, 3) f32, coords (B, N, 3) f32, mask (B, N) bool or null,
// out_idx (B, C, K) i32, out_in_ball (B, C, K) bool. Needs 1 <= K <= 32, K <= N.
// `repeat` != 0 writes the repeat filler (slot 0's index in every slot
// outside the ball), 0 the raw fillers. `groups`, `warps`, `slices` force
// the centroids a warp (1, 2, 4 or 8), warps a block (<= 16) and warps a
// centroid (a power of two dividing `warps`); 0 lets pick_flat choose.
// `device` is the tensors' device, `stream` a stream of it.
extern "C" int pointseg_ball_query(const void* centroids, const void* coords,
                                   const void* mask, void* out_idx, void* out_in_ball,
                                   int B, int C, int N, int K, float r2, int repeat, int groups,
                                   int warps, int slices, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  int G, W, S;
  pick_flat(B, C, N, G, W, S);
  G = groups ? groups : G;
  W = warps ? warps : W;
  S = slices ? slices : S;
  if (W < 1 || W > kMaxFlatWarps || S < 1 || (S & (S - 1)) || W % S || W * G > kMaxFlatLists) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1:
      return launch_flat<1>(centroids, coords, mask, out_idx, out_in_ball, B, C, N, K, r2,
                            repeat, W, S, s);
    case 2:
      return launch_flat<2>(centroids, coords, mask, out_idx, out_in_ball, B, C, N, K, r2,
                            repeat, W, S, s);
    case 4:
      return launch_flat<4>(centroids, coords, mask, out_idx, out_in_ball, B, C, N, K, r2,
                            repeat, W, S, s);
    case 8:
      return launch_flat<8>(centroids, coords, mask, out_idx, out_in_ball, B, C, N, K, r2,
                            repeat, W, S, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As pointseg_ball_query, by the two-level selection with per-lane stacks
// of `depth` entries: 4 or 5 in use, 1 to force refills in tests.
extern "C" int pointseg_ball_query_2l(const void* centroids, const void* coords,
                                      const void* mask, void* out_idx, void* out_in_ball,
                                      int B, int C, int N, int K, float r2, int depth,
                                      int repeat, int device, void* stream) {
  switch (depth) {
    case 1:
      return launch_ball_query(ball_query_two_level_kernel<1>, centroids, coords, mask, out_idx,
                               out_in_ball, B, C, N, K, r2, repeat, device, stream);
    case 4:
      return launch_ball_query(ball_query_two_level_kernel<4>, centroids, coords, mask, out_idx,
                               out_in_ball, B, C, N, K, r2, repeat, device, stream);
    case 5:
      return launch_ball_query(ball_query_two_level_kernel<5>, centroids, coords, mask, out_idx,
                               out_in_ball, B, C, N, K, r2, repeat, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
