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
// carried over. The flat kernel takes K <= 32 (one lane per kept slot),
// the two-level one any K <= N.
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
// Two-level selection (kernel 6) scans as the flat kernel does (the same
// float4 tile, G balls a warp, two chunks an iteration, one vote for the
// 64 points of all G balls, S warps a ball at the evaluation buckets) and
// selects in two levels. Lane l measures the columns {32 k + l}, the
// strided ownership of the Pallas design, so level 1 needs no traffic
// between lanes: each lane keeps, per ball, a sorted stack of its first
// `Depth` members by (d^2, column) in registers. Non-members never enter,
// and once a stack is full its threshold drops just below its last entry,
// so the vote passes over the chunks that give no lane anything to keep.
// Level 2 runs rounds over the lane heads (two `redux.sync`: d^2's bits,
// then the lowest column), each popping the first head, until K members
// are out or no lane offers one; a lane whose full stack ran dry is
// refilled by the warp rescanning its columns for the first member behind
// the last consumed. One warp a ball writes each round's pick to the
// output (32 a store), so K is bounded by N only, and counts its fillers
// rather than popping them: the j-th lowest column outside the ball, by
// stepping over the sorted members when there are fewer than 32, else by
// a ballot over the lowest columns. S warps a ball (K <= 32) each list
// their first K in the lanes and merge as the flat kernel's do. The result depends on
// none of G, S, the warps a block or Depth.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"

namespace {

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
// chunks. `load_point` reads point i as the tile holds it.
__device__ __forceinline__ float4 load_point(const float* pts, const bool* valid, int i) {
  const float* src = pts + 3 * i;
  float4 p = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), 0.f);
  p.w = (valid == nullptr || valid[i]) ? sqnorm(p.x, p.y, p.z) : CUDART_NAN_F;
  return p;
}

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
    for (int t = threadIdx.x; t < chunks * 32; t += blockDim.x)
      tile[t] = t < n ? load_point(pts, valid, base + t)
                      : make_float4(0.f, 0.f, 0.f, CUDART_NAN_F);
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

// The warp's first (d^2 asc, column asc) of one (d^2, column) a lane, d^2
// >= +0 or the empty key 0xffffffff: d^2's bits order as unsigned ints,
// so two `redux.sync` do it, key then column among the lanes that hold it.
__device__ __forceinline__ int warp_first_member(unsigned key, int col, unsigned& best) {
  best = __reduce_min_sync(kFull, key);
  return __reduce_min_sync(kFull, key == best ? col : INT_MAX);
}
constexpr unsigned kNoMember = 0xffffffffu;

// One ball's selection state in kernel 6: the centroid, and this lane's
// sorted stack of its first `Depth` members by (d^2, column); an empty
// slot is (+inf, INT_MAX). A point enters while raw d^2 <= lim: r^2 until
// the stack is full, then just below its last entry (a later column loses
// a tie), so a member that cannot enter costs one compare.
template <int Depth>
struct Stack {
  float qx, qy, qz, q2, lim;
  float sv[Depth];
  int sc[Depth];
};

template <int Depth>
__device__ __forceinline__ void push(Stack<Depth>& s, float raw, int col) {
  const float d = raw > 0.f ? raw : 0.f;  // -0 and < 0 as +0
#pragma unroll
  for (int t = Depth - 1; t >= 0; --t) {  // deepest first: each step reads old levels
    if (t > 0 && before(d, col, s.sv[t - 1], s.sc[t - 1])) {
      s.sv[t] = s.sv[t - 1];
      s.sc[t] = s.sc[t - 1];
    } else if (before(d, col, s.sv[t], s.sc[t])) {
      s.sv[t] = d;
      s.sc[t] = col;
    }
  }
  if (s.sc[Depth - 1] != INT_MAX) {
    const float tail = s.sv[Depth - 1];
    s.lim = tail > 0.f ? __int_as_float(__float_as_int(tail) - 1) : -CUDART_INF_F;
  }
}

// Lane l's first member behind (ld, lc) by (d^2, column), among its columns
// 32 k + l for the chunks k = slice (mod S): lane t of the warp measures the
// chunks slice + S (t + 32 m), with the scan's arithmetic, reading `tile`
// when it holds the whole cloud (else null). Returns the key (kNoMember when
// there is none) and the column.
__device__ __forceinline__ unsigned rescan_ball(const float4* tile, const float* pts,
                                                const bool* valid, int N, int S, int slice,
                                                float qx, float qy, float qz, float q2, float r2,
                                                int l, float ld, int lc, int& best_col) {
  const int lane = threadIdx.x & 31;
  float bd = CUDART_INF_F;
  int bc = INT_MAX;
  for (int m = 0; 32 * (slice + 32 * S * m) + l < N; ++m) {  // uniform across the warp
    const int col = 32 * (slice + S * (lane + 32 * m)) + l;
    if (col >= N) continue;
    const float4 p = tile ? tile[col] : load_point(pts, valid, col);
    const float raw = gram_sqdist(qx, qy, qz, q2, p.x, p.y, p.z, p.w);
    if (!(raw <= r2)) continue;
    const float d = raw > 0.f ? raw : 0.f;
    if (before(ld, lc, d, col) && before(d, col, bd, bc)) {
      bd = d;
      bc = col;
    }
  }
  unsigned best;
  best_col = warp_first_member(bc == INT_MAX ? kNoMember : __float_as_uint(bd), bc, best);
  return best;
}

// Level 2 of one ball in one warp: up to `K` rounds over the lane heads,
// each taking the first head and popping it, a dry lane refilled by a
// rescan when its stack had filled (members may lie behind it). Round j's
// (d^2, column) goes to `emit(j, key, col)`. Returns the rounds that found
// a member; they stop when no lane offers one.
template <int Depth, typename Emit>
__device__ __forceinline__ int rounds(Stack<Depth>& s, const float4* tile, const float* pts,
                                      const bool* valid, int N, int S, int slice, float r2, int K,
                                      Emit emit) {
  const int lane = threadIdx.x & 31;
  int have = 0;
#pragma unroll
  for (int t = 0; t < Depth; ++t) have += s.sc[t] != INT_MAX;
  bool more = have == Depth;  // members this lane may hold behind its stack
  float last_d = 0.f;
  int last_c = -1;
  for (int j = 0; j < K; ++j) {
    unsigned dry = __ballot_sync(kFull, have == 0 && more);
    while (dry) {
      const int l = __ffs(dry) - 1;
      dry &= dry - 1;
      int bc;
      const unsigned bk = rescan_ball(tile, pts, valid, N, S, slice, s.qx, s.qy, s.qz, s.q2, r2,
                                      l, __shfl_sync(kFull, last_d, l),
                                      __shfl_sync(kFull, last_c, l), bc);
      if (lane == l) {
        if (bk == kNoMember) {
          more = false;
        } else {
          s.sv[0] = __uint_as_float(bk);
          s.sc[0] = bc;
          have = 1;
        }
      }
    }
    unsigned best;
    const int bc = warp_first_member(have > 0 ? __float_as_uint(s.sv[0]) : kNoMember,
                                     have > 0 ? s.sc[0] : INT_MAX, best);
    if (best == kNoMember) return j;
    emit(j, best, bc);
    if (have > 0 && s.sc[0] == bc) {  // pop this lane's head
      last_d = s.sv[0];
      last_c = bc;
#pragma unroll
      for (int t = 0; t + 1 < Depth; ++t) {
        s.sv[t] = s.sv[t + 1];
        s.sc[t] = s.sc[t + 1];
      }
      s.sv[Depth - 1] = CUDART_INF_F;
      s.sc[Depth - 1] = INT_MAX;
      --have;
    }
  }
  return K;
}

// G centroids a warp, W / S groups of S warps a block, the S warps of a
// group sharing its G centroids, each scanning every S-th 32-point chunk
// (S > 1 needs K <= 32). The scan is the flat kernel's. Registers (nvcc
// 12.8, sm_90a, -Xptxas -v; chip_smoke.py prints them): two blocks of 16
// warps an SM allow 64, which G = 2 takes at depth 4 with no spill (at
// depth 5 12 bytes spill, hence stacks 4 deep); G = 1 52. With no minimum
// of blocks ptxas spilled G = 1 to 40 registers (three blocks); with a
// minimum of one, G = 2 took 69-71 and one block an SM, which made
// PointNeXt's nine queries 1.5x the flat kernel's time against 1.34x.
template <int G, int Depth>
__launch_bounds__(kMaxFlatWarps * 32, 2)
__global__ void ball_query_two_level_kernel(const float* __restrict__ centroids,
                                            const float* __restrict__ coords,
                                            const bool* __restrict__ mask,
                                            int* __restrict__ out_idx,
                                            bool* __restrict__ out_in_ball, int C, int N, int K,
                                            float r2, int repeat, int S) {
  extern __shared__ float4 smem[];
  float4* tile = smem;
  int2* lists = reinterpret_cast<int2*>(tile + kFlatTile);  // [warp][g][32], S > 1
  int* counts = reinterpret_cast<int*>(lists + (blockDim.x >> 5) * G * 32);  // [warp][g]

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = warp % S;
  const int c0 = (blockIdx.x * (blockDim.x >> 5) / S + warp / S) * G;

  Stack<Depth> s[G];
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
#pragma unroll
    for (int t = 0; t < Depth; ++t) {
      s[g].sv[t] = CUDART_INF_F;
      s[g].sc[t] = INT_MAX;
    }
  }

  // level 1: the flat kernel's scan, members into the lanes' stacks
  const float* pts = coords + static_cast<size_t>(b) * N * 3;
  const bool* valid = mask ? mask + static_cast<size_t>(b) * N : nullptr;
  for (int base = 0; base < N; base += kFlatTile) {
    const int n = min(kFlatTile, N - base);
    const int chunks = (n + 31) >> 5;
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < chunks * 32; t += blockDim.x)
      tile[t] = t < n ? load_point(pts, valid, base + t)
                      : make_float4(0.f, 0.f, 0.f, CUDART_NAN_F);
    __syncthreads();

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
      for (int g = 0; g < G; ++g) {  // a lane's columns in ascending order
        if (raw0[g] <= s[g].lim) push(s[g], raw0[g], idx);
        if (raw1[g] <= s[g].lim) push(s[g], raw1[g], idx + 32 * S);
      }
    }
  }

  const size_t row = (static_cast<size_t>(b) * C + c0) * K;  // the first centroid's slots
  const float4* const whole = N <= kFlatTile ? tile : nullptr;  // the tile holds the cloud
  if (S == 1) {
    // level 2: the rounds write the members in order, 32 slots a store
    // (round j's column waits in lane j % 32); then the fillers
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (c0 + g >= C) break;
      int* const idx_out = out_idx + row + g * K;
      bool* const in_out = out_in_ball + row + g * K;
      int picked = INT_MAX, first = 0;
      const int m = rounds(s[g], whole, pts, valid, N, 1, 0, r2, K, [&](int j, unsigned, int col) {
        if (j == 0) first = col;
        if (lane == (j & 31)) picked = col;
        if ((j & 31) == 31) {
          idx_out[(j & ~31) + lane] = picked;
          in_out[(j & ~31) + lane] = true;
        }
      });
      if ((m & 31) != 0 && lane < (m & 31)) {
        idx_out[(m & ~31) + lane] = picked;
        in_out[(m & ~31) + lane] = true;
      }
      if (m == K) continue;
      // slot m + j takes the j-th lowest column outside the ball: under
      // the repeat filler slot 0's member (column 0 when the ball has
      // none); with fewer than 32 members, counted by stepping over their
      // sorted columns (all in the lanes), as the flat kernel does; else by
      // a ballot over the cloud's lowest columns
      if (repeat || m < 32) {
        int member = lane < m ? picked : INT_MAX;
        if (!repeat) sort32(member);
        for (int j0 = m; j0 < K; j0 += 32) {  // uniform across the warp: it shuffles
          int f = first;
          if (!repeat) {
            f = j0 + lane - m;
            for (int t = 0; t < m; ++t) f += __shfl_sync(kFull, member, t) <= f;
          }
          if (j0 + lane < K) {
            idx_out[j0 + lane] = f;
            in_out[j0 + lane] = false;
          }
        }
        continue;
      }
      int filled = 0;
      for (int base = 0; filled < K - m; base += 32) {
        const int col = base + lane;
        bool outside = false;
        if (col < N) {
          const float4 p = whole ? whole[col] : load_point(pts, valid, col);
          outside = !(gram_sqdist(s[g].qx, s[g].qy, s[g].qz, s[g].q2, p.x, p.y, p.z, p.w) <= r2);
        }
        const unsigned bits = __ballot_sync(kFull, outside);
        const int slot = m + filled + __popc(bits & ((1u << lane) - 1u));
        if (outside && slot < K) {
          idx_out[slot] = col;
          in_out[slot] = false;
        }
        filled += __popc(bits);
      }
    }
    return;
  }

  // S > 1 (K <= 32): each warp's rounds list its first K members, lane j
  // holding round j; the group's first warp merges the S sorted lists as
  // the flat kernel does, and writes the ball as it does.
  Ball merged[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float kd = CUDART_INF_F;
    int ki = INT_MAX;
    const int m = rounds(s[g], whole, pts, valid, N, S, slice, r2, K,
                         [&](int j, unsigned key, int col) {
                           if (lane == j) {
                             kd = __uint_as_float(key);
                             ki = col;
                           }
                         });
    lists[(warp * G + g) * 32 + lane] = make_int2(__float_as_int(kd), ki);
    if (lane == 0) counts[warp * G + g] = m;
    merged[g].kd = kd;
    merged[g].ki = ki;
    merged[g].count = m;
  }
  __syncthreads();
  if (slice != 0) return;
  for (int o = 1; o < S; ++o) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int2 e = lists[((warp + o) * G + g) * 32 + 31 - lane];
      if (before(__int_as_float(e.x), e.y, merged[g].kd, merged[g].ki)) {
        merged[g].kd = __int_as_float(e.x);
        merged[g].ki = e.y;
      }
      merge32(merged[g].kd, merged[g].ki);
      merged[g].count += counts[(warp + o) * G + g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (c0 + g >= C) break;
    write_ball(merged[g], out_idx + row + g * K, out_in_ball + row + g * K, K, repeat);
  }
}

// Centroids a warp (G), warps a block (W) and warps a centroid (S) of
// kernel 6, from chip_smoke.py's sweep (NVIDIA H100 80GB HBM3, 700 W): a
// warp scans at most 4096 points, as in pick_flat, but with at most 8
// warps a ball, whose lists the first merges ((1, 1024, 65536): 98 us at
// (2, 16, 8), 123-161 at (4, 16, 16)); fewer than 1024 balls (the deep
// stages, latency-bound) take two warps a ball, each with half the rounds
// ((8, 16, 64): 5.0 us against 7.0-7.4 at one); at most two balls a warp,
// whose stacks leave room for two blocks of 16 warps an SM ((8, 1024,
// 4096): 31.9-33.0 us at (2, 16, 1), 34.5-40.3 at (4, 16, 1)). One warp a
// ball when K > 32. The result depends on none of them.
void pick_two_level(int B, int C, int N, int K, int& G, int& W, int& S) {
  const long long balls = static_cast<long long>(B) * C;
  S = 1;
  if (K <= 32) {
    while (S < 8 && N / S > 4096) S <<= 1;
    if (S == 1 && balls < 1024 && N > 32) S = 2;
  }
  const long long wanted = S > 1 ? 4096 : 2048;
  G = 2;
  while (G > 1 && balls / G * S < wanted) G >>= 1;
  W = G == 2 ? 16 : 8;
}

template <int G, int Depth>
int launch_two_level(const void* centroids, const void* coords, const void* mask, void* out_idx,
                     void* out_in_ball, int B, int C, int N, int K, float r2, int repeat, int W,
                     int S, cudaStream_t stream) {
  const int per_block = W / S * G;
  const size_t smem = kFlatTile * sizeof(float4) + W * G * (32 * sizeof(int2) + sizeof(int));
  const dim3 grid((C + per_block - 1) / per_block, B);
  ball_query_two_level_kernel<G, Depth><<<grid, W * 32, smem, stream>>>(
      static_cast<const float*>(centroids), static_cast<const float*>(coords),
      static_cast<const bool*>(mask), static_cast<int*>(out_idx),
      static_cast<bool*>(out_in_ball), C, N, K, r2, repeat, S);
  return static_cast<int>(cudaGetLastError());
}

template <int Depth>
int launch_two_level_groups(int G, const void* centroids, const void* coords, const void* mask,
                            void* out_idx, void* out_in_ball, int B, int C, int N, int K,
                            float r2, int repeat, int W, int S, cudaStream_t stream) {
  switch (G) {
    case 1:
      return launch_two_level<1, Depth>(centroids, coords, mask, out_idx, out_in_ball, B, C, N, K,
                                        r2, repeat, W, S, stream);
    case 2:
      return launch_two_level<2, Depth>(centroids, coords, mask, out_idx, out_in_ball, B, C, N, K,
                                        r2, repeat, W, S, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
// of `depth` members (4 in use, 1 to force refills in tests); any K
// <= N. `groups` (1 or 2), `warps` and `slices` force the split as for
// pointseg_ball_query (slices > 1 needs K <= 32); 0 lets pick_two_level
// choose.
extern "C" int pointseg_ball_query_2l(const void* centroids, const void* coords,
                                      const void* mask, void* out_idx, void* out_in_ball,
                                      int B, int C, int N, int K, float r2, int depth,
                                      int repeat, int groups, int warps, int slices, int device,
                                      void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  int G, W, S;
  pick_two_level(B, C, N, K, G, W, S);
  G = groups ? groups : G;
  W = warps ? warps : W;
  S = slices ? slices : S;
  if (W < 1 || W > kMaxFlatWarps || S < 1 || (S & (S - 1)) || W % S || W * G > kMaxFlatLists ||
      (S > 1 && K > 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1:
      return launch_two_level_groups<1>(G, centroids, coords, mask, out_idx, out_in_ball, B,
                                          C, N, K, r2, repeat, W, S, s);
    case 4:
      return launch_two_level_groups<4>(G, centroids, coords, mask, out_idx, out_in_ball, B,
                                          C, N, K, r2, repeat, W, S, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
