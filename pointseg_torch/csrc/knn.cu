// k nearest neighbours in feature space, two selection schemes over one
// exact score.
//
// Replaces pointseg/ops/pallas/knn.py::knn_indices_pallas (`_knn_kernel`,
// here `knn_flat_kernel`) and ::knn_indices_pallas_2l (`_knn_kernel_2l`
// with pointseg/ops/pallas/select2l.py::two_level_extract, here
// `knn_two_level_kernel`). Same result for both: for every row i of
// x (B, N, F) the k columns j with the largest score
//     s_ij = (2 * <x_i, x_j> - |x_i|^2) - |x_j|^2        (= -d^2)
// in (score descending, column ascending) order, the row itself included.
// Two options of the Pallas kernels' caller are built in here: a (B, N)
// mask whose false columns are never neighbours, and the exclusion of the
// row itself. An excluded column scores -inf, so it stays behind every
// finite score and, when a row has fewer than k columns left, fills the
// tail of its list in ascending column order, as a stable sort would.
// The Pallas kernels form the (TILE, N) score block with one matrix
// product and keep it in VMEM; here no score is ever stored. Every term
// is written with __fmul_rn / __fadd_rn and the F products are summed in
// ascending feature order, so the plain PyTorch version
// (`knn_indices_plain`), which does the same term by term, gives the
// same bits and therefore the same selection. (The flat kernel starts
// its sum from +0 where the plain version starts from the first product;
// that can only turn a -0 into a +0, which no comparison tells apart.)
// A NaN score (a diverged activation) is taken as -inf, so every column
// stays comparable and every slot written is a column in [0, N).
//
// What bounds it on the H100: operations. 2*B*N*N*F flops (17.2 GFLOP at
// B=8, N=4096, F=64) against 8 MB of input that stays in L2. The order
// of the sum is fixed and each product is rounded, so there is no fused
// multiply-add and no tensor core: a product costs two float32
// instructions, and the floor of an exact kernel is those 2*B*N*N*F
// instructions over 132 SMs x 128 lanes, about 0.6 ms at that shape,
// twice the bound that the card's FMA rate gives.
//
// Kernel 4 (flat selection), what the design does about it. The float32
// pipes are only the limit if nothing else is in their way, and in a
// kernel that scores one query row a warp three things are: a
// shared-memory load for nearly every product, the whole cloud streamed
// from L2 into every block, and no load in flight while a block scores.
// - A register tile. A warp scores kRows = 8 query rows against a tile of
//   128 candidates, each lane holding 8 x 4 running sums: a candidate
//   value read from shared memory feeds 8 products and a query value 4.
//   (Four or two rows a warp when the batch is too small to fill the card
//   with blocks of 64 rows: `pointseg_knn` chooses.)
//   The warp's query rows lie feature-major, so the 8 values of one
//   feature are two 16-byte broadcast loads. That is 6 load
//   instructions for 32 products (3 with the 16-byte candidate loads
//   below) where one row a warp needs 5 for 4. A block of 8 warps covers
//   64 rows a tile, so a cloud streams from L2 once per 64 rows, not
//   once per 8.
// - Candidate-major tiles, 16-byte loads. A row of the cloud goes to
//   shared memory as it lies (no transposition, no division); when F is a
//   multiple of 4 and x is 16-byte aligned a lane reads four features of
//   its candidate at once and adds their products in order. The row
//   stride is the chunk width padded to an odd number of 16-byte units
//   (64 -> 68 floats), which keeps the 8 lanes of a quarter-warp on
//   distinct banks. Any other F (xyz: F = 3) takes 4-byte copies and
//   loads and an odd stride.
// - Copies in flight. Features go through shared memory in chunks of at
//   most 64, so the tile's size does not grow with F and the sums stay
//   in registers from chunk to chunk; `cp.async` fills one of two
//   buffers with chunk s + 1 while the block scores chunk s, one barrier
//   a chunk. The candidates' squared norms travel with the tile; a
//   masked candidate's is +inf (written so by the norms kernel, a small
//   kernel of its own, once per call), hence its score -inf. A query
//   row's own norm is summed in the block from the staged row.
// - Selection as before, one list per query row: the running top-k sits
//   one slot per lane (lane j holds the j-th best), candidates are
//   offered in ascending column order and enter only on a strictly
//   larger score, so equal scores keep the lower column in front. Each
//   row's k-th best score is kept in a register, so a tile of 128
//   candidates none of which beats it costs one vote. k <= 32.
// Registers, occupancy and where the time goes: see the note at
// `knn_flat_kernel`.
//
// Two-level selection (kernel 5) scores exactly as kernel 4 does (the
// same register tile of kRows query rows a warp, the same cp.async
// tiles, the same bits), with the query rows staged a 64-feature chunk at
// a time beside the candidates, so that no shared-memory size grows with
// F and any F is taken. Lane l scores the columns {32 i + l}, the strided
// ownership of the Pallas design, so the first level needs no traffic
// between lanes: per row, each lane keeps a sorted stack of its best
// `Depth` columns in registers; a candidate that is not strictly in front
// of a full stack's last entry costs one compare, and one vote a row and
// tile skips the stacks of a tile that none of the 32 lanes enters. Then,
// per row, K rounds take the first lane head across the warp (two
// `redux.sync`: score as an ordered key, then the lowest column), write it
// to `out` (32 rounds a store) and pop it. A lane whose stack ran dry while
// it has columns left is refilled: the warp rescans that lane's N/32
// columns for its best Depth behind the last consumed, summing each score
// in the same order from the same +0, so it gets the level-1 bits. K is
// bounded by N only; the result never depends on Depth or kRows, only
// the time.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"

namespace {

constexpr int kWarps = 8;    // warps per block, both kernels
constexpr int kTile = 128;   // candidates per shared-memory tile, both kernels
constexpr int kPerLane = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

// |x_r|^2 with the products summed in ascending feature order; +inf for a
// row that `mask` (one byte a row, or null) excludes.
__global__ void row_sqnorm_kernel(const float* __restrict__ x,
                                  const unsigned char* __restrict__ mask,
                                  float* __restrict__ out, long long rows, int F) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + r * F;
  float acc = __fmul_rn(p[0], p[0]);
  for (int f = 1; f < F; ++f) acc = __fadd_rn(acc, __fmul_rn(p[f], p[f]));
  out[r] = (mask == nullptr || mask[r]) ? acc : CUDART_INF_F;
}

// The score from its three parts, each step rounded.
__device__ __forceinline__ float raw_score(float dot, float q2, float c2) {
  return __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), q2), c2);
}

// A NaN score counts as -inf, like an excluded column: the selections
// below compare with > and ==, which a NaN would slip through.
__device__ __forceinline__ float nan_last(float s) { return s == s ? s : -CUDART_INF_F; }

__device__ __forceinline__ float finish_score(float dot, float q2, float c2) {
  return nan_last(raw_score(dot, q2, c2));
}

// ---------------------------------------------------------------- kernel 4

constexpr int kChunk = 64;       // features per shared-memory stage
constexpr int kMinBlocks = 256;  // about two blocks for each of the H100's 132 SMs

// Row stride, in floats, of a candidate-major tile of `F`-wide rows cut
// into chunks of kChunk features. 16-byte loads want an odd number of
// 16-byte units a row, 4-byte loads an odd number of words: either keeps
// the lanes that load together on distinct banks.
inline int flat_stride(int F, bool vec) {
  const int chunk = F < kChunk ? F : kChunk;
  if (!vec) return chunk | 1;
  return (chunk / 4) % 2 == 0 ? chunk + 4 : chunk;
}

// Shared memory of one block of `rows` query rows, in floats: the query
// rows (per warp, feature-major: kRows values a feature), their squared
// norms, two buffers of candidate norms and two candidate tiles.
inline size_t flat_smem_bytes(int rows, int F, int stride) {
  return (static_cast<size_t>(rows) * F + rows + 2 * kTile +
          2 * static_cast<size_t>(kTile) * stride) * sizeof(float);
}

// Kernel 5's: one or two buffers of a 64-feature chunk of the query rows
// (the rows' norms stay in registers), two buffers of candidate norms and
// two candidate tiles. At most 2 x 32 x 64 + 256 + 2 x 128 x 68 floats
// (87,040 bytes at four rows a warp), whatever F.
inline size_t two_level_smem_bytes(int rows, int F, int stride) {
  const int buffers = F > kChunk ? 2 : 1;
  return (static_cast<size_t>(buffers) * rows * kChunk + 2 * kTile +
          2 * static_cast<size_t>(kTile) * stride) * sizeof(float);
}

// Query rows a warp of kernel 5: four, or two when four leave fewer than
// kMinBlocks blocks (a small batch or cloud), as kernel 4 chooses its
// own. Eight measured slower: their stacks leave room for one block an SM.
inline int two_level_rows(int B, int N) {
  const long long blocks = static_cast<long long>(B) * ((N + kWarps * 4 - 1) / (kWarps * 4));
  return blocks >= kMinBlocks ? 4 : 2;
}

// `bytes` (16 or 4) from global to shared memory without passing through
// registers; with `valid` false the destination is zero-filled and the
// source is not read.
__device__ __forceinline__ void copy_async_16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void copy_async_4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One feature: the products of the warp's kRows query values (at `qf`,
// 4 * kRows bytes aligned; a broadcast load) with this lane's kPerLane
// candidate values, each rounded and added.
template <int kRows>
__device__ __forceinline__ void add_products(float (&acc)[kRows][kPerLane], const float* qf,
                                             const float (&c)[kPerLane]) {
  static_assert(kRows == 8 || kRows == 4 || kRows == 2, "query rows per warp");
  float q[kRows];
  if constexpr (kRows == 2) {
    const float2 a = *reinterpret_cast<const float2*>(qf);
    q[0] = a.x, q[1] = a.y;
  } else {
#pragma unroll
    for (int h = 0; h < kRows / 4; ++h) {
      const float4 a = reinterpret_cast<const float4*>(qf)[h];
      q[4 * h] = a.x, q[4 * h + 1] = a.y, q[4 * h + 2] = a.z, q[4 * h + 3] = a.w;
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[r][j] = __fadd_rn(acc[r][j], __fmul_rn(q[r], c[j]));
  }
}

// Offers the 32 candidates `first` .. `first` + 31 (this lane's: `first` +
// lane, with score `s`: -inf past the end of the cloud, possibly NaN) to
// one query row's list: lane j holds the j-th best as (list_v, list_i),
// and `kth` is the score in slot K - 1 once the list is full. A list is
// full after the cloud's first K columns, whatever they score, so the
// number of filled slots needs no register: it is min(K, columns seen).
// `kth` only decides which lanes are worth a turn and is refreshed once,
// after the group: a candidate that beat the k-th best of the group's
// start but not the current one finds its place at slot K or behind,
// where nothing is read. That keeps the refresh, a shuffle, out of the
// chain from one insertion to the next (compare, ballot, shift).
__device__ __forceinline__ void offer(float s, int first, int K, float& list_v, int& list_i,
                                      float& kth) {
  const int lane = threadIdx.x & 31;
  unsigned pending = __ballot_sync(kFull, first + lane < K || s > kth);
  if (pending == 0) return;
  do {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float cv = nan_last(__shfl_sync(kFull, s, src));
    // the first slot that is free or holds a smaller score (a tie keeps
    // the lower, listed column in front); none: pos is -1, above every lane
    const unsigned behind = __ballot_sync(kFull, lane >= min(K, first + src) || list_v < cv);
    const unsigned pos = static_cast<unsigned>(__ffs(behind) - 1);
    const float up_v = __shfl_up_sync(kFull, list_v, 1);
    const int up_i = __shfl_up_sync(kFull, list_i, 1);
    if (lane > pos) {
      list_v = up_v;
      list_i = up_i;
    } else if (lane == pos) {
      list_v = cv;
      list_i = first + src;
    }
  } while (pending);
  kth = __shfl_sync(kFull, list_v, K - 1);
}

// Registers and occupancy (nvcc 12.x, sm_90a, -Xptxas -v; no variant
// spills). Eight rows a warp: 122 registers a thread on the 16-byte path,
// 108 on the 4-byte path (32 running sums, 16 candidate values, 8 query
// values, 24 for the eight lists and their k-th scores), so two blocks
// of 256 threads an SM, 16 warps of 64. Shared memory allows the same
// two at F = 64 (87 KB a block). Four rows: 78-80 registers, three
// blocks; two rows: 64, four blocks. The running sums give each warp 32
// independent chains, so 4 warps a scheduler keep the float32 pipe fed.
//
// Where the time goes at (8, 4096, 64), k = 20 on an H100 (1980 MHz under
// this load): 1.09 ms a launch on the device against a floor of 0.51 ms.
// With k = 1, when a row's list takes a handful of insertions, the same
// launch takes 0.85 ms: that is the score pass and the votes. 94% of
// the score pass's instructions are the products and sums, running at
// some two thirds of the pipe's rate; the rest is the barrier a chunk,
// the copies' address arithmetic, the staging of the query rows and a
// second wave of blocks that fills 94% of the card. The insertions of
// k = 20 add 0.25 ms and cannot hide behind the score pass: both are
// bound by the rate at which the same four schedulers start
// instructions. A row takes about 126 of them (k ln(N / k) and the
// first k), some 24 instructions each.
template <bool kVec, int kRows>
__launch_bounds__(kWarps * 32, kRows == 8 ? 2 : kRows == 4 ? 3 : 4)
__global__ void knn_flat_kernel(const float* __restrict__ x, const float* __restrict__ norms,
                                int* __restrict__ out, int N, int F, int K, int include_self,
                                int stride) {
  constexpr int kBlockRows = kWarps * kRows;
  extern __shared__ float4 smem_aligned[];
  float* const qs = reinterpret_cast<float*>(smem_aligned);
  float* const q2s = qs + kBlockRows * F;
  float* const c2s = q2s + kBlockRows;
  float* const tiles = c2s + 2 * kTile;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlockRows + warp * kRows;  // this warp's first query row
  const float* cloud = x + static_cast<size_t>(b) * N * F;
  const float* cloud_norms = norms + static_cast<size_t>(b) * N;  // +inf where masked out

  // Loads chunk `c` (features c * kChunk ...) of candidate tile `t` into
  // buffer `buf`, and with a tile's first chunk its squared norms. Half a
  // warp copies one row; rows past the end of the cloud are zero-filled.
  auto load_chunk = [&](int t, int c, int buf) {
    const int base = t * kTile, f0 = c * kChunk;
    const int width = min(kChunk, F - f0), n = min(kTile, N - base);
    float* dst = tiles + static_cast<size_t>(buf) * kTile * stride;
    const int half = threadIdx.x >> 4, l16 = threadIdx.x & 15;
    for (int i = half; i < kTile; i += 2 * kWarps) {
      const bool valid = i < n;
      const float* src = cloud + static_cast<size_t>(valid ? base + i : 0) * F + f0;
      if (kVec) {
        for (int v = 4 * l16; v < width; v += 64)
          copy_async_16(dst + i * stride + v, src + v, valid);
      } else {
        for (int v = l16; v < width; v += 16) copy_async_4(dst + i * stride + v, src + v, valid);
      }
    }
    if (c == 0 && threadIdx.x < kTile) {
      const bool valid = static_cast<int>(threadIdx.x) < n;
      copy_async_4(c2s + (t & 1) * kTile + threadIdx.x,
                   cloud_norms + (valid ? base + threadIdx.x : 0), valid);
    }
    copy_async_commit();
  };

  const int tiles_n = (N + kTile - 1) / kTile, chunks = (F + kChunk - 1) / kChunk;
  load_chunk(0, 0, 0);

  // this warp's query rows, feature-major (zeros past the last row, so
  // their arithmetic stays finite), and their squared norms
  float* const q = qs + static_cast<size_t>(warp) * F * kRows;
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    for (int f = lane; f < F; f += 32)
      q[f * kRows + r] = row < N ? cloud[static_cast<size_t>(row) * F + f] : 0.f;
  }
  __syncwarp();
  if (lane < kRows) {
    float acc = __fmul_rn(q[lane], q[lane]);
    for (int f = 1; f < F; ++f)
      acc = __fadd_rn(acc, __fmul_rn(q[f * kRows + lane], q[f * kRows + lane]));
    q2s[warp * kRows + lane] = acc;
  }
  __syncwarp();

  float list_v[kRows], kth[kRows];
  int list_i[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    list_v[r] = -CUDART_INF_F;
    kth[r] = -CUDART_INF_F;
    list_i[r] = INT_MAX;
  }

  const bool scoring = row0 < N;  // uniform across the warp
  int stage = 0;
  for (int t = 0; t < tiles_n; ++t) {
    float acc[kRows][kPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[r][j] = 0.f;
    }

    for (int c = 0; c < chunks; ++c, ++stage) {
      // this chunk has landed for every thread, and every thread is done
      // with the buffer the next chunk goes to
      copy_async_wait_all();
      __syncthreads();
      if (c + 1 < chunks) {
        load_chunk(t, c + 1, (stage + 1) & 1);
      } else if (t + 1 < tiles_n) {
        load_chunk(t + 1, 0, (stage + 1) & 1);
      }
      if (!scoring) continue;

      const int width = min(kChunk, F - c * kChunk);
      const float* cand = tiles + static_cast<size_t>(stage & 1) * kTile * stride + lane * stride;
      const float* qc = q + c * kChunk * kRows;
      if (kVec) {
        for (int g = 0; g < width; g += 4) {
          float4 c4[kPerLane];
#pragma unroll
          for (int j = 0; j < kPerLane; ++j)
            c4[j] = *reinterpret_cast<const float4*>(cand + 32 * j * stride + g);
          const float cx[kPerLane] = {c4[0].x, c4[1].x, c4[2].x, c4[3].x};
          const float cy[kPerLane] = {c4[0].y, c4[1].y, c4[2].y, c4[3].y};
          const float cz[kPerLane] = {c4[0].z, c4[1].z, c4[2].z, c4[3].z};
          const float cw[kPerLane] = {c4[0].w, c4[1].w, c4[2].w, c4[3].w};
          add_products<kRows>(acc, qc + g * kRows, cx);
          add_products<kRows>(acc, qc + (g + 1) * kRows, cy);
          add_products<kRows>(acc, qc + (g + 2) * kRows, cz);
          add_products<kRows>(acc, qc + (g + 3) * kRows, cw);
        }
      } else {
        for (int g = 0; g < width; ++g) {
          float c1[kPerLane];
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) c1[j] = cand[32 * j * stride + g];
          add_products<kRows>(acc, qc + g * kRows, c1);
        }
      }
    }
    if (!scoring) continue;

    // the tile's scores are complete: offer them, row by row
    const int base = t * kTile, n = min(kTile, N - base);
    float c2[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) c2[j] = c2s[(t & 1) * kTile + 32 * j + lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row >= N) continue;  // uniform across the warp
      const float q2 = q2s[warp * kRows + r];
      float s[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) s[j] = raw_score(acc[r][j], q2, c2[j]);
      const int self = row - base;  // the row's own place in the tile, if it has one
      if (!include_self && static_cast<unsigned>(self) < kTile) {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          if (32 * j + lane == self) s[j] = -CUDART_INF_F;
      }
      if (n < kTile) {  // the cloud's last tile: nothing past its end enters
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          if (32 * j + lane >= n) s[j] = -CUDART_INF_F;
      }
      // past the first tile the list is full, and most tiles hold nothing
      // that beats its k-th best: one vote for the tile's 128 scores
      bool beats = false;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) beats = beats || s[j] > kth[r];
      if (t > 0 && !__any_sync(kFull, beats)) continue;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (32 * j < n) offer(s[j], base + 32 * j, K, list_v[r], list_i[r], kth[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row < N && lane < K) out[(static_cast<size_t>(b) * N + row) * K + lane] = list_i[r];
  }
}

// ---------------------------------------------------------------- kernel 5

// A score (never NaN here) as an unsigned key in the same order, -0 and +0
// as one key; 0 is below every score's key and stands for "no offer".
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// (score desc, column asc): is (v, c) in front of (bv, bc)?
__device__ __forceinline__ bool in_front(float v, int c, float bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

// The warp's first (score desc, column asc) of one (key, column) a lane:
// two reductions, key then column among the lanes that hold the key.
__device__ __forceinline__ int warp_first_column(unsigned key, int col, unsigned& best) {
  best = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == best ? col : INT_MAX);
}

// Refills lane l's empty stack (`sv`, `sc`, written in lane l only) with
// its best Depth columns behind (lv, lc) in (score desc, column asc)
// order, among its columns {32 i + l}; returns how many it found (0: none
// is left), the same in every lane. Lane t of the warp scores the columns
// 32 (t + 32 m) + l, each product rounded and added in ascending feature
// order from +0, as the score pass does, so that a column scores the same
// bits here and there and "behind the last one consumed" neither skips
// nor repeats one; it keeps its own best Depth of them, and Depth rounds
// across the warp hand them to lane l in order. The query row goes
// through `qw` (this warp's own 64 floats of shared memory) a chunk at a
// time. A whole stack, not one entry: a lane that holds many of a row's
// neighbours (the copies of a repeated point share a lane) rescans once
// per Depth picks, not once a pick.
template <bool kVec, int Depth>
__device__ __forceinline__ int rescan(const float* cloud, const float* cloud_norms, float* qw,
                                      int row, int N, int F, float q2, int self, int l, float lv,
                                      int lc, float (&sv)[Depth], int (&sc)[Depth]) {
  const int lane = threadIdx.x & 31;
  const float* query = cloud + static_cast<size_t>(row) * F;
  const int chunks = (F + kChunk - 1) / kChunk;
  const auto stage = [&](int c) {
    const int f0 = c * kChunk, width = min(kChunk, F - f0);
    __syncwarp();  // the previous chunk is no longer read
    for (int f = lane; f < width; f += 32) qw[f] = query[f0 + f];
    __syncwarp();
  };
  if (chunks == 1) stage(0);
  float tv[Depth];  // this lane's best Depth behind (lv, lc), sorted
  int tc[Depth];
#pragma unroll
  for (int d = 0; d < Depth; ++d) {
    tv[d] = -CUDART_INF_F;
    tc[d] = INT_MAX;
  }
  for (int m = 0; 32 * 32 * m + l < N; ++m) {  // uniform across the warp
    const int col = 32 * (lane + 32 * m) + l;
    const bool valid = col < N;
    const float* cand = cloud + static_cast<size_t>(valid ? col : 0) * F;
    float dot = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (chunks > 1) stage(c);
      const int f0 = c * kChunk, width = min(kChunk, F - f0);
      if (!valid) continue;
      if (kVec) {
        for (int g = 0; g < width; g += 4) {
          const float4 v = *reinterpret_cast<const float4*>(cand + f0 + g);
          dot = __fadd_rn(dot, __fmul_rn(qw[g], v.x));
          dot = __fadd_rn(dot, __fmul_rn(qw[g + 1], v.y));
          dot = __fadd_rn(dot, __fmul_rn(qw[g + 2], v.z));
          dot = __fadd_rn(dot, __fmul_rn(qw[g + 3], v.w));
        }
      } else {
        for (int g = 0; g < width; ++g) dot = __fadd_rn(dot, __fmul_rn(qw[g], cand[f0 + g]));
      }
    }
    if (!valid) continue;
    float v = finish_score(dot, q2, cloud_norms[col]);
    if (col == self) v = -CUDART_INF_F;
    const bool behind_last = lc < 0 || v < lv || (v == lv && col > lc);
    if (!behind_last || !in_front(v, col, tv[Depth - 1], tc[Depth - 1])) continue;
#pragma unroll
    for (int d = Depth - 1; d >= 0; --d) {  // deepest first: each step reads old levels
      if (d > 0 && in_front(v, col, tv[d - 1], tc[d - 1])) {
        tv[d] = tv[d - 1];
        tc[d] = tc[d - 1];
      } else if (in_front(v, col, tv[d], tc[d])) {
        tv[d] = v;
        tc[d] = col;
      }
    }
  }
  int found = 0;
#pragma unroll
  for (int d = 0; d < Depth; ++d) {
    unsigned best;
    const int bc = warp_first_column(tc[0] == INT_MAX ? 0u : score_key(tv[0]), tc[0], best);
    if (bc == INT_MAX) break;  // uniform across the warp
    if (lane == l) {
      sv[d] = key_score(best);
      sc[d] = bc;
    }
    if (tc[0] == bc) {  // hand over this lane's head
#pragma unroll
      for (int e = 0; e + 1 < Depth; ++e) {
        tv[e] = tv[e + 1];
        tc[e] = tc[e + 1];
      }
      tv[Depth - 1] = -CUDART_INF_F;
      tc[Depth - 1] = INT_MAX;
    }
    ++found;
  }
  return found;
}

// Registers (nvcc 12.8, sm_90a, -Xptxas -v; chip_smoke.py prints them for
// every instance): kRows rows a warp hold kRows x 4 running sums and
// kRows stacks of Depth (score, column) pairs, 2 x kRows x Depth
// registers, beside kernel 4's 16 candidate and kRows query values. Two
// blocks of 8 warps an SM allow 128: four rows take 128 at depth 4, and
// at depth 5 (k > 20) spill 4 bytes on the 16-byte path (144 without the
// bound). Both spill-free choices measured slower at k = 33-64: depth 4
// (more refills) and two rows a warp at depth 5 (less reuse of a tile);
// the spill lies off the score loop. Eight rows (166 at depth 4) would
// leave one block an SM.
template <bool kVec, int kRows, int Depth>
__launch_bounds__(kWarps * 32, 2)
__global__ void knn_two_level_kernel(const float* __restrict__ x, const float* __restrict__ norms,
                                     int* __restrict__ out, int N, int F, int K, int include_self,
                                     int stride) {
  constexpr int kBlockRows = kWarps * kRows;
  extern __shared__ float4 smem_aligned[];
  const int chunks = (F + kChunk - 1) / kChunk;
  // one buffer of query chunks when the rows are one chunk wide (loaded
  // once), two (double-buffered with the tiles) otherwise
  float* const qs = reinterpret_cast<float*>(smem_aligned);
  float* const c2s = qs + (chunks > 1 ? 2 : 1) * kBlockRows * kChunk;
  float* const tiles = c2s + 2 * kTile;

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kBlockRows + warp * kRows;  // this warp's first query row
  const float* cloud = x + static_cast<size_t>(b) * N * F;
  const float* cloud_norms = norms + static_cast<size_t>(b) * N;  // +inf where masked out

  // Chunk `c` of candidate tile `t` (and its norms with the first chunk)
  // into buffer `buf`, as kernel 4 loads it; with it chunk `c` of the
  // block's query rows, each warp's feature-major (kRows values a
  // feature), zeros past the last row. A one-chunk query is loaded once.
  auto load_chunk = [&](int t, int c, int buf) {
    const int base = t * kTile, f0 = c * kChunk;
    const int width = min(kChunk, F - f0), n = min(kTile, N - base);
    float* dst = tiles + static_cast<size_t>(buf) * kTile * stride;
    const int half = threadIdx.x >> 4, l16 = threadIdx.x & 15;
    for (int i = half; i < kTile; i += 2 * kWarps) {
      const bool valid = i < n;
      const float* src = cloud + static_cast<size_t>(valid ? base + i : 0) * F + f0;
      if (kVec) {
        for (int v = 4 * l16; v < width; v += 64)
          copy_async_16(dst + i * stride + v, src + v, valid);
      } else {
        for (int v = l16; v < width; v += 16) copy_async_4(dst + i * stride + v, src + v, valid);
      }
    }
    if (c == 0 && threadIdx.x < kTile) {
      const bool valid = static_cast<int>(threadIdx.x) < n;
      copy_async_4(c2s + (t & 1) * kTile + threadIdx.x,
                   cloud_norms + (valid ? base + threadIdx.x : 0), valid);
    }
    if (chunks > 1 || t == 0) {
      float* qdst = qs + (chunks > 1 ? buf : 0) * kBlockRows * kChunk;
      for (int e = threadIdx.x; e < kBlockRows * width; e += blockDim.x) {
        const int rr = e / width, f = e - rr * width;  // block row, feature
        const int row = blockIdx.x * kBlockRows + rr;
        const bool valid = row < N;
        copy_async_4(qdst + (rr / kRows) * kRows * kChunk + f * kRows + rr % kRows,
                     cloud + static_cast<size_t>(valid ? row : 0) * F + f0 + f, valid);
      }
    }
    copy_async_commit();
  };

  const int tiles_n = (N + kTile - 1) / kTile;
  load_chunk(0, 0, 0);

  // level 1: per row, this lane's top Depth of its columns {32 i + lane}
  // by (score desc, column asc), sorted; an empty slot is (-inf, INT_MAX)
  float sv[kRows][Depth];
  int sc[kRows][Depth];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int d = 0; d < Depth; ++d) {
      sv[r][d] = -CUDART_INF_F;
      sc[r][d] = INT_MAX;
    }
  }
  float q2_lane = 0.f;  // lane r < kRows: |x_row0+r|^2, summed over the first tile's chunks

  const bool scoring = row0 < N;  // uniform across the warp
  int stage = 0;
  for (int t = 0; t < tiles_n; ++t) {
    float acc[kRows][kPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[r][j] = 0.f;
    }

    for (int c = 0; c < chunks; ++c, ++stage) {
      copy_async_wait_all();
      __syncthreads();
      if (c + 1 < chunks) {
        load_chunk(t, c + 1, (stage + 1) & 1);
      } else if (t + 1 < tiles_n) {
        load_chunk(t + 1, 0, (stage + 1) & 1);
      }
      if (!scoring) continue;

      const int width = min(kChunk, F - c * kChunk);
      const float* cand = tiles + static_cast<size_t>(stage & 1) * kTile * stride + lane * stride;
      const float* qc = qs + (chunks > 1 ? (stage & 1) : 0) * kBlockRows * kChunk +
                        warp * kRows * kChunk;
      if (t == 0 && lane < kRows) {  // the rows' squared norms, in feature order
        for (int g = 0; g < width; ++g) {
          const float v = qc[g * kRows + lane];
          q2_lane = (c == 0 && g == 0) ? __fmul_rn(v, v) : __fadd_rn(q2_lane, __fmul_rn(v, v));
        }
      }
      if (kVec) {
        for (int g = 0; g < width; g += 4) {
          float4 c4[kPerLane];
#pragma unroll
          for (int j = 0; j < kPerLane; ++j)
            c4[j] = *reinterpret_cast<const float4*>(cand + 32 * j * stride + g);
          const float cx[kPerLane] = {c4[0].x, c4[1].x, c4[2].x, c4[3].x};
          const float cy[kPerLane] = {c4[0].y, c4[1].y, c4[2].y, c4[3].y};
          const float cz[kPerLane] = {c4[0].z, c4[1].z, c4[2].z, c4[3].z};
          const float cw[kPerLane] = {c4[0].w, c4[1].w, c4[2].w, c4[3].w};
          add_products<kRows>(acc, qc + g * kRows, cx);
          add_products<kRows>(acc, qc + (g + 1) * kRows, cy);
          add_products<kRows>(acc, qc + (g + 2) * kRows, cz);
          add_products<kRows>(acc, qc + (g + 3) * kRows, cw);
        }
      } else {
        for (int g = 0; g < width; ++g) {
          float c1[kPerLane];
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) c1[j] = cand[32 * j * stride + g];
          add_products<kRows>(acc, qc + g * kRows, c1);
        }
      }
    }
    if (!scoring) continue;

    // the tile's scores are complete: into the lanes' stacks, row by row
    const int base = t * kTile, n = min(kTile, N - base);
    float c2[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) c2[j] = c2s[(t & 1) * kTile + 32 * j + lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const float q2 = __shfl_sync(kFull, q2_lane, r);
      if (row >= N) continue;  // uniform across the warp
      float s[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) s[j] = finish_score(acc[r][j], q2, c2[j]);
      const int self = row - base;  // the row's own place in the tile, if it has one
      if (!include_self && static_cast<unsigned>(self) < kTile) {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          if (32 * j + lane == self) s[j] = -CUDART_INF_F;
      }
      if (n < kTile) {  // the cloud's last tile: nothing past its end enters
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          if (32 * j + lane >= n) s[j] = -CUDART_INF_F;
      }
      bool beats = false;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) beats = beats || s[j] > sv[r][Depth - 1];
      // past the first tiles few lanes take anything: one vote a row
      if (!__any_sync(kFull, beats)) continue;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float v = s[j];
        // strictly in front of the last entry: a lane offers its columns in
        // ascending order, so an equal score stays behind the earlier
        // column, and -inf (excluded, masked, NaN) never enters
        if (!(v > sv[r][Depth - 1])) continue;
        const int col = base + 32 * j + lane;
#pragma unroll
        for (int d = Depth - 1; d >= 0; --d) {  // deepest first: each step reads old levels
          if (d > 0 && v > sv[r][d - 1]) {
            sv[r][d] = sv[r][d - 1];
            sc[r][d] = sc[r][d - 1];
          } else if (v > sv[r][d]) {
            sv[r][d] = v;
            sc[r][d] = col;
          }
        }
      }
    }
  }
  if (!scoring) return;

  // level 2: per row, K rounds over the lane heads; a lane whose stack ran
  // dry while it has columns left is refilled by a rescan. No barrier from
  // here on; the warp's query area is its own.
  float* const qw = qs + warp * kRows * kChunk;
  const int owned = (N - lane + 31) / 32;  // columns this lane owns
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= N) break;  // uniform across the warp
    const float q2 = __shfl_sync(kFull, q2_lane, r);
    const int self = include_self ? -1 : row;
    int have = 0;
#pragma unroll
    for (int d = 0; d < Depth; ++d) have += sc[r][d] != INT_MAX;
    int taken = 0;  // of the owned columns, consumed
    float last_v = 0.f;
    int last_c = -1;
    int picked = 0;  // lane j % 32 holds round j's column until the 32 are written
    int* const dst = out + (static_cast<size_t>(b) * N + row) * K;
    for (int j = 0; j < K; ++j) {
      unsigned dry = __ballot_sync(kFull, have == 0 && taken < owned);
      while (dry) {
        const int l = __ffs(dry) - 1;
        dry &= dry - 1;
        const int found = rescan<kVec, Depth>(cloud, cloud_norms, qw, row, N, F, q2, self, l,
                                              __shfl_sync(kFull, last_v, l),
                                              __shfl_sync(kFull, last_c, l), sv[r], sc[r]);
        if (lane == l) {
          if (found == 0) {
            taken = owned;  // nothing is left in this lane
          } else {
            have = found;
          }
        }
      }
      unsigned best;
      const int bc = warp_first_column(have > 0 ? score_key(sv[r][0]) : 0u,
                                       have > 0 ? sc[r][0] : INT_MAX, best);
      if (lane == (j & 31)) picked = bc;
      if ((j & 31) == 31 || j == K - 1) {
        if (lane <= (j & 31)) dst[(j & ~31) + lane] = picked;
      }
      if (have > 0 && sc[r][0] == bc) {  // pop this lane's head
        last_v = sv[r][0];
        last_c = sc[r][0];
#pragma unroll
        for (int d = 0; d + 1 < Depth; ++d) {
          sv[r][d] = sv[r][d + 1];
          sc[r][d] = sc[r][d + 1];
        }
        sv[r][Depth - 1] = -CUDART_INF_F;
        sc[r][Depth - 1] = INT_MAX;
        --have;
        ++taken;
      }
    }
  }
}

int launch_norms(const float* x, const unsigned char* mask, float* norms, int B, int N, int F,
                 cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((rows + threads - 1) / threads);
  row_sqnorm_kernel<<<blocks, threads, 0, stream>>>(x, mask, norms, rows, F);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, int kRows>
int launch_flat(const float* x, const float* norms, int* out, int B, int N, int F, int K,
                int include_self, cudaStream_t stream) {
  constexpr int kBlockRows = kWarps * kRows;
  const int stride = flat_stride(F, kVec);
  const size_t bytes = flat_smem_bytes(kBlockRows, F, stride);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_flat_kernel<kVec, kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, B);
  knn_flat_kernel<kVec, kRows><<<grid, kWarps * 32, bytes, stream>>>(x, norms, out, N, F, K,
                                                                     include_self, stride);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, int kRows, int Depth>
int launch_two_level(const float* x, const float* norms, int* out, int B, int N, int F, int K,
                     int include_self, cudaStream_t stream) {
  constexpr int kBlockRows = kWarps * kRows;
  const int stride = flat_stride(F, kVec);
  const size_t bytes = two_level_smem_bytes(kBlockRows, F, stride);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_two_level_kernel<kVec, kRows, Depth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kBlockRows - 1) / kBlockRows, B);
  knn_two_level_kernel<kVec, kRows, Depth><<<grid, kWarps * 32, bytes, stream>>>(
      x, norms, out, N, F, K, include_self, stride);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows, int Depth>
int launch_two_level_vec(bool vec, const float* x, const float* norms, int* out, int B, int N,
                         int F, int K, int include_self, cudaStream_t stream) {
  return vec ? launch_two_level<true, kRows, Depth>(x, norms, out, B, N, F, K, include_self, stream)
             : launch_two_level<false, kRows, Depth>(x, norms, out, B, N, F, K, include_self,
                                                     stream);
}

template <int Depth>
int launch_two_level_rows(bool vec, const float* x, const float* norms, int* out, int B, int N,
                          int F, int K, int include_self, cudaStream_t stream) {
  return two_level_rows(B, N) == 4
             ? launch_two_level_vec<4, Depth>(vec, x, norms, out, B, N, F, K, include_self, stream)
             : launch_two_level_vec<2, Depth>(vec, x, norms, out, B, N, F, K, include_self, stream);
}

}  // namespace

// x (B, N, F) f32, norms (B, N) f32 scratch, mask (B, N) bytes (0: never a
// neighbour) or null, out (B, N, K) i32; include_self 0 drops the row
// itself; `device` is the tensors' device, `stream` a stream of it. Needs
// 1 <= K <= 32, K <= N, F >= 1 and flat_smem_bytes(64, F, .) <= 227 KB
// (F <= 631). Rows of a multiple of 4 floats at a 16-byte aligned x take
// the 16-byte path.
extern "C" int pointseg_knn(const void* x, void* norms, const void* mask, void* out, int B, int N,
                            int F, int K, int include_self, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* nf = static_cast<float*>(norms);
  int* o = static_cast<int*>(out);
  const int err = launch_norms(xf, static_cast<const unsigned char*>(mask), nf, B, N, F, s);
  if (err != 0) return err;
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // Eight query rows a warp when that still leaves kMinBlocks blocks;
  // a small batch or cloud gets four or two, so that the card is filled:
  // the smaller register tile costs less than idle SMs.
  const auto blocks = [&](int rows) {
    return static_cast<long long>(B) * ((N + kWarps * rows - 1) / (kWarps * rows));
  };
  if (blocks(8) >= kMinBlocks) {
    return vec ? launch_flat<true, 8>(xf, nf, o, B, N, F, K, include_self, s)
               : launch_flat<false, 8>(xf, nf, o, B, N, F, K, include_self, s);
  }
  if (blocks(4) >= kMinBlocks) {
    return vec ? launch_flat<true, 4>(xf, nf, o, B, N, F, K, include_self, s)
               : launch_flat<false, 4>(xf, nf, o, B, N, F, K, include_self, s);
  }
  return vec ? launch_flat<true, 2>(xf, nf, o, B, N, F, K, include_self, s)
             : launch_flat<false, 2>(xf, nf, o, B, N, F, K, include_self, s);
}

// As pointseg_knn, by the two-level selection with per-lane stacks of
// `depth` entries (4 or 5 in use, 1 to force refills in tests). Takes any
// K <= N and any F >= 1: its shared memory does not grow with F.
extern "C" int pointseg_knn_2l(const void* x, void* norms, const void* mask, void* out, int B,
                               int N, int F, int K, int include_self, int depth, int device,
                               void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* nf = static_cast<float*>(norms);
  int* o = static_cast<int*>(out);
  const int err = launch_norms(xf, static_cast<const unsigned char*>(mask), nf, B, N, F, s);
  if (err != 0) return err;
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (depth) {
    case 1:
      return launch_two_level_rows<1>(vec, xf, nf, o, B, N, F, K, include_self, s);
    case 4:
      return launch_two_level_rows<4>(vec, xf, nf, o, B, N, F, K, include_self, s);
    case 5:
      return launch_two_level_rows<5>(vec, xf, nf, o, B, N, F, K, include_self, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
