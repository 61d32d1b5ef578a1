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
// Two-level selection (kernel 5) keeps one query row a warp and a
// feature-major tile (its own helpers below): lane l owns the strided
// columns {32 w + l}, which are exactly the candidates it scores, so
// pass one needs no traffic between lanes: each lane keeps a sorted
// top-`Depth` stack of its own columns in registers, and eight rows a
// warp would need eight such stacks. Then k rounds pick the best
// head across the warp (ties to the lowest column), pop it, and refill
// a lane whose stack ran dry although it has columns left: the warp
// rescans that lane's columns (N/32 of them, read from global memory)
// for the best entry after the last one consumed in (score desc,
// column asc) order. The result never depends on Depth, only the time.

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

// ------------------------------------------- kernel 5's tile and score pass
// One query row a warp, kWarps rows a block.

constexpr int kStride = kTile + 1;  // padded row stride of the feature-major tile

// Shared memory of one block: the tile, feature-major (F rows of kStride),
// the candidates' squared norms, and the block's query rows.
struct Smem {
  float* tile;
  float* c2;
  float* q;
  __device__ Smem(float* base, int F)
      : tile(base), c2(base + F * kStride), q(base + F * kStride + kTile) {}
};

__host__ __device__ inline size_t smem_bytes(int F) {
  return (static_cast<size_t>(F) * kStride + kTile + static_cast<size_t>(kWarps) * F) *
         sizeof(float);
}

// Copies this warp's query row into shared memory (zeros for a warp past
// the last row, so its arithmetic stays finite).
__device__ __forceinline__ void stage_query(const Smem& sm, const float* cloud, int row,
                                            bool active, int F) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int f = lane; f < F; f += 32)
    sm.q[warp * F + f] = active ? cloud[static_cast<size_t>(row) * F + f] : 0.f;
}

// Loads candidates [base, base + n) of the cloud into the tile; ends with
// a block-wide barrier;
// a masked-out candidate gets |x|^2 = +inf and hence the score -inf.
__device__ __forceinline__ void load_tile(const Smem& sm, const float* cloud,
                                          const float* norms, const unsigned char* mask,
                                          int base, int n, int F) {
  __syncthreads();  // the previous tile is no longer read
  const float* src = cloud + static_cast<size_t>(base) * F;
  for (int t = threadIdx.x; t < n * F; t += blockDim.x) {
    const int i = t / F, f = t - i * F;
    sm.tile[f * kStride + i] = src[t];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    sm.c2[i] = (mask == nullptr || mask[base + i]) ? norms[base + i] : CUDART_INF_F;
  __syncthreads();
}

// Scores of this warp's query against tile candidates lane, lane + 32, ...
// `self` is the query's own position in the tile when it is to be
// excluded (any value outside [0, kTile) otherwise).
__device__ __forceinline__ void score_tile(const Smem& sm, int F, float q2, int self,
                                           float (&s)[kPerLane]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = sm.q + warp * F;
  const float* col = sm.tile + lane;
  float q0 = q[0];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) s[c] = __fmul_rn(q0, col[32 * c]);
  for (int f = 1; f < F; ++f) {
    const float qf = q[f];
    const float* row = col + f * kStride;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) s[c] = __fadd_rn(s[c], __fmul_rn(qf, row[32 * c]));
  }
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    s[c] = finish_score(s[c], q2, sm.c2[lane + 32 * c]);
    if (lane + 32 * c == self) s[c] = -CUDART_INF_F;
  }
}

// ---------------------------------------------------------------- kernel 5

// (score desc, column asc): is (v, c) in front of (bv, bc)?
__device__ __forceinline__ bool in_front(float v, int c, float bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

__device__ __forceinline__ void warp_best(float& v, int& c) {
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

template <int Depth>
__global__ void knn_two_level_kernel(const float* __restrict__ x,
                                     const float* __restrict__ norms,
                                     const unsigned char* __restrict__ mask,
                                     int* __restrict__ out, int N, int F, int K,
                                     int include_self) {
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw, F);

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < N;
  const float* cloud = x + static_cast<size_t>(b) * N * F;
  const float* cloud_norms = norms + static_cast<size_t>(b) * N;
  const unsigned char* cloud_mask = mask ? mask + static_cast<size_t>(b) * N : nullptr;
  const int self = include_self ? -1 : row;

  stage_query(sm, cloud, row, active, F);
  const float q2 = active ? cloud_norms[row] : 0.f;

  // level 1: this lane's sorted top-Depth of the columns {32 w + lane}
  float sv[Depth];
  int sc[Depth];
#pragma unroll
  for (int t = 0; t < Depth; ++t) {
    sv[t] = -CUDART_INF_F;
    sc[t] = INT_MAX;
  }
  int have = 0;  // filled stack slots

  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    load_tile(sm, cloud, cloud_norms, cloud_mask, base, n, F);
    if (!active) continue;
    float s[kPerLane];
    score_tile(sm, F, q2, self - base, s);
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int j = 32 * c + lane;
      if (j >= n) continue;
      const float v = s[c];
      // insertion chain, deepest level first so each step reads old
      // levels; strictly greater, so an equal score stays behind the
      // earlier (lower) column. An empty slot holds -inf, so an excluded
      // column (-inf) never enters: the refill below finds it if needed.
      if (have < Depth && v > sv[Depth - 1]) ++have;
#pragma unroll
      for (int t = Depth - 1; t >= 0; --t) {
        const int up = t > 0 ? t - 1 : 0;
        if (t > 0 && v > sv[up]) {
          sv[t] = sv[up];
          sc[t] = sc[up];
        } else if (v > sv[t]) {
          sv[t] = v;
          sc[t] = base + j;
        }
      }
    }
  }
  if (!active) return;

  // level 2: K rounds over the lane heads
  const int owned = (N - lane + 31) / 32;  // columns this lane owns
  int taken = 0;                           // of which consumed
  float last_v = 0.f;                      // the last one consumed
  int last_c = -1;
  int picked = INT_MAX;  // lane j keeps round j's column
  const float* q = sm.q + warp * F;

  for (int j = 0; j < K; ++j) {
    unsigned dry = __ballot_sync(kFull, have == 0 && taken < owned);
    while (dry) {
      const int l = __ffs(dry) - 1;
      dry &= dry - 1;
      // the warp rescans lane l's columns for its best entry behind
      // (last_v, last_c); lane t takes the columns 32 (t + 32 m) + l
      const float lv = __shfl_sync(kFull, last_v, l);
      const int lc = __shfl_sync(kFull, last_c, l);
      float bv = -CUDART_INF_F;
      int bc = INT_MAX;
      for (int col = 32 * lane + l; col < N; col += 1024) {
        const float* cand = cloud + static_cast<size_t>(col) * F;
        float dot = __fmul_rn(q[0], cand[0]);
        for (int f = 1; f < F; ++f) dot = __fadd_rn(dot, __fmul_rn(q[f], cand[f]));
        float v = finish_score(dot, q2, cloud_norms[col]);
        if (col == self || (cloud_mask != nullptr && !cloud_mask[col])) v = -CUDART_INF_F;
        const bool behind_last = lc < 0 || v < lv || (v == lv && col > lc);
        if (behind_last && in_front(v, col, bv, bc)) {
          bv = v;
          bc = col;
        }
      }
      warp_best(bv, bc);
      if (lane == l) {
        if (bc == INT_MAX) {
          taken = owned;  // nothing comparable is left in this lane
        } else {
          sv[0] = bv;
          sc[0] = bc;
          have = 1;
        }
      }
    }

    float hv = have > 0 ? sv[0] : -CUDART_INF_F;
    int hc = have > 0 ? sc[0] : INT_MAX;
    const bool mine_valid = have > 0;
    const int my_col = hc;
    warp_best(hv, hc);
    if (lane == j) picked = hc;
    if (mine_valid && my_col == hc) {  // pop this lane's head
      last_v = sv[0];
      last_c = sc[0];
#pragma unroll
      for (int t = 0; t + 1 < Depth; ++t) {
        sv[t] = sv[t + 1];
        sc[t] = sc[t + 1];
      }
      sv[Depth - 1] = -CUDART_INF_F;
      sc[Depth - 1] = INT_MAX;
      --have;
      ++taken;
    }
  }

  if (lane < K) out[(static_cast<size_t>(b) * N + row) * K + lane] = picked;
}

// `mask` null: plain squared norms (kernel 5 applies the mask itself).
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

template <typename Kernel>
int launch_two_level(Kernel kernel, const float* x, const float* norms,
                     const unsigned char* mask, int* out, int B, int N, int F, int K,
                     int include_self, cudaStream_t stream) {
  const size_t bytes = smem_bytes(F);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kWarps - 1) / kWarps, B);
  kernel<<<grid, kWarps * 32, bytes, stream>>>(x, norms, mask, out, N, F, K, include_self);
  return static_cast<int>(cudaGetLastError());
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
// `depth` entries: 4 or 5 in use, 1 to force refills in tests. Needs
// smem_bytes(F) <= 227 KB (F <= 423).
extern "C" int pointseg_knn_2l(const void* x, void* norms, const void* mask, void* out, int B,
                               int N, int F, int K, int include_self, int depth, int device,
                               void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* nf = static_cast<float*>(norms);
  const auto* m = static_cast<const unsigned char*>(mask);
  int* o = static_cast<int*>(out);
  const int err = launch_norms(xf, nullptr, nf, B, N, F, s);
  if (err != 0) return err;
  switch (depth) {
    case 1:
      return launch_two_level(knn_two_level_kernel<1>, xf, nf, m, o, B, N, F, K, include_self, s);
    case 4:
      return launch_two_level(knn_two_level_kernel<4>, xf, nf, m, o, B, N, F, K, include_self, s);
    case 5:
      return launch_two_level(knn_two_level_kernel<5>, xf, nf, m, o, B, N, F, K, include_self, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
