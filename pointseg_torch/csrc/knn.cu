// k nearest neighbours in feature space: one warp per query row, the
// candidates streamed through shared memory, two selection schemes.
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
// same bits and therefore the same selection. A NaN score (a diverged
// activation) is taken as -inf, so every column stays comparable and
// every slot written is a column in [0, N).
//
// What bounds it on the H100: operations. 2*B*N*N*F flops (17.2 GFLOP at
// B=8, N=4096, F=64) against 8 MB of input that stays in L2; without
// fused multiply-adds or tensor cores the float32 pipes, and before them
// the shared-memory reads (one per product), set the time.
//
// What the design does about it: kWarps query rows of one cloud share a
// block and a kTile-candidate tile, stored feature-major with a padded
// stride so that a warp's 32 lanes read 32 neighbouring candidates
// without bank conflicts. Each lane scores four candidates per query
// value it reads, so five shared-memory reads feed four products. The
// squared norms come from a small kernel of their own, once per call.
//
// Flat selection (kernel 4): the running top-k sits one slot per lane
// (lane j holds the j-th best). Candidates are visited in ascending
// column order and enter only on a strictly larger score, so equal
// scores keep the lower column in front. k <= 32.
//
// Two-level selection (kernel 5): lane l owns the strided columns
// {32 w + l}, which are exactly the candidates it scores, so pass one
// needs no traffic between lanes: each lane keeps a sorted top-`Depth`
// stack of its own columns in registers. Then k rounds pick the best
// head across the warp (ties to the lowest column), pop it, and refill
// a lane whose stack ran dry although it has columns left: the warp
// rescans that lane's columns (N/32 of them, read from global memory)
// for the best entry after the last one consumed in (score desc,
// column asc) order. The result never depends on Depth, only the time.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;           // query rows per block
constexpr int kTile = 128;          // candidates per shared-memory tile
constexpr int kStride = kTile + 1;  // padded row stride of the tile
constexpr int kPerLane = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

// |x_r|^2 with the products summed in ascending feature order.
__global__ void row_sqnorm_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  long long rows, int F) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + r * F;
  float acc = __fmul_rn(p[0], p[0]);
  for (int f = 1; f < F; ++f) acc = __fadd_rn(acc, __fmul_rn(p[f], p[f]));
  out[r] = acc;
}

// A NaN score counts as -inf, like an excluded column: the selections
// below compare with > and ==, which a NaN would slip through.
__device__ __forceinline__ float finish_score(float dot, float q2, float c2) {
  const float s = __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), q2), c2);
  return s == s ? s : -CUDART_INF_F;
}

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

// ---------------------------------------------------------------- kernel 4

__global__ void knn_flat_kernel(const float* __restrict__ x, const float* __restrict__ norms,
                                const unsigned char* __restrict__ mask, int* __restrict__ out,
                                int N, int F, int K, int include_self) {
  extern __shared__ float smem_raw[];
  const Smem sm(smem_raw, F);

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < N;  // uniform across the warp
  const float* cloud = x + static_cast<size_t>(b) * N * F;
  const float* cloud_norms = norms + static_cast<size_t>(b) * N;
  const unsigned char* cloud_mask = mask ? mask + static_cast<size_t>(b) * N : nullptr;
  const int self = include_self ? -1 : row;

  stage_query(sm, cloud, row, active, F);
  const float q2 = active ? cloud_norms[row] : 0.f;

  // lane j holds the j-th best so far; `count` slots (at most K) are filled
  float list_v = -CUDART_INF_F;
  int list_i = INT_MAX;
  int count = 0;

  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    load_tile(sm, cloud, cloud_norms, cloud_mask, base, n, F);
    if (!active) continue;
    float s[kPerLane];
    score_tile(sm, F, q2, self - base, s);

#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int j0 = 32 * c;
      if (j0 >= n) break;
      const bool here = j0 + lane < n;
      float last = __shfl_sync(kFull, list_v, K - 1);
      unsigned pending = __ballot_sync(kFull, here && (count < K || s[c] > last));
      while (pending) {
        const int src = __ffs(pending) - 1;
        pending &= pending - 1;
        const float cv = __shfl_sync(kFull, s[c], src);
        if (count >= K) {
          last = __shfl_sync(kFull, list_v, K - 1);
          if (!(cv > last)) continue;  // a tie keeps the lower listed column
        }
        const unsigned behind = __ballot_sync(kFull, lane >= count || list_v < cv);
        const int pos = __ffs(behind) - 1;
        const float up_v = __shfl_up_sync(kFull, list_v, 1);
        const int up_i = __shfl_up_sync(kFull, list_i, 1);
        if (lane > pos) {
          list_v = up_v;
          list_i = up_i;
        } else if (lane == pos) {
          list_v = cv;
          list_i = base + j0 + src;
        }
        if (count < K) ++count;
      }
    }
  }

  if (active && lane < K) out[(static_cast<size_t>(b) * N + row) * K + lane] = list_i;
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

int launch_norms(const float* x, float* norms, int B, int N, int F, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((rows + threads - 1) / threads);
  row_sqnorm_kernel<<<blocks, threads, 0, stream>>>(x, norms, rows, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int launch_knn(Kernel kernel, const float* x, const float* norms, const unsigned char* mask,
               int* out, int B, int N, int F, int K, int include_self, cudaStream_t stream) {
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
// itself. Needs 1 <= K <= 32, K <= N, F >= 1 and smem_bytes(F) <= 227 KB.
extern "C" int pointseg_knn(const void* x, void* norms, const void* mask, void* out, int B, int N,
                            int F, int K, int include_self, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = launch_norms(static_cast<const float*>(x), static_cast<float*>(norms), B, N, F, s);
  if (err != 0) return err;
  return launch_knn(knn_flat_kernel, static_cast<const float*>(x),
                    static_cast<const float*>(norms), static_cast<const unsigned char*>(mask),
                    static_cast<int*>(out), B, N, F, K, include_self, s);
}

// As pointseg_knn, by the two-level selection with per-lane stacks of
// `depth` entries: 4 or 5 in use, 1 to force refills in tests.
extern "C" int pointseg_knn_2l(const void* x, void* norms, const void* mask, void* out, int B,
                               int N, int F, int K, int include_self, int depth, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = launch_norms(static_cast<const float*>(x), static_cast<float*>(norms), B, N, F, s);
  if (err != 0) return err;
  const float* xf = static_cast<const float*>(x);
  const float* nf = static_cast<const float*>(norms);
  const auto* m = static_cast<const unsigned char*>(mask);
  int* o = static_cast<int*>(out);
  switch (depth) {
    case 1: return launch_knn(knn_two_level_kernel<1>, xf, nf, m, o, B, N, F, K, include_self, s);
    case 4: return launch_knn(knn_two_level_kernel<4>, xf, nf, m, o, B, N, F, K, include_self, s);
    case 5: return launch_knn(knn_two_level_kernel<5>, xf, nf, m, o, B, N, F, K, include_self, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
