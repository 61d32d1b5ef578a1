// EdgeConv's gather-reduce, forward and backward, with the gathered
// (B, M, k, C) neighbour rows never formed; also the grouped layer of
// PointNeXt's InvResMLP blocks, through a per-centre offset.
//
// Replaces no TPU kernel. The JAX package's fused EdgeConv
// (pointseg/nn/blocks.py, `EdgeConv` with fused=True) gathers the
// neighbour rows with gather_rows_dma and leaves the max, the min and
// the two sums over them to XLA, which fuses them on the TPU; on this card
// the same composition wrote the rows, read them four times and, in the
// backward, built four (B, M, k, C) gradients, int64 tie counts and a
// scatter over them. The function is the composition's
// (`ops/edgereduce.py::edge_reduce_plain`), over the rows
// x[b, i, j, c] = p[b, idx[b, i, j], c] (+ d[b, i, c] with an offset d,
// the sum rounded to the table's dtype, as the composition's add is):
//
//   forward, for every (b, i, c), over the k rows x[b, i, j, c]:
//     max, min, their tie counts, and (training) s = sum x, q = sum x^2
//     in float32;
//   backward, for every edge (b, i, j) and channel c, into
//   grad[b, idx[b, i, j], c]:
//     g_max [x == max] / count_max + g_min [x == min] / count_min
//     + g_s + 2 x g_q,
//   which is autograd's derivative of amax / amin (ties share the
//   gradient evenly), of sum and of the square, term for term. The
//   offset's own gradient, g_max + g_min + k g_s + 2 g_q s, is (B, M, C)
//   and needs no kernel (`ops/edgereduce.py`).
//
// The offset is what lets PointNeXt's InvResMLP grouped layer use the
// pair: its rows are W_f f_j + W_r (p_j - c_i) / r, a per-point table
// t_j = W_f f_j + W_r (p_j - a) / r plus a per-centre offset
// d_i = W_r (a - c_i) / r, for an anchor point a of the cloud
// (`nn/blocks.py::GroupedFirstLayer`). The sums are taken over x itself,
// not corrected from sums of p afterwards, a form that cancels. The
// offset is a template parameter: without one (EdgeConv) the kernels
// are the code they were before it.
//
// What bounds it on the H100: bytes, and the L2 cache's rate. From device
// memory the forward needs the (B, N, C) table, the indices and the
// outputs (8.4 MB of table and 10.5 MB of indices at B=32, N=4096, k=20,
// C=64; four outputs of 33.5 MB and two 1-byte counts); the backward the
// same inputs, four incoming gradients and the (B, N, C) float32
// gradient. A cloud's table (1-2 MB) sits in L2 while its points are
// walked, so the k-fold re-reading of rows (671 MB at C=64) and the
// backward's k adds a row element (atomics, resolved in L2) are L2
// traffic, not device-memory traffic.
//
// What the design does about it: a group of neighbouring threads (the
// power of two that covers the row's vectors, up to a warp) owns one
// point; each thread owns V consecutive channels (16-byte loads of the
// table where C and the pointers allow, narrower otherwise) and walks the
// point's k neighbours once, keeping max, min, their counts and the two
// sums in registers. Points are numbered in batch order, so the blocks
// that run together read one or two clouds' rows. The counts are kept
// online (a new extreme resets its count to 1, an equal value adds 1) and
// stored in 1 byte where k <= 255, 4 above. An offset is read once a
// point, the thread's V channels kept in registers while it walks the
// neighbours: one more (B, M, C) read. The backward recomputes each
// edge's term from the table row (plus the offset), the point's max, min
// and counts and its four gradients, and adds it with one vector atomic per 16 bytes
// (sm_90's float2 / float4 atomicAdd): the order of the adds changes from
// run to run, so the gradient is not bit-reproducible, as kernel 7's
// scatter-add (`index_add_`) is not.
//
// A NaN in a neighbourhood is its max and its min, as torch.amax gives.
// An index outside [0, N) is never dereferenced: the thread traps and the
// launch fails at the next synchronisation, as in csrc/gather.cu.

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

template <int Bytes> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<1> { using type = uint8_t; };

// V elements of T at p (aligned to min(16, V * sizeof(T)) bytes), in
// loads of up to 16 bytes.
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, T (&v)[V]) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * V;
  constexpr int kChunk = kBytes > 16 ? 16 : kBytes;
  using W = typename Word<kChunk>::type;
#pragma unroll
  for (int c = 0; c < kBytes / kChunk; ++c) {
    const W w = reinterpret_cast<const W*>(p)[c];
    memcpy(reinterpret_cast<char*>(v) + c * kChunk, &w, kChunk);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const T (&v)[V]) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * V;
  constexpr int kChunk = kBytes > 16 ? 16 : kBytes;
  using W = typename Word<kChunk>::type;
#pragma unroll
  for (int c = 0; c < kBytes / kChunk; ++c) {
    W w;
    memcpy(&w, reinterpret_cast<const char*>(v) + c * kChunk, kChunk);
    reinterpret_cast<W*>(p)[c] = w;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // exact for a max or min of bfloat16 rows
}

// x = p + d, rounded to T as PyTorch's add of two T tensors rounds it
// (float32: the add itself).
template <typename T, int V>
__device__ __forceinline__ void add_offset(float (&p)[V], const float (&d)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) p[e] = to_float(from_float<T>(p[e] + d[e]));
}

// V elements of T at p, as float; a null p reads as zeros.
template <typename T, int V>
__device__ __forceinline__ void load_float(const T* __restrict__ p, float (&out)[V]) {
  if (p == nullptr) {
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = 0.0f;
    return;
  }
  T v[V];
  load<T, V>(p, v);
#pragma unroll
  for (int e = 0; e < V; ++e) out[e] = to_float(v[e]);
}

// grad[0..V) += add[0..V), float32, in vector atomics of up to 16 bytes.
template <int V>
__device__ __forceinline__ void atomic_add(float* __restrict__ grad, const float (&add)[V]) {
  if constexpr (V == 1) {
    atomicAdd(grad, add[0]);
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(grad), make_float2(add[0], add[1]));
  } else {
#pragma unroll
    for (int c = 0; c < V; c += 4) {
      atomicAdd(reinterpret_cast<float4*>(grad + c),
                make_float4(add[c], add[c + 1], add[c + 2], add[c + 3]));
    }
  }
}

// The point and the first vector this thread owns; false past the last point.
struct Slot {
  long long point;
  int lane, group;
};

__device__ __forceinline__ bool slot(long long points, int group_log2, Slot& s) {
  s.point = static_cast<long long>(blockIdx.x) * (kThreads >> group_log2) +
            (threadIdx.x >> group_log2);
  s.group = 1 << group_log2;
  s.lane = threadIdx.x & (s.group - 1);
  return s.point < points;
}

__device__ __forceinline__ int neighbour(const int* __restrict__ nbr, int j, int N) {
  const int src = __ldg(nbr + j);
  if (src < 0 || src >= N) __trap();
  return src;
}

// table (B, N, C) of T; idx (B, M, K) int32; offset (B, M, C) of T, read
// where Offset; out_max, out_min (B, M, C) of T; out_sum, out_sq (B, M, C)
// float32 or null (not computed); count_max, count_min (B, M, C) of Count
// or null (not stored). C = units * V.
template <typename T, int V, typename Count, bool Offset>
__global__ void edge_reduce_kernel(
    const T* __restrict__ table, const int* __restrict__ idx, const T* __restrict__ offset,
    T* __restrict__ out_max,
    T* __restrict__ out_min, float* __restrict__ out_sum, float* __restrict__ out_sq,
    Count* __restrict__ count_max, Count* __restrict__ count_min, long long points, int M,
    int N, int K, int units, int group_log2) {
  Slot s;
  if (!slot(points, group_log2, s)) return;
  const size_t C = static_cast<size_t>(units) * V;
  const T* rows = table + static_cast<size_t>(s.point / M) * N * C;
  const int* nbr = idx + static_cast<size_t>(s.point) * K;
  const size_t out = static_cast<size_t>(s.point) * C;
  for (int w = s.lane; w < units; w += s.group) {
    const size_t col = static_cast<size_t>(w) * V;
    float mx[V], mn[V], sum[V], sq[V], d[V];
    int cmx[V], cmn[V];
    if constexpr (Offset) load_float<T, V>(offset + out + col, d);
    {
      float p[V];
      load_float<T, V>(rows + neighbour(nbr, 0, N) * C + col, p);
      if constexpr (Offset) add_offset<T, V>(p, d);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        mx[e] = mn[e] = sum[e] = p[e];
        sq[e] = p[e] * p[e];
        cmx[e] = cmn[e] = 1;
      }
    }
#pragma unroll 4
    for (int j = 1; j < K; ++j) {
      float p[V];
      load_float<T, V>(rows + neighbour(nbr, j, N) * C + col, p);
      if constexpr (Offset) add_offset<T, V>(p, d);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float v = p[e];
        if (v > mx[e] || v != v) {
          mx[e] = v;
          cmx[e] = 1;
        } else if (v == mx[e]) {
          ++cmx[e];
        }
        if (v < mn[e] || v != v) {
          mn[e] = v;
          cmn[e] = 1;
        } else if (v == mn[e]) {
          ++cmn[e];
        }
        sum[e] += v;
        sq[e] += v * v;
      }
    }
    T vmx[V], vmn[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      vmx[e] = from_float<T>(mx[e]);
      vmn[e] = from_float<T>(mn[e]);
    }
    store<T, V>(out_max + out + col, vmx);
    store<T, V>(out_min + out + col, vmn);
    if (out_sum != nullptr) {
      store<float, V>(out_sum + out + col, sum);
      store<float, V>(out_sq + out + col, sq);
    }
    if (count_max != nullptr) {
      Count c0[V], c1[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        c0[e] = static_cast<Count>(cmx[e]);
        c1[e] = static_cast<Count>(cmn[e]);
      }
      store<Count, V>(count_max + out + col, c0);
      store<Count, V>(count_min + out + col, c1);
    }
  }
}

// grad (B, N, C) float32, zeroed by the caller, += each edge's term.
// g_max, g_min (B, M, C) of T; g_sum, g_sq (B, M, C) float32 or null (no
// sums); the rest as the forward had them (each edge's x recomputed as
// the forward computed it).
template <typename T, int V, typename Count, bool Offset>
__global__ void edge_reduce_backward_kernel(
    const T* __restrict__ table, const int* __restrict__ idx, const T* __restrict__ offset,
    const T* __restrict__ vmax,
    const T* __restrict__ vmin, const Count* __restrict__ count_max,
    const Count* __restrict__ count_min, const T* __restrict__ g_max,
    const T* __restrict__ g_min, const float* __restrict__ g_sum,
    const float* __restrict__ g_sq, float* __restrict__ grad, long long points, int M, int N,
    int K, int units, int group_log2) {
  Slot s;
  if (!slot(points, group_log2, s)) return;
  const size_t C = static_cast<size_t>(units) * V;
  const size_t base = static_cast<size_t>(s.point / M) * N * C;
  const T* rows = table + base;
  float* grads = grad + base;
  const int* nbr = idx + static_cast<size_t>(s.point) * K;
  const size_t at = static_cast<size_t>(s.point) * C;
  for (int w = s.lane; w < units; w += s.group) {
    const size_t col = static_cast<size_t>(w) * V;
    float mx[V], mn[V], a[V], b[V], gs[V], gq2[V], d[V];
    Count c0[V], c1[V];
    if constexpr (Offset) load_float<T, V>(offset + at + col, d);
    load_float<T, V>(vmax + at + col, mx);
    load_float<T, V>(vmin + at + col, mn);
    load_float<T, V>(g_max + at + col, a);
    load_float<T, V>(g_min + at + col, b);
    load_float<float, V>(g_sum == nullptr ? nullptr : g_sum + at + col, gs);
    load_float<float, V>(g_sq == nullptr ? nullptr : g_sq + at + col, gq2);
    load<Count, V>(count_max + at + col, c0);
    load<Count, V>(count_min + at + col, c1);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      a[e] /= static_cast<float>(c0[e]);  // autograd's grad / count, then the mask
      b[e] /= static_cast<float>(c1[e]);
      gq2[e] *= 2.0f;  // exact: 2 (p g_q) = p g_q + p g_q, the product's two operands
    }
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      const size_t row = static_cast<size_t>(neighbour(nbr, j, N)) * C + col;
      float p[V], add[V];
      load_float<T, V>(rows + row, p);
      if constexpr (Offset) add_offset<T, V>(p, d);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float t = gs[e] + gq2[e] * p[e];
        if (p[e] == mx[e]) t += a[e];
        if (p[e] == mn[e]) t += b[e];
        add[e] = t;
      }
      atomic_add<V>(grads + row, add);
    }
  }
}

struct Args {
  const void* table;
  const void* idx;
  const void* offset;  // null for none
  const void* vmax;    // forward: out_max
  const void* vmin;    // forward: out_min
  const void* count_max;
  const void* count_min;
  const void* g_max;  // backward only
  const void* g_min;
  const void* sum;    // forward: out_sum; backward: g_sum
  const void* sq;     // forward: out_sq; backward: g_sq
  void* grad;         // backward only
  int B, M, N, K, C;
  cudaStream_t stream;
};

template <typename T, int V, typename Count, bool Offset>
int run(const Args& a, bool backward) {
  const int units = a.C / V;
  int group_log2 = 0;
  while (group_log2 < 5 && (1 << group_log2) < units) ++group_log2;
  const long long points = static_cast<long long>(a.B) * a.M;
  const long long per_block = kThreads >> group_log2;
  const long long blocks = (points + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (backward) {
    edge_reduce_backward_kernel<T, V, Count, Offset><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.table), static_cast<const int*>(a.idx),
        static_cast<const T*>(a.offset), static_cast<const T*>(a.vmax),
        static_cast<const T*>(a.vmin),
        static_cast<const Count*>(a.count_max), static_cast<const Count*>(a.count_min),
        static_cast<const T*>(a.g_max), static_cast<const T*>(a.g_min),
        static_cast<const float*>(a.sum), static_cast<const float*>(a.sq),
        static_cast<float*>(a.grad), points, a.M, a.N, a.K, units, group_log2);
  } else {
    edge_reduce_kernel<T, V, Count, Offset><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.table), static_cast<const int*>(a.idx),
        static_cast<const T*>(a.offset), static_cast<T*>(const_cast<void*>(a.vmax)),
        static_cast<T*>(const_cast<void*>(a.vmin)),
        static_cast<float*>(const_cast<void*>(a.sum)),
        static_cast<float*>(const_cast<void*>(a.sq)),
        static_cast<Count*>(const_cast<void*>(a.count_max)),
        static_cast<Count*>(const_cast<void*>(a.count_min)), points, a.M, a.N, a.K, units,
        group_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, typename Count>
int run(const Args& a, bool backward) {
  return a.offset == nullptr ? run<T, V, Count, false>(a, backward)
                             : run<T, V, Count, true>(a, backward);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// The widest V (16 bytes of T at most) that divides C and to which every
// array is aligned: min(16, V * element size) bytes for each.
template <typename T, typename Count>
int dispatch(const Args& a, bool backward) {
  for (int V = 16 / static_cast<int>(sizeof(T)); V > 1; V /= 2) {
    auto fits = [&](const void* p, int size) {
      return p == nullptr || aligned(p, V * size < 16 ? V * size : 16);
    };
    const int t = static_cast<int>(sizeof(T)), c = static_cast<int>(sizeof(Count));
    if (a.C % V != 0 || !fits(a.table, t) || !fits(a.offset, t) || !fits(a.vmax, t) ||
        !fits(a.vmin, t) || !fits(a.g_max, t) || !fits(a.g_min, t) ||
        !fits(a.count_max, c) || !fits(a.count_min, c) || !fits(a.sum, 4) ||
        !fits(a.sq, 4) || !fits(a.grad, 4)) {
      continue;
    }
    if constexpr (sizeof(T) == 2) {
      if (V == 8) return run<T, 8, Count>(a, backward);
    }
    if (V == 4) return run<T, 4, Count>(a, backward);
    return run<T, 2, Count>(a, backward);
  }
  return run<T, 1, Count>(a, backward);
}

// dtype 0: float32 rows, 1: bfloat16 rows; counts of 1 byte where K <= 255, else 4.
int launch(const Args& a, int dtype, bool backward) {
  if (a.B < 0 || a.M < 0 || a.N <= 0 || a.K <= 0 || a.C <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool narrow = a.K <= 255;
  if (dtype == 0) {
    return narrow ? dispatch<float, uint8_t>(a, backward) : dispatch<float, int32_t>(a, backward);
  }
  if (dtype == 1) {
    return narrow ? dispatch<__nv_bfloat16, uint8_t>(a, backward)
                  : dispatch<__nv_bfloat16, int32_t>(a, backward);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table (B, N, C), idx (B, M, K) int32; offset (B, M, C) in the table's
// dtype, null for none; out_max, out_min (B, M, C) in the table's dtype;
// out_sum, out_sq (B, M, C) float32, both null for no sums; count_max,
// count_min (B, M, C) uint8 (K <= 255) or int32, both null for no counts.
extern "C" int pointseg_edge_reduce(const void* table, const void* idx, const void* offset,
                                    void* out_max, void* out_min, void* out_sum, void* out_sq,
                                    void* count_max, void* count_min, int B, int M, int N,
                                    int K, int C, int dtype, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const Args a{table,   idx,     offset,  out_max, out_min, count_max, count_min,
               nullptr, nullptr, out_sum, out_sq,  nullptr, B,         M,
               N,       K,       C,       static_cast<cudaStream_t>(stream)};
  return launch(a, dtype, false);
}

// grad (B, N, C) float32, zeroed, += the edges' terms; g_max, g_min (B, M,
// C) in the table's dtype; g_sum, g_sq (B, M, C) float32, both null for
// no sums; the rest as pointseg_edge_reduce had them (counts required).
extern "C" int pointseg_edge_reduce_backward(const void* table, const void* idx,
                                             const void* offset, const void* vmax,
                                             const void* vmin, const void* count_max,
                                             const void* count_min,
                                             const void* g_max, const void* g_min,
                                             const void* g_sum, const void* g_sq, void* grad,
                                             int B, int M, int N, int K, int C, int dtype,
                                             int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const Args a{table, idx,  offset, vmax, vmin, count_max, count_min, g_max, g_min,
               g_sum, g_sq, grad,   B,    M,    N,         K,         C,
               static_cast<cudaStream_t>(stream)};
  return launch(a, dtype, true);
}
