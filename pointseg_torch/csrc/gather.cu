// Two row gathers, forward only as in the JAX package (the gradient of
// the batched one is a scatter-add outside the kernel).
//
// 1. Batched: out[b, m, :] = table[b, idx[b, m], :]. Replaces
//    pointseg/ops/pallas/gather.py::gather_rows_dma (`_dma_kernel`),
//    which starts one DMA per output row.
// 2. Flat: out[m, :] = table[idx[m], :] over one table of R rows, by
//    absolute row index. Replaces gather_rows_flat (`_flat_kernel`) of
//    the same file. It is the device store's sampler: 32,768 rows a batch
//    out of a table of up to 273 million (all of S3DIS), rows of 1 byte
//    (labels), 16 bytes (the packed store) or 36 bytes (nine floats).
//
// The batched kernel first.
//
// What bounds it on the H100: bytes. Every output row is written once
// (168 MB at the EdgeConv shape B=8, M=81,920, C=64) and read once from
// a table that fits the L2 cache (8 MB), so the time is the write
// stream's: about 0.05 ms at 3.35 TB/s.
//
// What the design does about it: a group of 2..32 neighbouring threads
// copies one row, a 16-byte vector per thread and step when a row is a
// whole number of 16-byte vectors and the pointers are aligned, a 4-byte
// word otherwise (the PointNet++ tables of width h + 3). The group size
// is the power of two that covers a row, up to a warp, so short rows
// share a warp; neighbouring threads read and write neighbouring
// addresses; the batch is a grid dimension, so no thread divides.
// Nothing is staged in shared memory: each byte is touched once.
//
// An index outside [0, N) is never dereferenced: the thread that meets
// one traps, and the launch fails with a CUDA error at the next
// synchronisation, as PyTorch's own indexing kernels do.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

// One row is `words` units of type T (uint4 or uint32_t), copied by a
// group of 1 << group_log2 threads.
template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                                   T* __restrict__ out, int N, int M, int words,
                                   int group_log2) {
  const int b = blockIdx.y;
  const int m = blockIdx.x * (kThreads >> group_log2) + (threadIdx.x >> group_log2);
  if (m >= M) return;
  const int src = idx[static_cast<size_t>(b) * M + m];
  if (src < 0 || src >= N) __trap();
  const T* from = table + (static_cast<size_t>(b) * N + src) * words;
  T* to = out + (static_cast<size_t>(b) * M + m) * words;
  const int group = 1 << group_log2;
  for (int w = threadIdx.x & (group - 1); w < words; w += group) to[w] = from[w];
}

template <typename T>
int launch(const void* table, const void* idx, void* out, int B, int N, int M, int words,
           cudaStream_t stream) {
  int group_log2 = 1;
  while (group_log2 < 5 && (1 << group_log2) < words) ++group_log2;
  const int rows_per_block = kThreads >> group_log2;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, B);
  gather_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx), static_cast<T*>(out), N, M,
      words, group_log2);
  return static_cast<int>(cudaGetLastError());
}

// The flat gather. What bounds it: bytes, and not the ones it asks for.
// The rows of a batch lie anywhere in a table far larger than the L2
// cache, so every row read costs a whole 32-byte sector (two when a
// 36-byte row straddles one) however short the row is, and the time is
// that of Mrows scattered sector reads, not of Mrows * row_bytes.
//
// What the design does about it: nothing is staged and no byte is touched
// twice. A row is `units` units of the widest type (16, 8, 4, 2 or 1
// bytes) that divides the row and that both pointers are aligned to; a
// group of 1..32 neighbouring threads (the power of two that covers a
// row) copies it, so a 16-byte row is one thread's vector load, a 1-byte
// row one thread's byte, and 32 such rows share a warp whose stores
// coalesce. The TPU kernel's chunked index fetch and ring of outstanding
// copies have no counterpart: the card's memory system keeps thousands of
// loads in flight by itself. Offsets are 64-bit throughout: nine floats a
// row pass 2^31 elements at 239 million rows and 2^32 bytes before that.
template <typename T>
__global__ void gather_rows_flat_kernel(const T* __restrict__ table,
                                        const long long* __restrict__ idx, T* __restrict__ out,
                                        long long R, long long M, int units, int group_log2) {
  const long long m = static_cast<long long>(blockIdx.x) * (kThreads >> group_log2) +
                      (threadIdx.x >> group_log2);
  if (m >= M) return;
  const long long src = idx[m];
  if (src < 0 || src >= R) __trap();
  const T* from = table + static_cast<size_t>(src) * units;
  T* to = out + static_cast<size_t>(m) * units;
  const int group = 1 << group_log2;
  for (int w = threadIdx.x & (group - 1); w < units; w += group) to[w] = from[w];
}

template <typename T>
int launch_flat(const void* table, const void* idx, void* out, long long R, long long M,
                long long row_bytes, cudaStream_t stream) {
  const int units = static_cast<int>(row_bytes / sizeof(T));
  int group_log2 = 0;
  while (group_log2 < 5 && (1 << group_log2) < units) ++group_log2;
  const long long rows_per_block = kThreads >> group_log2;
  const long long blocks = (M + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  gather_rows_flat_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const long long*>(idx), static_cast<T*>(out), R,
      M, units, group_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (B, N, C) of 4-byte elements, idx (B, M) i32, out (B, M, C). B <= 65535.
// Here and below `device` is the tensors' device, `stream` a stream of it.
extern "C" int pointseg_gather_rows(const void* table, const void* idx, void* out, int B, int N,
                                    int M, int C, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (C % 4 == 0 && aligned) return launch<uint4>(table, idx, out, B, N, M, C / 4, s);
  return launch<uint32_t>(table, idx, out, B, N, M, C, s);
}

// table (R rows of row_bytes bytes), idx (M) i64, out (M rows of row_bytes bytes).
extern "C" int pointseg_gather_rows_flat(const void* table, const void* idx, void* out,
                                         long long R, long long M, long long row_bytes,
                                         int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const auto s = static_cast<cudaStream_t>(stream);
  if (row_bytes <= 0 || row_bytes > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                         static_cast<uintptr_t>(row_bytes);
  if (bits % 16 == 0) return launch_flat<uint4>(table, idx, out, R, M, row_bytes, s);
  if (bits % 8 == 0) return launch_flat<uint2>(table, idx, out, R, M, row_bytes, s);
  if (bits % 4 == 0) return launch_flat<uint32_t>(table, idx, out, R, M, row_bytes, s);
  if (bits % 2 == 0) return launch_flat<uint16_t>(table, idx, out, R, M, row_bytes, s);
  return launch_flat<uint8_t>(table, idx, out, R, M, row_bytes, s);
}
