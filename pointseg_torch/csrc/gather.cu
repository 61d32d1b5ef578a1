// Two row gathers, forward only as in the JAX package (the gradient of
// the batched one is a scatter-add outside the kernel).
//
// 1. Batched: out[b, m, :] = table[b, idx[b, m], :] and, with a second
//    table, out2[b, m, :] = table2[b, idx[b, m], :] in the same launch.
//    Replaces pointseg/ops/pallas/gather.py::gather_rows_dma
//    (`_dma_kernel`), which starts one DMA per output row. The second
//    table is what SetAbstraction grouping needs: the feature rows and the
//    coordinate rows at one set of indices, written to two contiguous
//    outputs (the JAX package concatenates the two tables into one, because
//    a separate 12-byte-row gather was slow on the TPU; on this card the
//    concatenation is a copy of the table a call).
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
// stream's: about 0.05 ms at 3.35 TB/s. At the small tables of the
// PointNet++ family a call is a few microseconds on the card, and what it
// costs is the host's: the wrapper does nothing per call that it need not.
//
// What the design does about it: rows are copied by bytes, in units of
// the widest type (16, 8, 4, 2 or 1 bytes) that divides the row and both
// pointers, so any dtype gathers and a float32 row of 4k elements moves as
// 16-byte vectors; the second table in units of up to 4 bytes (its rows
// are the 12-byte coordinates). A group of 1..32 neighbouring threads,
// the power of two that covers the wider row (up to a warp), copies one
// output row and its second row, so short rows share a warp and
// neighbouring threads read and write neighbouring addresses; the batch
// is a grid dimension, so no thread divides. Nothing is staged in shared
// memory: each byte is touched once.
//
// An index outside [0, N) is never dereferenced: the thread that meets
// one traps, and the launch fails with a CUDA error at the next
// synchronisation, as PyTorch's own indexing kernels do.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

// A row is `units` units of T and, where units2 > 0, the second table's
// row `units2` units of U; one group of 1 << group_log2 threads copies both.
template <typename T, typename U>
__global__ void gather_rows_kernel(const T* __restrict__ table, const U* __restrict__ table2,
                                   const int* __restrict__ idx, T* __restrict__ out,
                                   U* __restrict__ out2, int N, int M, int units, int units2,
                                   int group_log2) {
  const int b = blockIdx.y;
  const int m = blockIdx.x * (kThreads >> group_log2) + (threadIdx.x >> group_log2);
  if (m >= M) return;
  const int src = idx[static_cast<size_t>(b) * M + m];
  if (src < 0 || src >= N) __trap();
  const size_t from = static_cast<size_t>(b) * N + src;
  const size_t to = static_cast<size_t>(b) * M + m;
  const int group = 1 << group_log2;
  const int lane = threadIdx.x & (group - 1);
  for (int w = lane; w < units; w += group) out[to * units + w] = table[from * units + w];
  for (int w = lane; w < units2; w += group) out2[to * units2 + w] = table2[from * units2 + w];
}

struct Rows {
  const void* table;
  const void* table2;
  const void* idx;
  void* out;
  void* out2;
  int B, N, M;
  long long row_bytes, row_bytes2;
  cudaStream_t stream;
};

template <typename T, typename U>
int launch(const Rows& r) {
  const int units = static_cast<int>(r.row_bytes / sizeof(T));
  const int units2 = static_cast<int>(r.row_bytes2 / sizeof(U));
  const int widest = units > units2 ? units : units2;
  int group_log2 = 0;
  while (group_log2 < 5 && (1 << group_log2) < widest) ++group_log2;
  const int rows_per_block = kThreads >> group_log2;
  const dim3 grid((r.M + rows_per_block - 1) / rows_per_block, r.B);
  gather_rows_kernel<T, U><<<grid, kThreads, 0, r.stream>>>(
      static_cast<const T*>(r.table), static_cast<const U*>(r.table2),
      static_cast<const int*>(r.idx), static_cast<T*>(r.out), static_cast<U*>(r.out2), r.N, r.M,
      units, units2, group_log2);
  return static_cast<int>(cudaGetLastError());
}

// The second table's unit: 4, 2 or 1 bytes, whichever divides its row
// and both its pointers (4 for float32 coordinates; any with no second table).
template <typename T>
int launch_second(const Rows& r) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(r.table2) |
                         reinterpret_cast<uintptr_t>(r.out2) |
                         static_cast<uintptr_t>(r.row_bytes2);
  if (bits % 4 == 0) return launch<T, uint32_t>(r);
  if (bits % 2 == 0) return launch<T, uint16_t>(r);
  return launch<T, uint8_t>(r);
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

// table (B, N, row_bytes bytes a row), idx (B, M) i32, out (B, M, row_bytes
// bytes a row); table2 and out2 the same with row_bytes2 bytes a row
// (row_bytes2 = 0: no second table, and the two pointers are not read).
// B <= 65535.
// Here and below `device` is the tensors' device, `stream` a stream of it.
extern "C" int pointseg_gather_rows(const void* table, const void* table2, const void* idx,
                                    void* out, void* out2, int B, int N, int M,
                                    long long row_bytes, long long row_bytes2, int device,
                                    void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  if (row_bytes < 0 || row_bytes2 < 0 || row_bytes > 2147483647LL ||
      row_bytes2 > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows r{table, table2, idx, out, out2, B, N, M, row_bytes, row_bytes2,
               static_cast<cudaStream_t>(stream)};
  const uintptr_t bits = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                         static_cast<uintptr_t>(row_bytes);
  if (bits % 16 == 0) return launch_second<uint4>(r);
  if (bits % 8 == 0) return launch_second<uint2>(r);
  if (bits % 4 == 0) return launch_second<uint32_t>(r);
  if (bits % 2 == 0) return launch_second<uint16_t>(r);
  return launch_second<uint8_t>(r);
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
