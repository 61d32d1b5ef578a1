// Batched row gather: out[b, m, :] = table[b, idx[b, m], :].
//
// Replaces pointseg/ops/pallas/gather.py::gather_rows_dma (`_dma_kernel`),
// which starts one DMA per output row. Forward only, as there; the
// gradient is a scatter-add outside the kernel.
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

}  // namespace

// table (B, N, C) of 4-byte elements, idx (B, M) i32, out (B, M, C). B <= 65535.
extern "C" int pointseg_gather_rows(const void* table, const void* idx, void* out, int B, int N,
                                    int M, int C, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (C % 4 == 0 && aligned) return launch<uint4>(table, idx, out, B, N, M, C / 4, s);
  return launch<uint32_t>(table, idx, out, B, N, M, C, s);
}
