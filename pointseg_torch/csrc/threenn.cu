// Three nearest sources for every target point: one thread per target.
//
// Replaces pointseg/ops/pallas/threenn.py::three_nn_pallas (kernel
// `_threenn_kernel`). Same result: the 3 smallest Gram-form squared
// distances max((|q|^2 - 2 q.s) + |s|^2, 0) in f32, ascending, ties to
// the lowest source index, with their indices. Sources a mask excludes
// count as +inf. The arithmetic is written with __fmul_rn and __fadd_rn
// so that it rounds as the plain PyTorch version does.
//
// What bounds it on the H100: B*N*M distance evaluations (9 flops each)
// plus a 3-deep insertion per source; the inputs are 12 bytes a point.
// At the slice's largest shape (B=8, N=4096, M=1024) that is 34M
// distances, so issue rate and latency, not memory, set the time.
//
// What the design does about it: no (N, M) distance block is stored;
// each thread keeps its three best (d^2, index) pairs in registers. A
// block of kThreads targets from one cloud stages the sources through
// shared memory in kTile-point tiles (with |s|^2 precomputed), so every
// thread reads each source as a shared-memory broadcast and any M fits.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (d, i) sorts before (bd, bi)
__device__ __forceinline__ bool nearer(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void three_nn_kernel(const float* __restrict__ tgt,
                                const float* __restrict__ src,
                                const bool* __restrict__ src_mask,
                                float* __restrict__ out_d,
                                int* __restrict__ out_i,
                                int N, int M) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], s2[kTile];

  const int b = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = n < N;

  float qx = 0.f, qy = 0.f, qz = 0.f, q2 = 0.f;
  if (active) {
    const float* q = tgt + (static_cast<size_t>(b) * N + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
    q2 = sqnorm(qx, qy, qz);
  }

  float d0 = CUDART_INF_F, d1 = CUDART_INF_F, d2 = CUDART_INF_F;
  int i0 = INT_MAX, i1 = INT_MAX, i2 = INT_MAX;

  const float* pts = src + static_cast<size_t>(b) * M * 3;
  const bool* valid = src_mask ? src_mask + static_cast<size_t>(b) * M : nullptr;

  for (int base = 0; base < M; base += kTile) {
    const int m = min(kTile, M - base);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const float x = pts[3 * (base + j)];
      const float y = pts[3 * (base + j) + 1];
      const float z = pts[3 * (base + j) + 2];
      sx[j] = x;
      sy[j] = y;
      sz[j] = z;
      // an excluded source gets |s|^2 = +inf, so its distance is +inf
      s2[j] = (valid == nullptr || valid[base + j]) ? sqnorm(x, y, z) : CUDART_INF_F;
    }
    __syncthreads();
    if (!active) continue;

    for (int j = 0; j < m; ++j) {
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, sx[j]), __fmul_rn(qy, sy[j])), __fmul_rn(qz, sz[j]));
      const float d = fmaxf(__fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), s2[j]), 0.f);
      const int i = base + j;
      if (nearer(d, i, d2, i2)) {
        if (nearer(d, i, d1, i1)) {
          d2 = d1;
          i2 = i1;
          if (nearer(d, i, d0, i0)) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = i;
          } else {
            d1 = d;
            i1 = i;
          }
        } else {
          d2 = d;
          i2 = i;
        }
      }
    }
  }

  if (!active) return;
  const size_t o = (static_cast<size_t>(b) * N + n) * 3;
  out_d[o] = d0;
  out_d[o + 1] = d1;
  out_d[o + 2] = d2;
  out_i[o] = i0;
  out_i[o + 1] = i1;
  out_i[o + 2] = i2;
}

}  // namespace

// tgt (B, N, 3) f32, src (B, M, 3) f32, src_mask (B, M) bool or null,
// out_d (B, N, 3) f32, out_i (B, N, 3) i32. Needs M >= 3.
extern "C" int pointseg_three_nn(const void* tgt, const void* src, const void* src_mask,
                                 void* out_d, void* out_i, int B, int N, int M,
                                 void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  three_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tgt), static_cast<const float*>(src),
      static_cast<const bool*>(src_mask), static_cast<float*>(out_d),
      static_cast<int*>(out_i), N, M);
  return static_cast<int>(cudaGetLastError());
}
