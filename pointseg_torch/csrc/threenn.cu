// Three nearest sources for every target point.
//
// Replaces pointseg/ops/pallas/threenn.py::three_nn_pallas (kernel
// `_threenn_kernel`). Same result: the 3 smallest Gram-form squared
// distances max((|q|^2 - 2 q.s) + |s|^2, 0) in f32, ascending, ties to
// the lowest source index, with their indices. Sources a mask excludes
// count as +inf, so a target with fewer than 3 valid sources takes the
// lowest-index excluded ones after them. The arithmetic is written with
// __fmul_rn and __fadd_rn so that it rounds as the plain PyTorch version
// does; the clamp is fmaxf (a NaN distance becomes 0).
//
// What bounds it on the H100: B*N*M distance evaluations, 8 rounded FP
// instructions and one compare each when kept exact; the inputs are 12
// bytes a point. At the FP1 shape (B=8, N=4096, M=1024) that is 34M pairs,
// some 9 us of issue at 132 SMs x 128 lanes, so issue rate and latency,
// not memory, set the time.
//
// What the design does about it: a block stages the cloud's sources
// through shared memory (x, y, z, |s|^2 as one float4, |s|^2 = +inf when
// masked) in kTile-point tiles, so any M fits. A warp takes G targets and
// its lanes 32 neighbouring sources at a time, so one 16-byte load of a
// source serves G independent rounding chains. Each target's three best
// are the same in every lane of the warp, so the test of a source against
// the third best (!(raw > d2), which is fmaxf(raw, 0) <= d2, NaN included)
// needs no clamp and no branch of its own: one vote a chunk of 32 sources
// asks whether any target can take any of them. That is rare after the
// first chunk (some 3 ln(M / 32) chunks of M / 32), and a thread-per-target
// design paid for it far more often: there every lane's own list entered
// the warp's divergent insertion path, on most sources. A chunk's
// candidates enter nearest first, each found by one warp-wide minimum of
// an order-preserving key (`redux.sync`) and a ballot for the lowest lane
// that holds it, and each through the exact comparison; the first one
// that does not enter ends the chunk. pick() sizes G and
// the warps a block from the shape; neither changes the result.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kTile = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// Three best, ascending; empty slots are (+inf, INT_MAX).
struct Best3 {
  float d0, d1, d2;
  int i0, i1, i2;

  // Whether (d, i) goes in front of the third, for a candidate whose index
  // is above that of every listed entry at its distance: a source of a
  // later chunk, or of this chunk after the nearer ones. Then an equal
  // distance loses, and only an empty slot is taken at +inf.
  __device__ __forceinline__ bool takes(float d) const { return d < d2 || i2 == INT_MAX; }

  // Inserts such a candidate, which takes(d).
  __device__ __forceinline__ void insert_later(float d, int i) {
    const bool n1 = d < d1 || i1 == INT_MAX, n0 = d < d0 || i0 == INT_MAX;
    d2 = n1 ? d1 : d;
    i2 = n1 ? i1 : i;
    d1 = n0 ? d0 : (n1 ? d : d1);
    i1 = n0 ? i0 : (n1 ? i : i1);
    d0 = n0 ? d : d0;
    i0 = n0 ? i : i0;
  }
};

// (|q|^2 - 2 q.s) + |s|^2 before the clamp, rounded step by step.
__device__ __forceinline__ float gram_sqdist(float qx, float qy, float qz, float q2, float4 p) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)), __fmul_rn(qz, p.z));
  return __fadd_rn(__fsub_rn(q2, __fmul_rn(2.f, cross)), p.w);
}

// The sources of one chunk (source `first` + lane, `here` within the
// cloud, at raw distance `raw`) that enter a target's list, nearest first:
// a single candidate by a shuffle, several by warp-wide minima of an
// order-preserving key (`redux.sync`) and a ballot for the lowest lane
// holding it. The first candidate that does not enter ends the chunk: the
// others are no nearer.
__device__ __forceinline__ void take_chunk(Best3& best, float raw, bool here, int first) {
  const int lane = threadIdx.x & 31;
  const bool cand = here && !(raw > best.d2);
  unsigned bits = __ballot_sync(kFull, cand);
  if (!bits) return;
  const float d = fmaxf(raw, 0.f);
  if ((bits & (bits - 1)) == 0) {
    const int from = __ffs(bits) - 1;
    const float fd = __shfl_sync(kFull, d, from);
    if (best.takes(fd)) best.insert_later(fd, first + from);
    return;
  }
  // d >= 0, or -0 (equal to +0), or +inf: its bits order as the values
  const unsigned key = cand ? __float_as_uint(d) & 0x7fffffffu : ~0u;
  while (bits) {
    const unsigned least = __reduce_min_sync(kFull, (bits >> lane) & 1u ? key : ~0u);
    const int from = __ffs(__ballot_sync(kFull, ((bits >> lane) & 1u) && key == least)) - 1;
    const float fd = __shfl_sync(kFull, d, from);
    if (!best.takes(fd)) return;
    best.insert_later(fd, first + from);
    bits &= ~(1u << from);
  }
}

// G targets a warp, its lanes 32 neighbouring sources at a time. Each
// target's three best are uniform across the warp: one vote a chunk asks
// whether any source of the chunk can enter any of the G lists, and only
// then do the lists take their candidates (take_chunk).
template <int G>
__launch_bounds__(kMaxWarps * 32)
__global__ void three_nn_kernel(const float* __restrict__ tgt,
                                const float* __restrict__ src,
                                const bool* __restrict__ src_mask,
                                float* __restrict__ out_d, int* __restrict__ out_i, int N,
                                int M) {
  __shared__ float4 tile[kTile];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * G;  // first target

  float qx[G], qy[G], qz[G], q2[G];
  Best3 best[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qx[g] = qy[g] = qz[g] = q2[g] = 0.f;
    if (n0 + g < N) {
      const float* q = tgt + (static_cast<size_t>(b) * N + n0 + g) * 3;
      qx[g] = q[0];
      qy[g] = q[1];
      qz[g] = q[2];
      q2[g] = sqnorm(qx[g], qy[g], qz[g]);
    }
    best[g] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, INT_MAX, INT_MAX, INT_MAX};
  }

  const float* pts = src + static_cast<size_t>(b) * M * 3;
  const bool* valid = src_mask ? src_mask + static_cast<size_t>(b) * M : nullptr;
  for (int base = 0; base < M; base += kTile) {
    const int m = min(kTile, M - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      float4 p;
      p.x = __ldg(pts + 3 * (base + j));
      p.y = __ldg(pts + 3 * (base + j) + 1);
      p.z = __ldg(pts + 3 * (base + j) + 2);
      // an excluded source gets |s|^2 = +inf, so its distance is +inf
      p.w = (valid == nullptr || valid[base + j]) ? sqnorm(p.x, p.y, p.z) : CUDART_INF_F;
      tile[j] = p;
    }
    __syncthreads();

    // two chunks of 32 sources an iteration: twice the independent chains
    for (int j0 = 0; j0 < m; j0 += 64) {
      const bool here0 = j0 + lane < m, here1 = j0 + 32 + lane < m;
      const float4 p0 = tile[here0 ? j0 + lane : 0];
      const float4 p1 = tile[here1 ? j0 + 32 + lane : 0];
      float raw0[G], raw1[G];
      bool hit = false;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        raw0[g] = gram_sqdist(qx[g], qy[g], qz[g], q2[g], p0);
        raw1[g] = gram_sqdist(qx[g], qy[g], qz[g], q2[g], p1);
        // !(raw > d2) is fmaxf(raw, 0) <= d2, NaN included
        hit |= (here0 && !(raw0[g] > best[g].d2)) | (here1 && !(raw1[g] > best[g].d2));
      }
      if (!__any_sync(kFull, hit)) continue;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        take_chunk(best[g], raw0[g], here0, base + j0);
        take_chunk(best[g], raw1[g], here1, base + j0 + 32);
      }
    }
  }

  if (lane >= 3) return;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (n0 + g >= N) break;
    const size_t o = (static_cast<size_t>(b) * N + n0 + g) * 3 + lane;
    out_d[o] = lane == 0 ? best[g].d0 : lane == 1 ? best[g].d1 : best[g].d2;
    out_i[o] = lane == 0 ? best[g].i0 : lane == 1 ? best[g].i1 : best[g].i2;
  }
}

// Targets a warp (G) and warps a block (W) for a shape, from the sweep
// that chip_smoke.py prints (NVIDIA H100 80GB HBM3, 700 W): G halves from
// 4 while the launch has fewer than 4096 warps (31 an SM); W is 16 at
// G = 4, else 8.
void pick(int B, int N, int& G, int& W) {
  const long long targets = static_cast<long long>(B) * N;
  G = 4;
  while (G > 1 && targets / G < 4096) G >>= 1;
  W = G == 4 ? 16 : 8;
}

template <int G>
int launch(const void* tgt, const void* src, const void* src_mask, void* out_d, void* out_i,
           int B, int N, int M, int W, cudaStream_t stream) {
  const int per_block = W * G;
  const dim3 grid((N + per_block - 1) / per_block, B);
  three_nn_kernel<G><<<grid, W * 32, 0, stream>>>(
      static_cast<const float*>(tgt), static_cast<const float*>(src),
      static_cast<const bool*>(src_mask), static_cast<float*>(out_d), static_cast<int*>(out_i),
      N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tgt (B, N, 3) f32, src (B, M, 3) f32, src_mask (B, M) bool or null,
// out_d (B, N, 3) f32, out_i (B, N, 3) i32. Needs M >= 3. `targets` (1, 2,
// 4 or 8 a warp) and `warps` (a block, up to 16) force the split; 0 lets
// pick() choose. `device` is the tensors' device, `stream` a stream of it.
extern "C" int pointseg_three_nn(const void* tgt, const void* src, const void* src_mask,
                                 void* out_d, void* out_i, int B, int N, int M, int targets,
                                 int warps, int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  int G, W;
  pick(B, N, G, W);
  G = targets ? targets : G;
  W = warps ? warps : W;
  if (W < 1 || W > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1:
      return launch<1>(tgt, src, src_mask, out_d, out_i, B, N, M, W, s);
    case 2:
      return launch<2>(tgt, src, src_mask, out_d, out_i, B, N, M, W, s);
    case 4:
      return launch<4>(tgt, src, src_mask, out_d, out_i, B, N, M, W, s);
    case 8:
      return launch<8>(tgt, src, src_mask, out_d, out_i, B, N, M, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
