// Farthest point sampling: one thread block per cloud, all C steps in
// one launch.
//
// Replaces pointseg/ops/pallas/fps.py::farthest_point_sampling_pallas
// (kernel `_fps_kernel`). Same result: a running minimum squared
// distance per point starting at +inf (-inf for points a mask excludes),
// distances in difference form (dx*dx + dy*dy) + dz*dz, and a
// first-occurrence argmax, so ties go to the lowest index.
//
// What bounds it on the H100: the C steps form a serial chain, and each
// step ends in a block-wide argmax that every thread waits for. A step
// touches 16 bytes a point, so at the slice's shapes (N <= 4096, 64 KB)
// it is the barrier and reduction latency, not bandwidth, that sets the
// time; and only B of the 132 SMs have work.
//
// What the design does about it: the cloud's coordinates (as three
// planes) and its distance buffer live in shared memory when they fit
// (N <= kMaxSmemPoints), each thread keeps its own strided points, so
// the distance update needs no barrier, and a step costs one warp-shuffle
// argmax plus two __syncthreads. Larger clouds (eval buckets reach
// N = 65536) keep the distance buffer in a global scratch array and read
// coordinates from global memory, where they stay L2-resident. The
// arithmetic uses __fmul_rn/__fadd_rn/__fsub_rn, so no FMA contraction
// changes the rounding against the plain PyTorch version.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmemPoints = 12288;  // x, y, z, dist: 16 B a point, 192 KB

// Larger distance wins; at equal distance the lower index wins.
__device__ __forceinline__ bool farther(float d, int i, float bd, int bi) {
  return d > bd || (d == bd && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& d, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (farther(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

__global__ void fps_kernel(const float* __restrict__ coords,
                           const int* __restrict__ start,
                           const bool* __restrict__ mask,
                           int* __restrict__ out,
                           float* __restrict__ dist_scratch,
                           int N, int C, bool in_smem) {
  extern __shared__ float smem[];
  __shared__ float s_best_d[32];
  __shared__ int s_best_i[32];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;

  const float* pts = coords + static_cast<size_t>(b) * N * 3;
  const bool* valid = mask ? mask + static_cast<size_t>(b) * N : nullptr;
  float* xs = smem;
  float* ys = smem + N;
  float* zs = smem + 2 * N;
  float* dist = in_smem ? smem + 3 * N : dist_scratch + static_cast<size_t>(b) * N;

  for (int i = tid; i < N; i += nthreads) {
    if (in_smem) {
      xs[i] = pts[3 * i];
      ys[i] = pts[3 * i + 1];
      zs[i] = pts[3 * i + 2];
    }
    dist[i] = (valid == nullptr || valid[i]) ? CUDART_INF_F : -CUDART_INF_F;
  }
  __syncthreads();

  int far = min(max(start[b], 0), N - 1);
  for (int step = 0; step < C; ++step) {
    if (tid == 0) out[static_cast<size_t>(b) * C + step] = far;
    if (step == C - 1) break;

    float cx, cy, cz;
    if (in_smem) {
      cx = xs[far];
      cy = ys[far];
      cz = zs[far];
    } else {
      cx = pts[3 * far];
      cy = pts[3 * far + 1];
      cz = pts[3 * far + 2];
    }

    float bd = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int i = tid; i < N; i += nthreads) {
      float x, y, z;
      if (in_smem) {
        x = xs[i];
        y = ys[i];
        z = zs[i];
      } else {
        x = pts[3 * i];
        y = pts[3 * i + 1];
        z = pts[3 * i + 2];
      }
      const float dx = __fsub_rn(x, cx);
      const float dy = __fsub_rn(y, cy);
      const float dz = __fsub_rn(z, cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float nd = fminf(dist[i], d);
      dist[i] = nd;
      if (farther(nd, i, bd, bi)) {
        bd = nd;
        bi = i;
      }
    }

    warp_argmax(bd, bi);
    if (lane == 0) {
      s_best_d[warp] = bd;
      s_best_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bd = lane < nwarps ? s_best_d[lane] : -CUDART_INF_F;
      bi = lane < nwarps ? s_best_i[lane] : INT_MAX;
      warp_argmax(bd, bi);
      if (lane == 0) s_far = bi;
    }
    __syncthreads();
    far = s_far;
  }
}

}  // namespace

// coords (B, N, 3) f32, start (B,) i32, mask (B, N) bool or null,
// out (B, C) i32, dist_scratch (B, N) f32 (used when N > kMaxSmemPoints).
extern "C" int pointseg_fps(const void* coords, const void* start, const void* mask,
                            void* out, void* dist_scratch, int B, int N, int C,
                            void* stream) {
  const int threads = std::min(kMaxThreads, ((N + 31) / 32) * 32);
  const bool in_smem = N <= kMaxSmemPoints;
  const size_t smem = in_smem ? static_cast<size_t>(N) * 4 * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fps_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const int*>(start),
      static_cast<const bool*>(mask), static_cast<int*>(out),
      static_cast<float*>(dist_scratch), N, C, in_smem);
  return static_cast<int>(cudaGetLastError());
}
