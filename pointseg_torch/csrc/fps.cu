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
// touches 16 bytes a point, so at the training shapes (N <= 4096, 64 KB)
// it is latency, not bandwidth: the distance update (about twelve
// instructions a point, some 400 issue cycles of an SM's four schedulers
// at N = 4096), then the argmax's reductions, barrier and the read of the
// next centroid. Only B of the 132 SMs have work.
//
// What the design does about it (`fps_register_kernel`, clouds of up to
// kMaxRegisterPoints points):
// - each thread keeps P neighbouring points (thread t points t * P to
//   t * P + P - 1) and their running minima in registers, so a step reads
//   no memory but the centroid; the kernel is a template on (threads, P);
// - the argmax is one warp reduction (`redux.sync`) and a ballot: a
//   distance maps to an order-preserving uint32 key (distances are >= 0
//   or +-inf), the warp takes the largest key, and the lowest lane that
//   holds it wins, which is the lowest index because a lower lane (and a
//   lower warp) holds lower indices; within a thread a tree of compares
//   (log2(P) deep, where a serial scan would be P deep) keeps the first
//   maximum;
// - one barrier a step: the winning lane of each warp writes the warp's
//   candidate into slot [step & 1][warp], and after one __syncthreads
//   every warp reduces the <= 32 candidates itself. The two slot sets
//   alternate, so a warp that runs ahead into the next step never
//   overwrites a slot another warp is still reading (to reach the step
//   after that it must pass a barrier that every warp reaches only after
//   its read). A block of one warp needs no barrier and no second level;
// - the next centroid is a broadcast read of a copy of the coordinates in
//   shared memory; the picks stay in shared memory and go to global memory
//   once, coalesced, at the end.
// The block size comes from pick_threads() (from the sweep of 32 to 1024
// threads at the training stages that chip_smoke.py prints; `threads`
// forces one, for that measurement).
//
// Larger clouds (the eval buckets, N up to 65536) take `fps_kernel`: the
// cloud's coordinates and distances in shared memory while they fit
// (N <= kMaxSmemPoints), in global memory (a scratch array, L2-resident)
// above, each thread its strided points, a warp-shuffle argmax and two
// __syncthreads a step.
//
// The arithmetic uses __fmul_rn/__fadd_rn/__fsub_rn, so no FMA
// contraction changes the rounding against the plain PyTorch version.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmemPoints = 12288;  // x, y, z, dist: 16 B a point, 192 KB
constexpr int kMaxRegisterPoints = 8192;
// dynamic shared memory a block may take, less room for the static slots
constexpr size_t kMaxDynamicSmem = 227 * 1024 - 1024;

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

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// An unsigned key in the order of the floats: the sign bit set for
// non-negative values, every bit flipped for negative ones (-inf).
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned u = __float_as_uint(d);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

// The lowest lane whose key is the warp's largest, and that key.
__device__ __forceinline__ int warp_argmax_lane(unsigned key, unsigned& best) {
  best = __reduce_max_sync(0xffffffffu, key);
  return __ffs(__ballot_sync(0xffffffffu, key == best)) - 1;
}

template <int kThreads, int P>
__launch_bounds__(kThreads)
__global__ void fps_register_kernel(const float* __restrict__ coords,
                                    const int* __restrict__ start,
                                    const bool* __restrict__ mask, int* __restrict__ out,
                                    int N, int C) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float smem[];
  __shared__ unsigned s_key[2][kWarps];
  __shared__ int s_idx[2][kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = coords + static_cast<size_t>(b) * N * 3;
  const bool* valid = mask ? mask + static_cast<size_t>(b) * N : nullptr;
  float* xs = smem;
  float* ys = smem + N;
  float* zs = smem + 2 * N;
  int* picks = reinterpret_cast<int*>(smem + 3 * N);

  for (int i = tid; i < N; i += kThreads) {  // coalesced, into the shared copy
    xs[i] = pts[3 * i];
    ys[i] = pts[3 * i + 1];
    zs[i] = pts[3 * i + 2];
  }
  __syncthreads();
  // thread t holds points t * P .. t * P + P - 1: a lower lane, and a lower
  // warp, holds lower indices
  float x[P], y[P], z[P], dist[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = tid * P + j;
    if (i < N) {
      x[j] = xs[i];
      y[j] = ys[i];
      z[j] = zs[i];
      dist[j] = (valid == nullptr || valid[i]) ? CUDART_INF_F : -CUDART_INF_F;
    } else {
      // a slot past the cloud: -inf stays -inf under fminf, and loses
      // every tie to a point of the cloud, whose index is lower
      x[j] = y[j] = z[j] = 0.0f;
      dist[j] = -CUDART_INF_F;
    }
  }

  int far = min(max(start[b], 0), N - 1);
  for (int step = 0; step < C; ++step) {
    if (tid == 0) picks[step] = far;
    if (step == C - 1) break;
    const float cx = xs[far], cy = ys[far], cz = zs[far];

    // the thread's argmax as a tree, log2(P) compares deep rather than P:
    // of two candidates the higher-index one wins only if strictly larger,
    // so the first maximum wins
    float md[P];
    int mj[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      dist[j] = fminf(dist[j], sq_dist(x[j], y[j], z[j], cx, cy, cz));
      md[j] = dist[j];
      mj[j] = j;
    }
#pragma unroll
    for (int width = 1; width < P; width *= 2) {
#pragma unroll
      for (int j = 0; j + width < P; j += 2 * width) {
        if (md[j + width] > md[j]) {
          md[j] = md[j + width];
          mj[j] = mj[j + width];
        }
      }
    }
    const int bi = tid * P + mj[0];

    unsigned best;
    const int winner = warp_argmax_lane(order_key(md[0]), best);
    if constexpr (kWarps == 1) {
      far = __shfl_sync(0xffffffffu, bi, winner);
    } else {
      const int slot = step & 1;
      if (lane == winner) {
        s_key[slot][warp] = best;
        s_idx[slot][warp] = bi;
      }
      __syncthreads();
      // key 0 lies below every distance's key (that of -inf is 0x007fffff)
      const unsigned key = lane < kWarps ? s_key[slot][lane] : 0u;
      far = s_idx[slot][warp_argmax_lane(key, best)];
    }
  }
  __syncthreads();
  for (int s = tid; s < C; s += kThreads) out[static_cast<size_t>(b) * C + s] = picks[s];
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
      const float nd = fminf(dist[i], sq_dist(x, y, z, cx, cy, cz));
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

// Points a thread may hold in registers at a block size: 1024 threads
// leave 64 registers a thread, 512 leave 128 (P = 16 at 1024 threads
// spills; it exists to be measured against fps_kernel at N = 16384).
constexpr int max_points(int threads) { return threads >= 512 ? 16 : 32; }

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

struct Args {
  const float* coords;
  const int* start;
  const bool* mask;
  int* out;
  int B, N, C;
  cudaStream_t stream;
};

template <int kThreads, int P>
int launch_register(const Args& a, int points) {
  if constexpr (P > max_points(kThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (P < points) return launch_register<kThreads, 2 * P>(a, points);
    const size_t smem = (3 * static_cast<size_t>(a.N) + a.C) * sizeof(float);
    if (const int err = set_smem(fps_register_kernel<kThreads, P>, smem)) return err;
    fps_register_kernel<kThreads, P><<<a.B, kThreads, smem, a.stream>>>(
        a.coords, a.start, a.mask, a.out, a.N, a.C);
    return static_cast<int>(cudaGetLastError());
  }
}

// Points a thread holds at `threads` threads: the power of two that
// covers N, or 0 where that is over the register budget or the copy of
// the coordinates and the picks is over the shared memory.
int points_per_thread(int threads, int N, int C) {
  int points = 1;
  while (points <= 32 && points * threads < N) points *= 2;
  const size_t smem = (3 * static_cast<size_t>(N) + C) * sizeof(float);
  return points <= max_points(threads) && smem <= kMaxDynamicSmem ? points : 0;
}

// The block size of the register path for an N-point cloud.
int pick_threads(int N) {
  if (N <= 256) return 32;
  if (N <= 4096) return 256;
  return 512;
}

}  // namespace

// coords (B, N, 3) f32, start (B,) i32, mask (B, N) bool or null,
// out (B, C) i32, dist_scratch (B, N) f32 (used when N > kMaxSmemPoints
// and the cloud takes fps_kernel; may be null otherwise); threads: 0 for
// the default choice, 32, 64, 128, 256, 512 or 1024 to force the
// register path at that block size (an error where the cloud does not
// fit it), or -1 to force fps_kernel.
// `device` is the tensors' device, `stream` a stream of it.
extern "C" int pointseg_fps(const void* coords, const void* start, const void* mask,
                            void* out, void* dist_scratch, int B, int N, int C, int threads,
                            int device, void* stream) {
  const DeviceScope scope(device);
  if (scope.status() != 0) return scope.status();
  const Args a{static_cast<const float*>(coords), static_cast<const int*>(start),
               static_cast<const bool*>(mask), static_cast<int*>(out), B, N, C,
               static_cast<cudaStream_t>(stream)};
  const int chosen = threads ? threads : pick_threads(N);
  const int points = chosen > 0 ? points_per_thread(chosen, N, C) : 0;
  if (threads > 0 || (threads == 0 && N <= kMaxRegisterPoints && points)) {
    switch (points ? chosen : 0) {
      case 32: return launch_register<32, 1>(a, points);
      case 64: return launch_register<64, 1>(a, points);
      case 128: return launch_register<128, 1>(a, points);
      case 256: return launch_register<256, 1>(a, points);
      case 512: return launch_register<512, 1>(a, points);
      case 1024: return launch_register<1024, 1>(a, points);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int nthreads = std::min(kMaxThreads, ((N + 31) / 32) * 32);
  const bool in_smem = N <= kMaxSmemPoints;
  if (!in_smem && dist_scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = in_smem ? static_cast<size_t>(N) * 4 * sizeof(float) : 0;
  if (const int err = set_smem(fps_kernel, smem)) return err;
  fps_kernel<<<B, nthreads, smem, a.stream>>>(a.coords, a.start, a.mask, a.out,
                                              static_cast<float*>(dist_scratch), N, C, in_smem);
  return static_cast<int>(cudaGetLastError());
}
