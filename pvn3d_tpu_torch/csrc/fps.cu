// K1: iterative farthest-point sampling, one thread block per batch row.
//
// Replaces pvn3d_tpu/ops/pallas/fps.py::fps_pallas (_fps_kernel_wide at
// B <= 2, _fps_kernel at B > 2).  Semantics (sampling_gpu.cu:92-110 of the
// reference): sample 0 is index 0; each step updates a per-point min-d^2
// cache against the last pick and takes the argmax, lowest index on ties;
// points with |p|^2 <= 1e-3 never win and never update the cache; a row
// where every point is skipped yields 0.
//
// Bound: latency.  npoint-1 dependent steps, each an O(N) update plus a
// block-wide argmax; at N=12288, m=2048 the whole row is ~150 KB of data
// and ~0.2 GFLOP, so neither bytes nor operations bound it, the chain of
// 2047 block barriers does.  Design: 1024 threads hold the row's points and
// their min-d^2 cache in registers (PER points each, a template constant),
// so a step reads no memory beyond the picked point; the argmax is a warp
// shuffle reduction plus one shared-memory round, two barriers per step.
// Rows longer than 12 * 1024 points keep the cache in a global scratch row.
//
// d^2 is ((dx*dx)+(dy*dy))+(dz*dz) with round-to-nearest intrinsics, so
// nvcc cannot contract it into FMAs and it equals the plain version's.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Points per thread on the register path: 12 * 1024 = 12288, the serving
// path's row, with no spills.
constexpr int kRegisterPer = 12;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) <- max of (v, i) and (v2, i2): larger value, lower index on ties.
__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Initial cache value: skipped points and padding hold -inf, which no
// min() ever raises and which loses every argmax to a real cache value;
// in a row where every point is skipped the lowest index (point 0) wins,
// as in the reference.
__device__ __forceinline__ float initial_min(float x, float y, float z,
                                             bool in_row) {
  const float mag =
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return (in_row && !(mag <= 1e-3f)) ? 1e10f : -CUDART_INF_F;
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, int n, int m,
               int* __restrict__ out, float* __restrict__ scratch) {
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* o = out + static_cast<size_t>(blockIdx.x) * m;
  float* cache = scratch + static_cast<size_t>(blockIdx.x) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_best;

  // PER > 0: this thread's points j = tid + k * kThreads live in registers.
  float px[PER > 0 ? PER : 1], py[PER > 0 ? PER : 1], pz[PER > 0 ? PER : 1];
  float mind[PER > 0 ? PER : 1];
  if constexpr (PER > 0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid + k * kThreads;
      const bool in_row = j < n;
      px[k] = in_row ? p[3 * j] : 0.f;
      py[k] = in_row ? p[3 * j + 1] : 0.f;
      pz[k] = in_row ? p[3 * j + 2] : 0.f;
      mind[k] = initial_min(px[k], py[k], pz[k], in_row);
    }
  } else {
    for (int j = tid; j < n; j += kThreads) {
      cache[j] = initial_min(p[3 * j], p[3 * j + 1], p[3 * j + 2], true);
    }
  }
  if (tid == 0) o[0] = 0;

  int last = 0;
  for (int i = 1; i < m; ++i) {
    const float lx = p[3 * last], ly = p[3 * last + 1], lz = p[3 * last + 2];
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    if constexpr (PER > 0) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const float d = sqdist(px[k], py[k], pz[k], lx, ly, lz);
        mind[k] = fminf(mind[k], d);
        const int j = tid + k * kThreads;
        if (j < n) take_better(bv, bi, mind[k], j);
      }
    } else {
      for (int j = tid; j < n; j += kThreads) {
        const float d =
            sqdist(p[3 * j], p[3 * j + 1], p[3 * j + 2], lx, ly, lz);
        const float c = fminf(cache[j], d);
        cache[j] = c;
        take_better(bv, bi, c, j);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, bv, off);
      const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
      take_better(bv, bi, v2, i2);
    }
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_val[lane];
      bi = s_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(0xffffffffu, bv, off);
        const int i2 = __shfl_down_sync(0xffffffffu, bi, off);
        take_better(bv, bi, v2, i2);
      }
      if (lane == 0) {
        const int nxt = bi == INT_MAX ? 0 : bi;
        s_best = nxt;
        o[i] = nxt;
      }
    }
    __syncthreads();
    last = s_best;
  }
}

}  // namespace

extern "C" int fps_launch(const float* xyz, int b, int n, int m, int* out,
                          float* scratch, cudaStream_t stream) {
  const dim3 grid(b), block(kThreads);
  if (n <= kRegisterPer * kThreads) {
    fps_kernel<kRegisterPer><<<grid, block, 0, stream>>>(xyz, n, m, out,
                                                         scratch);
  } else {
    fps_kernel<0><<<grid, block, 0, stream>>>(xyz, n, m, out, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
