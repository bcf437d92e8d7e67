// K2: exact multi-scale ball query, one thread per centroid.
//
// Replaces pvn3d_tpu/ops/pallas/query.py::ball_query_pallas
// (_query_kernel).  Semantics (ball_query_gpu.cu:26-43 of the reference):
// per centroid and scale, the first ns point indices in index order with
// d^2 < r^2 (strict); trailing slots repeat the first hit; 0 everywhere if
// nothing hits.  The TPU kernel was exact only up to query_capacity hits per
// residue class (a lane-layout artefact); this one is exact with no limit.
//
// Bound: operations on the scan.  Each centroid compares against points in
// index order until every scale holds ns hits, so the work is data
// dependent: at most m * N distance evaluations (L0: 2048 x 12288 = 25M,
// ~9 flops each), far less on a depth cloud whose small radii fill late.
// Bytes are tiny (N*12 in, m*(ns1+ns2)*4 out).  Design: the reference
// algorithm, with the block's points staged through shared memory in tiles
// that every thread of the block scans in the same order (broadcast reads),
// d^2 computed once for all scales, and the block leaving the scan as soon
// as all its centroids are full (__syncthreads_and).
//
// d^2 is ((dx*dx)+(dy*dy))+(dz*dz) with round-to-nearest intrinsics: no FMA
// contraction, so radius membership equals the plain version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kMaxScales = 4;

struct Scales {
  float r2[kMaxScales];
  int ns[kMaxScales];
  int* out[kMaxScales];
};

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ centers, int n, int m,
                      int n_scales, Scales sc) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < m;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const size_t crow = static_cast<size_t>(b) * m + row;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    cx = centers[3 * crow];
    cy = centers[3 * crow + 1];
    cz = centers[3 * crow + 2];
  }
  int cnt[kMaxScales];
  int* dst[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    cnt[s] = 0;
    dst[s] = s < n_scales ? sc.out[s] + crow * sc.ns[s] : nullptr;
  }
  bool done = !active;

  for (int base = 0; base < n; base += kTile) {
    if (__syncthreads_and(done)) break;
    const int lim = min(kTile, n - base);
    for (int t = threadIdx.x; t < lim; t += kThreads) {
      sx[t] = p[3 * (base + t)];
      sy[t] = p[3 * (base + t) + 1];
      sz[t] = p[3 * (base + t) + 2];
    }
    __syncthreads();
    for (int k = 0; k < lim && !done; ++k) {
      const float d2 = sqdist(cx, cy, cz, sx[k], sy[k], sz[k]);
      const int idx = base + k;
      bool full = true;
#pragma unroll
      for (int s = 0; s < kMaxScales; ++s) {
        if (s >= n_scales) break;
        const int ns = sc.ns[s];
        if (cnt[s] < ns && d2 < sc.r2[s]) {
          if (cnt[s] == 0) {
            for (int q = 0; q < ns; ++q) dst[s][q] = idx;
          }
          dst[s][cnt[s]] = idx;
          ++cnt[s];
        }
        full = full && cnt[s] == ns;
      }
      done = full;
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < kMaxScales; ++s) {
      if (s >= n_scales) break;
      if (cnt[s] == 0) {
        for (int q = 0; q < sc.ns[s]; ++q) dst[s][q] = 0;
      }
    }
  }
}

}  // namespace

// radii2/nsamples/outs hold n_scales entries (n_scales <= 4); each outs[s]
// is a (b, m, nsamples[s]) int32 buffer.
extern "C" int ball_query_launch(const float* xyz, const float* centers,
                                 int b, int n, int m, int n_scales,
                                 const float* radii2, const int* nsamples,
                                 int* const* outs, cudaStream_t stream) {
  if (n_scales < 1 || n_scales > kMaxScales) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Scales sc;
  for (int s = 0; s < kMaxScales; ++s) {
    const bool used = s < n_scales;
    sc.r2[s] = used ? radii2[s] : 0.f;
    sc.ns[s] = used ? nsamples[s] : 0;
    sc.out[s] = used ? outs[s] : nullptr;
  }
  const dim3 grid((m + kThreads - 1) / kThreads, b), block(kThreads);
  ball_query_kernel<<<grid, block, 0, stream>>>(xyz, centers, n, m, n_scales,
                                                sc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
