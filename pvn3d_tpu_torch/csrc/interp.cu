// K3: exact 3-NN + inverse-distance-weighted blend (forward).
//
// Replaces pvn3d_tpu/ops/pallas/interp.py::three_interpolate_fused
// (_fused_fwd / _interp_kernel).  Semantics: for each unknown point, the 3
// known points smallest in lexicographic (d^2, index) order (the reference
// running top-3 of interpolate_gpu.cu:24-38: equal distances keep the lower
// index first); weights 1/(d + eps) normalised over the three; the blend of
// the known features.  With m < 3 the empty slots keep index 0 and
// d^2 = 1e30 (the reference's initialised slots), so their weight is ~0.
// Returns out (B, n, C), dist (B, n, 3) and idx (B, n, 3).
//
// Bound: operations of the search.  n * m distance evaluations (fp0:
// 12288 x 2048 = 25M, ~9 flops each) against n*C*4 output bytes (fp0:
// 12.6 MB) and m*C*4 feature bytes read.  Design: one thread per unknown
// keeps a running top-3 with strict '<' while scanning known points in
// index order from shared-memory tiles (every thread of the block reads
// the same point: broadcast); the block then writes its rows' blended
// features with threads along the channel axis, so feature reads and
// output writes are coalesced.  The TPU kernel's blend was a bf16 MXU
// matmul; this one is float32: (w0*f0 + w1*f1) + w2*f2.
//
// d^2 is ((dx*dx)+(dy*dy))+(dz*dz) with round-to-nearest intrinsics: no FMA
// contraction, so neighbour order equals the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;
constexpr float kEmpty = 1e30f;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
    three_interp_kernel(const float* __restrict__ unknown,
                        const float* __restrict__ known,
                        const float* __restrict__ feats, int n, int m, int c,
                        float eps, float* __restrict__ out,
                        float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ int s_i[kThreads][3];
  __shared__ float s_w[kThreads][3];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kThreads;
  const int r = row0 + threadIdx.x;
  const bool active = r < n;
  const size_t urow = static_cast<size_t>(b) * n + r;
  const float* kp = known + static_cast<size_t>(b) * m * 3;

  float ux = 0.f, uy = 0.f, uz = 0.f;
  if (active) {
    ux = unknown[3 * urow];
    uy = unknown[3 * urow + 1];
    uz = unknown[3 * urow + 2];
  }
  float b0 = kEmpty, b1 = kEmpty, b2 = kEmpty;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int base = 0; base < m; base += kTile) {
    const int lim = min(kTile, m - base);
    __syncthreads();
    for (int t = threadIdx.x; t < lim; t += kThreads) {
      sx[t] = kp[3 * (base + t)];
      sy[t] = kp[3 * (base + t) + 1];
      sz[t] = kp[3 * (base + t) + 2];
    }
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < lim; ++k) {
      const float d = sqdist(ux, uy, uz, sx[k], sy[k], sz[k]);
      if (d < b0) {
        b2 = b1; i2 = i1;
        b1 = b0; i1 = i0;
        b0 = d; i0 = base + k;
      } else if (d < b1) {
        b2 = b1; i2 = i1;
        b1 = d; i1 = base + k;
      } else if (d < b2) {
        b2 = d; i2 = base + k;
      }
    }
  }
  if (active) {
    const float d0 = sqrtf(fmaxf(b0, 0.f));
    const float d1 = sqrtf(fmaxf(b1, 0.f));
    const float d2 = sqrtf(fmaxf(b2, 0.f));
    const float r0 = 1.f / (d0 + eps);
    const float r1 = 1.f / (d1 + eps);
    const float r2 = 1.f / (d2 + eps);
    const float sum = (r0 + r1) + r2;
    s_w[threadIdx.x][0] = r0 / sum;
    s_w[threadIdx.x][1] = r1 / sum;
    s_w[threadIdx.x][2] = r2 / sum;
    s_i[threadIdx.x][0] = i0;
    s_i[threadIdx.x][1] = i1;
    s_i[threadIdx.x][2] = i2;
    dist[3 * urow] = d0;
    dist[3 * urow + 1] = d1;
    dist[3 * urow + 2] = d2;
    idx[3 * urow] = i0;
    idx[3 * urow + 1] = i1;
    idx[3 * urow + 2] = i2;
  }
  __syncthreads();

  const int rows = min(kThreads, n - row0);
  const float* f = feats + static_cast<size_t>(b) * m * c;
  float* o = out + (static_cast<size_t>(b) * n + row0) * c;
  for (int t = threadIdx.x; t < rows * c; t += kThreads) {
    const int rr = t / c;
    const int ch = t - rr * c;
    const float f0 = f[static_cast<size_t>(s_i[rr][0]) * c + ch];
    const float f1 = f[static_cast<size_t>(s_i[rr][1]) * c + ch];
    const float f2 = f[static_cast<size_t>(s_i[rr][2]) * c + ch];
    o[static_cast<size_t>(rr) * c + ch] = __fadd_rn(
        __fadd_rn(__fmul_rn(s_w[rr][0], f0), __fmul_rn(s_w[rr][1], f1)),
        __fmul_rn(s_w[rr][2], f2));
  }
}

}  // namespace

extern "C" int three_interp_launch(const float* unknown, const float* known,
                                   const float* feats, int b, int n, int m,
                                   int c, float eps, float* out, float* dist,
                                   int* idx, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b), block(kThreads);
  three_interp_kernel<<<grid, block, 0, stream>>>(unknown, known, feats, n, m,
                                                  c, eps, out, dist, idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
