// K2: exact multi-scale ball query, one warp per centroid.
//
// Replaces pvn3d_tpu/ops/pallas/query.py::ball_query_pallas
// (_query_kernel).  Semantics (ball_query_gpu.cu:26-43 of the reference):
// per centroid and scale, the first ns point indices in index order with
// d^2 < r^2 (strict); trailing slots repeat the first hit; 0 everywhere if
// nothing hits.  The TPU kernel was exact only up to query_capacity hits per
// residue class (a lane-layout artefact); this one is exact with no limit.
//
// Bound: operations on the scan.  Each centroid tests points in index
// order until every scale holds ns hits, so the work is data dependent: at
// most m * N direct-form distance tests per level (L0: 2048 x 12288 =
// 25M), far fewer where the balls fill early.  Bytes are small (N*12 in,
// m*(ns1+ns2)*4 out).  So the scans must be spread over the card: one
// thread per centroid would fill only 8 blocks of 256 at L0.
//
// Design: one warp serves one centroid, so L0 runs 2048 warps over the
// whole card.  Lane l tests point base + l for base = 0, 32, 64, ...,
// with coalesced loads of the row, which stays in L1 across the block's
// warps.  d^2 is computed once per pair and compared against every
// scale's r^2.  Per scale, __ballot_sync gives the 32-point run's hits and
// __popc(hits & lanemask_lt) each hitting lane's rank, so the lane's slot
// is cnt + rank; lanes whose slot is below ns store their index, and the
// output stays in index order with no sort.  cnt advances by
// __popc(hits), capped at ns; the run's first hit is kept in a register.
// The warp leaves the scan once every scale is full (a warp-uniform test),
// then fills slots [cnt, ns) with the first hit, or 0 when cnt == 0.
// Each trip of the scan loads kRuns runs before it ballots the first, so
// a lane keeps kRuns points in flight.  Up to 4 scales.
//
// Measured alternatives (PERF.md, section 6): 128 threads (4 centroids) a
// block and 2 runs a trip were the fastest of 128-256 threads and 1-4 runs
// timed on an H100.  Staging the row into shared memory once per block
// with one bulk asynchronous copy (cp.async.bulk + mbarrier) was slower
// there (0.16 against 0.12 ms a frame): 147 KB of shared memory at L0
// leaves one block on an SM, and the copy is made before any scan can
// stop early.
//
// d^2 is ((dx*dx)+(dy*dy))+(dz*dz) with round-to-nearest intrinsics: no FMA
// contraction, so radius membership equals the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRuns = 2;  // 32-point runs loaded per scan trip
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

// One run of 32 consecutive points (lane l holds point base + l at d2):
// every scale that is not full yet takes the run's hits in index order.
// Returns whether every scale is full.  cnt is the same in every lane, so
// every branch here is uniform across the warp.
__device__ __forceinline__ bool take_run(int (&cnt)[kMaxScales],
                                         int (&first)[kMaxScales],
                                         int* (&dst)[kMaxScales],
                                         const Scales& sc, int n_scales,
                                         float d2, int base, int lane) {
  const unsigned lanes_below = (1u << lane) - 1u;
  bool full = true;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s < n_scales && cnt[s] < sc.ns[s]) {
      const int ns = sc.ns[s];
      const unsigned hits = __ballot_sync(0xffffffffu, d2 < sc.r2[s]);
      const int slot = cnt[s] + __popc(hits & lanes_below);
      if (((hits >> lane) & 1u) && slot < ns) dst[s][slot] = base + lane;
      if (cnt[s] == 0 && hits) first[s] = base + __ffs(hits) - 1;
      cnt[s] = min(ns, cnt[s] + __popc(hits));
      full = full && cnt[s] == ns;
    }
  }
  return full;
}

__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ centers, int n, int m,
                      int n_scales, Scales sc) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  if (c >= m) return;  // whole warps only: c is uniform across the warp
  const size_t crow = static_cast<size_t>(b) * m + c;
  const float cx = centers[3 * crow];
  const float cy = centers[3 * crow + 1];
  const float cz = centers[3 * crow + 2];

  int cnt[kMaxScales], first[kMaxScales];
  int* dst[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    cnt[s] = 0;
    first[s] = 0;
    dst[s] = s < n_scales ? sc.out[s] + crow * sc.ns[s] : nullptr;
  }

  // kRuns runs of 32 points per trip: their loads are all issued before
  // the first run's ballots, so a lane has kRuns points in flight.
  for (int base = 0; base < n; base += 32 * kRuns) {
    float d2[kRuns];
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int j = base + 32 * r + lane;
      d2[r] = j < n
                  ? sqdist(cx, cy, cz, p[3 * j], p[3 * j + 1], p[3 * j + 2])
                  : CUDART_INF_F;
    }
    bool full = false;
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      if (!full) {
        full = take_run(cnt, first, dst, sc, n_scales, d2[r], base + 32 * r,
                        lane);
      }
    }
    if (full) break;
  }
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s >= n_scales) break;
    const int fill = cnt[s] > 0 ? first[s] : 0;
    for (int q = cnt[s] + lane; q < sc.ns[s]; q += 32) dst[s][q] = fill;
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
  const dim3 grid((m + kWarps - 1) / kWarps, b), block(kThreads);
  ball_query_kernel<<<grid, block, 0, stream>>>(xyz, centers, n, m, n_scales,
                                                sc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
