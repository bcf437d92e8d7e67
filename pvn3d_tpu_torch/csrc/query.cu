// K2: multi-scale ball query, one warp per centroid, in the JAX package's
// neighbour modes.
//
// Replaces pvn3d_tpu/ops/pallas/query.py::ball_query_pallas
// (_query_kernel) and the XLA arms of pvn3d_tpu/ops/grouping.py::
// ball_query_multi.  Semantics (ball_query_gpu.cu:26-43 of the reference):
// per centroid and scale, the first ns point indices in index order with
// d^2 < r^2 (strict); trailing slots repeat the first hit; 0 everywhere if
// nothing hits.  Three compile-time flags give the JAX package's modes:
// - kExpanded: d^2 = (|c|^2 - 2 c.p) + |p|^2, the expanded form of the
//   Pallas kernel (query.py:67-77) and of the "approx" arm, instead of the
//   direct form of the "exact" arm.
// - kCapacity: the Pallas kernel's selection (query.py:82-108).  Points
//   fall in 128 residue classes (index % 128); a hit at index j is kept
//   iff fewer than `capacity` earlier hits of its scale share j's class,
//   and the output is the first ns kept hits.  The TPU kernel takes the
//   first `capacity` hits of each class as candidates and then the ns
//   smallest candidates: the same set, so the scan can still stop once
//   every scale holds ns.
// - kBf16: coordinates rounded to bfloat16 (nearest even) on load, then
//   the same float32 arithmetic: query_compute="bf16" (grouping.py:
//   109-111).  The Pallas arm ignores it, as JAX does.
//
// Bound: operations on the scan.  Each centroid tests points in index
// order until every scale holds ns hits, so the work is data dependent: at
// most m * N distance tests per level (L0: 2048 x 12288 = 25M), far fewer
// where the balls fill early (with a capacity, later: dropped hits do not
// fill a slot).  Bytes are small (N*12 in, m*(ns1+ns2)*4 out).  So the
// scans must be spread over the card: one thread per centroid would fill
// only 8 blocks of 256 at L0.
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
// With a capacity a trip is 4 runs, 128 points: run r of every trip holds
// the classes 32r .. 32r+31, lane l the class 32r + l.  So each lane keeps
// one hit count per (scale, run) in registers, 16 at most, indexed at
// compile time: no shared memory and no traffic between lanes beyond the
// ballot.  A lane's hit enters the ballot only while its count is below
// the capacity; points past N never hit (the TPU kernel's
// lane < n_valid - j*128 mask).
//
// Measured alternatives (PERF.md, section 6): 128 threads (4 centroids) a
// block and 2 runs a trip were the fastest of 128-256 threads and 1-4 runs
// timed on an H100.  Staging the row into shared memory once per block
// with one bulk asynchronous copy (cp.async.bulk + mbarrier) was slower
// there (0.16 against 0.12 ms a frame): 147 KB of shared memory at L0
// leaves one block on an SM, and the copy is made before any scan can
// stop early.
//
// d^2, the norms and the dot product use round-to-nearest intrinsics in
// a fixed order (direct: ((dx*dx)+(dy*dy))+(dz*dz); expanded: each norm
// and c.p as ((x*x)+(y*y))+(z*z), then (|c|^2 - 2 c.p) + |p|^2): no FMA
// contraction, so radius membership equals the plain version's bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRuns = 2;  // 32-point runs loaded per scan trip
constexpr int kClassRuns = 128 / 32;  // runs a trip with a capacity
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

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

template <bool kBf16>
__device__ __forceinline__ float coord(const float* p) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(*p));
  } else {
    return *p;
  }
}

// One run of 32 consecutive points (lane l holds point base + l at d2):
// every scale that is not full yet takes the run's hits in index order.
// With a capacity, seen[s] is this lane's count of earlier hits of scale s
// in its class, and a hit enters only while it is below the capacity.
// Returns whether every scale is full.  cnt is the same in every lane, so
// every branch here is uniform across the warp.
template <bool kCapacity>
__device__ __forceinline__ bool take_run(int (&cnt)[kMaxScales],
                                         int (&first)[kMaxScales],
                                         int (&seen)[kMaxScales],
                                         int* (&dst)[kMaxScales],
                                         const Scales& sc, int n_scales,
                                         int capacity, float d2, int base,
                                         int lane) {
  const unsigned lanes_below = (1u << lane) - 1u;
  bool full = true;
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    if (s < n_scales && cnt[s] < sc.ns[s]) {
      const int ns = sc.ns[s];
      bool hit = d2 < sc.r2[s];
      if constexpr (kCapacity) {
        const bool keep = hit && seen[s] < capacity;
        seen[s] += hit ? 1 : 0;
        hit = keep;
      }
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      const int slot = cnt[s] + __popc(hits & lanes_below);
      if (((hits >> lane) & 1u) && slot < ns) dst[s][slot] = base + lane;
      if (cnt[s] == 0 && hits) first[s] = base + __ffs(hits) - 1;
      cnt[s] = min(ns, cnt[s] + __popc(hits));
      full = full && cnt[s] == ns;
    }
  }
  return full;
}

template <bool kExpanded, bool kCapacity, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ centers, int n, int m,
                      int n_scales, Scales sc, int capacity) {
  constexpr int runs = kCapacity ? kClassRuns : kRuns;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  if (c >= m) return;  // whole warps only: c is uniform across the warp
  const size_t crow = static_cast<size_t>(b) * m + c;
  const float cx = coord<kBf16>(centers + 3 * crow);
  const float cy = coord<kBf16>(centers + 3 * crow + 1);
  const float cz = coord<kBf16>(centers + 3 * crow + 2);
  const float c_sq = dot3(cx, cy, cz, cx, cy, cz);

  int cnt[kMaxScales], first[kMaxScales];
  // seen[r][s]: this lane's hits of scale s so far in class 32r + lane.
  int seen[kCapacity ? kClassRuns : 1][kMaxScales];
  int* dst[kMaxScales];
#pragma unroll
  for (int s = 0; s < kMaxScales; ++s) {
    cnt[s] = 0;
    first[s] = 0;
    dst[s] = s < n_scales ? sc.out[s] + crow * sc.ns[s] : nullptr;
#pragma unroll
    for (int r = 0; r < (kCapacity ? kClassRuns : 1); ++r) seen[r][s] = 0;
  }

  // `runs` runs of 32 points per trip: their loads are all issued before
  // the first run's ballots, so a lane has `runs` points in flight.
  for (int base = 0; base < n; base += 32 * runs) {
    float d2[runs];
#pragma unroll
    for (int r = 0; r < runs; ++r) {
      const int j = base + 32 * r + lane;
      if (j < n) {
        const float px = coord<kBf16>(p + 3 * j);
        const float py = coord<kBf16>(p + 3 * j + 1);
        const float pz = coord<kBf16>(p + 3 * j + 2);
        if constexpr (kExpanded) {
          const float cross = dot3(cx, cy, cz, px, py, pz);
          d2[r] = __fadd_rn(__fsub_rn(c_sq, __fmul_rn(2.f, cross)),
                            dot3(px, py, pz, px, py, pz));
        } else {
          d2[r] = sqdist(cx, cy, cz, px, py, pz);
        }
      } else {
        d2[r] = CUDART_INF_F;
      }
    }
    bool full = false;
#pragma unroll
    for (int r = 0; r < runs; ++r) {
      if (!full) {
        full = take_run<kCapacity>(cnt, first,
                                   seen[kCapacity ? r : 0], dst, sc,
                                   n_scales, capacity, d2[r],
                                   base + 32 * r, lane);
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

template <bool kExpanded, bool kCapacity, bool kBf16>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const float* xyz,
            const float* centers, int n, int m, int n_scales,
            const Scales& sc, int capacity) {
  ball_query_kernel<kExpanded, kCapacity, kBf16>
      <<<grid, block, 0, stream>>>(xyz, centers, n, m, n_scales, sc,
                                   capacity);
}

}  // namespace

// radii2/nsamples/outs hold n_scales entries (n_scales <= 4); each outs[s]
// is a (b, m, nsamples[s]) int32 buffer.  expanded / bf16 are 0 or 1;
// capacity is 0 (none) or the hits kept per residue class, which takes the
// expanded form and float32 coordinates (the Pallas kernel's arm).
extern "C" int ball_query_launch(const float* xyz, const float* centers,
                                 int b, int n, int m, int n_scales,
                                 const float* radii2, const int* nsamples,
                                 int* const* outs, int expanded, int capacity,
                                 int bf16, cudaStream_t stream) {
  if (n_scales < 1 || n_scales > kMaxScales || capacity < 0 ||
      (capacity > 0 && (!expanded || bf16))) {
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
  if (capacity > 0) {
    launch<true, true, false>(grid, block, stream, xyz, centers, n, m,
                              n_scales, sc, capacity);
  } else if (expanded) {
    if (bf16) {
      launch<true, false, true>(grid, block, stream, xyz, centers, n, m,
                                n_scales, sc, 0);
    } else {
      launch<true, false, false>(grid, block, stream, xyz, centers, n, m,
                                 n_scales, sc, 0);
    }
  } else if (bf16) {
    launch<false, false, true>(grid, block, stream, xyz, centers, n, m,
                               n_scales, sc, 0);
  } else {
    launch<false, false, false>(grid, block, stream, xyz, centers, n, m,
                                n_scales, sc, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
