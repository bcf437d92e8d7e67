// MeanShift's winner-mode shift loop, run to its stopping rule in one launch.
//
// Replaces no TPU kernel: the JAX package runs the loop as a lax.while_loop
// of jnp steps (pvn3d_tpu/inference/meanshift.py::mean_shift_fit, `unroll`
// 4), which stays on the TPU.  Run eagerly, the port's loop cost about 13
// launches a step and a host read of max(shift) after every group of 4
// steps, each of which drained the stream; the pose stage's three fits ran
// some 25-60 steps a request.
//
// Semantics (ops/kernels/meanshift.py::shift_to_stop_plain): hypothesis h
// has points p (K, 3), validity m and winning seed win[h].  Start at
// c = p[win[h]].  A step computes for every point
//   d2 = ((px-cx)*(px-cx) + (py-cy)*(py-cy)) + (pz-cz)*(pz-cz),
//   w = exp((-0.5 * d2) / bw2) * m,
// then c' = (sum w p) / max(sum w, 1e-20) and shift = |c' - c|.  Steps run
// in groups of kUnroll; after a group it += kUnroll, and the loop stops when
// it >= max_iter or every hypothesis's last shift is < stop (the JAX
// package's max(shift) < stop; a NaN shift stops nothing in either).  A
// hypothesis with no valid point goes to 0 after one step.  The step count
// is written to *steps.
//
// Bound: operations, about 30 instructions a (step, valid point) pair (the
// division and expf are the IEEE ones, not the fast intrinsics), against
// the points read once.  The steps are serial, so a fit is latency-bound:
// the design keeps every step on chip and every decision on the card.
//
// Design: one launch, one thread-block cluster of C = min(8, H) CTAs.
//   1. CTA r takes hypotheses r, r + C, r + 2C, ... (at most ceil(H / C)),
//      so a class's keypoint hypotheses, which are consecutive rows, fall to
//      different CTAs and the few classes present in a frame spread over
//      the cluster.  Its warps take its hypotheses in turn: one a warp while
//      H <= 8 * 32, several above.  The CTA stages the first S points of
//      each of its hypotheses in shared memory as float4 (x, y, z, validity
//      as 0 or 1): S = K where they fit, else the largest multiple of 32
//      that does (possibly 0).  Points past S are read from global memory
//      at every step.
//   2. A warp runs a step of a hypothesis with point j on lane j % 32,
//      lane by lane in increasing j, and skips a run of 32 points none of
//      which is valid (the pose stage's masks are prefixes, and most of the
//      keypoint fit's 168 hypotheses are classes absent from the frame).
//      An invalid point adds exact zeros, so the skip changes no sum.
//   3. The lanes' partial sums (w, wx, wy, wz) are combined by a fixed xor
//      butterfly (16, 8, 4, 2, 1): addition commutes, so every lane ends
//      with the same sums, whatever the scheduling.
//   4. After each group every warp knows whether all its hypotheses'
//      shifts are < stop; __syncthreads_and gives the CTA's verdict, each
//      CTA publishes it in shared memory (two slots by the group's parity),
//      and after a cluster barrier every warp reads the C verdicts through
//      distributed shared memory: every CTA takes the same decision, with
//      no grid-wide sync and no host round trip.  A last cluster barrier
//      keeps each CTA's verdicts alive until every CTA has read them.
// d^2 and every sum use round-to-nearest intrinsics: no FMA contraction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;   // the largest portable cluster
constexpr int kMaxWarps = 32;    // warps a CTA
constexpr int kUnroll = 4;       // steps between stop checks (JAX's unroll)
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory a CTA may stage (227 KB less room for the flags).
constexpr int kStageBytes = 232448 - 1024;
// Returned when no cluster of the largest launch fits on the card.
constexpr int kErrNoCluster = -1;
constexpr int kMaxDevices = 64;

struct Shape {
  int cluster;  // CTAs
  int warps;    // warps a CTA
  int per_cta;  // hypotheses a CTA
  int stage;    // points of each hypothesis staged in shared memory
};

Shape shape_of(int h, int k) {
  Shape s;
  s.cluster = h < kMaxCluster ? h : kMaxCluster;
  s.per_cta = (h + s.cluster - 1) / s.cluster;
  s.warps = s.per_cta < kMaxWarps ? s.per_cta : kMaxWarps;
  const long long whole = static_cast<long long>(s.per_cta) * k * 16;
  s.stage = whole <= kStageBytes ? k : kStageBytes / 16 / s.per_cta / 32 * 32;
  return s;
}

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float butterfly(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// One shift step of one hypothesis by a whole warp: c moves to the weighted
// mean; returns |c' - c|, the same in every lane.
__device__ __forceinline__ float shift_step(
    const float4* __restrict__ st, const float* __restrict__ a,
    const unsigned char* __restrict__ am, int k, int stage, float bw2,
    float& cx, float& cy, float& cz) {
  const int lane = threadIdx.x & 31;
  float sw = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll 4
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < stage) {
      p = st[j];
    } else if (j < k) {
      p = make_float4(a[3 * j], a[3 * j + 1], a[3 * j + 2],
                      am[j] != 0 ? 1.f : 0.f);
    }
    if (__ballot_sync(kFull, p.w != 0.f) == 0u) continue;
    const float d2 = sqdist(p.x, p.y, p.z, cx, cy, cz);
    const float w =
        __fmul_rn(expf(__fdiv_rn(__fmul_rn(-0.5f, d2), bw2)), p.w);
    sw = __fadd_rn(sw, w);
    sx = __fadd_rn(sx, __fmul_rn(w, p.x));
    sy = __fadd_rn(sy, __fmul_rn(w, p.y));
    sz = __fadd_rn(sz, __fmul_rn(w, p.z));
  }
  sw = butterfly(sw);
  sx = butterfly(sx);
  sy = butterfly(sy);
  sz = butterfly(sz);
  // torch.clamp(min=1e-20): a NaN sum stays NaN.
  const float den = sw < 1e-20f ? 1e-20f : sw;
  const float nx = __fdiv_rn(sx, den);
  const float ny = __fdiv_rn(sy, den);
  const float nz = __fdiv_rn(sz, den);
  const float shift = __fsqrt_rn(sqdist(nx, ny, nz, cx, cy, cz));
  cx = nx;
  cy = ny;
  cz = nz;
  return shift;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    meanshift_kernel(const float* __restrict__ pts,
                     const unsigned char* __restrict__ mask,
                     const int* __restrict__ win, int h, int k, int stage,
                     float bw2, float stop, int max_iter,
                     float* __restrict__ centres, int* __restrict__ steps) {
  extern __shared__ float4 s_pts[];
  // This CTA's verdict on the last group, by the group's parity.
  __shared__ int s_ok[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_cta = static_cast<int>(gridDim.x);  // the grid is one cluster
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  // This CTA's hypotheses: rank + slot * n_cta for slot < nh.
  const int nh = rank < h ? (h - rank + n_cta - 1) / n_cta : 0;

  for (int i = threadIdx.x; i < nh * stage; i += blockDim.x) {
    const int slot = i / stage;
    const size_t q = static_cast<size_t>(rank + slot * n_cta) * k +
                     (i - slot * stage);
    s_pts[i] = make_float4(pts[3 * q], pts[3 * q + 1], pts[3 * q + 2],
                           mask[q] != 0 ? 1.f : 0.f);
  }
  __syncthreads();

  int it = 0;
  int parity = 0;
  while (true) {
    bool ok = true;
    for (int slot = warp; slot < nh; slot += warps) {
      const int hh = rank + slot * n_cta;
      const float* a = pts + static_cast<size_t>(hh) * k * 3;
      const unsigned char* am = mask + static_cast<size_t>(hh) * k;
      const float4* st = s_pts + static_cast<size_t>(slot) * stage;
      // The centre lives in the output between groups, written by lane 0
      // and read after the CTA barrier below.
      float* c = centres + 3 * hh;
      const float* from = it == 0 ? a + 3 * win[hh] : c;
      float cx = from[0], cy = from[1], cz = from[2];
      float shift = 0.f;
#pragma unroll 1
      for (int s = 0; s < kUnroll; ++s) {
        shift = shift_step(st, a, am, k, stage, bw2, cx, cy, cz);
      }
      ok = ok && shift < stop;
      if (lane == 0) {
        c[0] = cx;
        c[1] = cy;
        c[2] = cz;
      }
    }
    it += kUnroll;
    const int cta_ok = __syncthreads_and(ok);
    if (it >= max_iter) break;  // uniform: every CTA counts alike
    if (threadIdx.x == 0) s_ok[parity] = cta_ok;
    cluster.sync();
    const int other =
        lane < n_cta ? *cluster.map_shared_rank(&s_ok[parity], lane) : 1;
    parity ^= 1;
    if (__all_sync(kFull, other != 0)) break;
  }
  // No CTA leaves while another may still read its verdicts.
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) *steps = it;
}

cudaLaunchConfig_t launch_config(const Shape& s, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = s.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.cluster);
  cfg.blockDim = dim3(32 * s.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per device (a function attribute holds per device): allow the
// largest stage, and check that the largest launch (8 CTAs of 32 warps,
// the whole stage each) can be scheduled.
int prepare(int device) {
  static std::once_flag once[kMaxDevices];
  static int status[kMaxDevices];
  std::call_once(once[device], [device] {
    cudaError_t e = cudaFuncSetAttribute(
        meanshift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    int clusters = 0;
    if (e == cudaSuccess) {
      const Shape s = {kMaxCluster, kMaxWarps, 1, 0};
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          launch_config(s, kStageBytes, nullptr, &attr);
      e = cudaOccupancyMaxActiveClusters(&clusters, meanshift_kernel, &cfg);
    }
    status[device] = e != cudaSuccess ? static_cast<int>(e)
                     : clusters == 0  ? kErrNoCluster
                                      : 0;
  });
  return status[device];
}

}  // namespace

// pts (h, k, 3) float32, mask (h, k) bool bytes, win (h,) int32 in [0, k);
// centres (h, 3) float32, steps one int32.  h >= 1, k >= 1.
extern "C" int meanshift_launch(const float* pts, const unsigned char* mask,
                                const int* win, int h, int k, float bw2,
                                float stop, int max_iter, float* centres,
                                int* steps, cudaStream_t stream) {
  if (h < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int ready = prepare(device);
  if (ready != 0) return ready;
  const Shape s = shape_of(h, k);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      s, static_cast<size_t>(s.per_cta) * s.stage * 16, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, meanshift_kernel, pts, mask, win, h, k,
                           s.stage, bw2, stop, max_iter, centres, steps);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch's shape for h hypotheses of k points: CTAs, warps a CTA,
// hypotheses a CTA and staged points a hypothesis, into out[0..3].
extern "C" void meanshift_shape(int h, int k, int* out) {
  const Shape s = shape_of(h, k);
  out[0] = s.cluster;
  out[1] = s.warps;
  out[2] = s.per_cta;
  out[3] = s.stage;
}

extern "C" const char* kernel_error_string(int code) {
  if (code == kErrNoCluster) {
    return "no cluster of 8 CTAs of 1024 threads with a 226 KB stage can be "
           "scheduled on this card";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
