// K1: iterative farthest-point sampling, one thread-block cluster per row.
//
// Replaces pvn3d_tpu/ops/pallas/fps.py::fps_pallas (_fps_kernel_wide at
// B <= 2, _fps_kernel at B > 2).  Semantics (sampling_gpu.cu:92-110 of the
// reference): sample 0 is index 0; each step updates a per-point min-d^2
// cache against the last pick and takes the argmax, lowest index on ties;
// points with |p|^2 <= 1e-3 never win and never update the cache; a row
// where every point is skipped yields 0.
//
// Bound: latency.  npoint-1 dependent steps, each an O(N) update plus an
// argmax over the row; at N=12288, m=2048 the row is ~150 KB and the work
// ~0.2 GFLOP, so neither bytes nor operations bound it: the chain of 2047
// steps does, and each step's cost is its update (spread over the SMs
// that hold the row) plus one exchange between those SMs.
//
// Design: the row and its min-d^2 cache are split across a cluster of
// kCluster CTAs on neighbouring SMs, kPer points per thread in registers.
// Each CTA also keeps the whole row's xyz in shared memory, so the last
// pick's coordinates are a local shared read and a step touches no global
// memory.  A step is:
//   1. every thread updates its kPer cache entries and folds them into one
//      packed 64-bit key (pack() below: one unsigned max orders by value,
//      then by lowest index), then a warp max (two redux.sync);
//   2. lane r of every warp stores the warp's key into CTA r's key buffer
//      with st.async, at the sender's own place (rank * kWarps + warp);
//      each store completes its 8 bytes on CTA r's mbarrier;
//   3. every CTA waits on its own mbarrier until the step's kKeys keys
//      have landed: no cluster-wide barrier, only the one-way latency of
//      the stores;
//   4. every warp reads the kKeys keys (kKeys / 32 loads a lane) and takes
//      their warp max: the pick.
// The buffers and their mbarriers are double-buffered by step (b = i & 1).
// Thread 0 arms s_bar[b] for step i + 2 (expect kKeys * 8 bytes) right
// after reading step i, before warp 0 sends its step i + 1 key; every
// sender of a step i + 2 key has first received that key, so no step
// i + 2 byte lands before the arming.  By the same chain a step i + 2 store
// lands only after every warp of the receiver has sent its step i + 1 key,
// which each warp computes from the keys it read at step i, so it never
// overwrites a key still to be read.
//
// Measured alternatives (PERF.md, section 6): 8 CTAs x 256 threads was the
// fastest of the cluster sizes 1-16 and block sizes 64-1024 timed on an
// H100; one cluster barrier per step (remote stores, barrier.cluster
// arrive / wait) took 0.8 us a step there against 0.5 here.  A 64-bit
// atomicMax into one remote slot does not work: nvcc lowers a 64-bit
// shared-memory atomicMax to a compare-and-swap loop on the CTA's own
// shared memory (ATOMS.CAST.SPIN.64 in the SASS), which never reaches the
// other CTAs.
//
// Rows longer than the register capacity (kRegisterRow points) keep the
// cache in a global scratch row and read the pick's coordinates from
// global memory (fps_kernel<0>); batch B launches B clusters.
//
// d^2 is ((dx*dx)+(dy*dy))+(dz*dz) with round-to-nearest intrinsics, so
// nvcc cannot contract it into FMAs and it equals the plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // the largest portable cluster
constexpr int kThreads = 256;
// Rows up to this many points keep their cache in registers: the serving
// path's row, split exactly over the cluster's threads.
constexpr int kRegisterRow = 12288;
constexpr int kPer = kRegisterRow / (kCluster * kThreads);
static_assert(kPer * kCluster * kThreads == kRegisterRow,
              "the cluster's threads must split the register row evenly");
static_assert(kCluster <= 32, "one lane per destination CTA");
constexpr int kWarps = kThreads / 32;
// Keys a step gathers in every CTA: one per warp of the cluster.
constexpr int kKeys = kCluster * kWarps;
constexpr unsigned kStepBytes = kKeys * sizeof(unsigned long long);
// Returned when no cluster of kCluster CTAs fits on the card.
constexpr int kErrNoCluster = -1;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Initial cache value: skipped points and padding hold -inf, which no
// fminf ever raises.
__device__ __forceinline__ float initial_min(float x, float y, float z,
                                             bool in_row) {
  const float mag =
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return (in_row && !(mag <= 1e-3f)) ? 1e10f : -CUDART_INF_F;
}

// Argmax key of point j with cache value v: the high word orders by value,
// the low word (the inverted index) by lowest index on ties.  A real value
// v >= 0 maps to bits(v) + 1, which orders as v does for non-negative
// floats; -inf (skipped or padding) maps to 0.  So a real point whose
// min-d^2 has fallen to 0 still beats every skipped point, and a row where
// every point is skipped yields its lowest index, 0 (padding indices are
// all above n).
__device__ __forceinline__ unsigned long long pack(float v, int j) {
  const unsigned hi = v >= 0.f ? __float_as_uint(v) + 1u : 0u;
  return (static_cast<unsigned long long>(hi) << 32) |
         (0xffffffffu - static_cast<unsigned>(j));
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// Max of a key over the warp, left in every lane: two single-instruction
// 32-bit warp reductions (redux.sync), the high word's max and then the
// largest low word among the lanes that hold it, in place of five rounds of
// 64-bit shuffles.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  const unsigned hi = static_cast<unsigned>(v >> 32);
  const unsigned top = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, hi == top ? static_cast<unsigned>(v) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `p` (this CTA's shared memory) in CTA
// `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  return remote;
}

// Arm mbarrier `bar` (arrival count 1) for a phase that completes when
// kStepBytes more bytes have landed on it.
__device__ __forceinline__ void arm(unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(kStepBytes)
      : "memory");
}

// Wait for the phase of `bar` with this parity to complete.  A phase that
// never completes is a fault of the protocol: trap rather than hang.
__device__ __forceinline__ void wait_phase(unsigned long long* bar,
                                           unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

template <int PER>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, int n, int m,
               int* __restrict__ out, float* __restrict__ scratch) {
  extern __shared__ float s_xyz[];  // PER > 0: the row, 3n floats
  // Step i's keys from every warp of the cluster land in s_keys[i & 1] and
  // complete a phase of s_bar[i & 1].
  __shared__ unsigned long long s_keys[2][kKeys];
  __shared__ unsigned long long s_bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / kCluster;
  const float* p = xyz + static_cast<size_t>(row) * n * 3;
  int* o = out + static_cast<size_t>(row) * m;
  float* cache = scratch + static_cast<size_t>(row) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int first = rank * kThreads + tid;  // this thread's first point
  constexpr int kStride = kCluster * kThreads;

  // PER > 0: points j = first + k * kStride live in registers.
  float px[PER > 0 ? PER : 1], py[PER > 0 ? PER : 1], pz[PER > 0 ? PER : 1];
  float mind[PER > 0 ? PER : 1];
  if constexpr (PER > 0) {
    for (int t = tid; t < 3 * n; t += kThreads) s_xyz[t] = p[t];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = first + k * kStride;
      const bool in_row = j < n;
      px[k] = in_row ? p[3 * j] : 0.f;
      py[k] = in_row ? p[3 * j + 1] : 0.f;
      pz[k] = in_row ? p[3 * j + 2] : 0.f;
      mind[k] = initial_min(px[k], py[k], pz[k], in_row);
    }
  } else {
    for (int j = first; j < n; j += kStride) {
      cache[j] = initial_min(p[3 * j], p[3 * j + 1], p[3 * j + 2], true);
    }
  }
  if (rank == 0 && tid == 0) o[0] = 0;
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&s_bar[b]))
                   : "memory");
      arm(&s_bar[b]);  // steps 2 and 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // This lane's destination in CTA `lane` for buffer 0 (buffer 1 lies at a
  // fixed offset from it); the parity of s_bar[b]'s next phase in bit b.
  const int dest = lane < kCluster ? lane : 0;
  const unsigned r_key = cluster_addr(&s_keys[0][rank * kWarps + warp], dest);
  const unsigned r_bar = cluster_addr(&s_bar[0], dest);
  unsigned parities = 0u;
  // Every CTA of the cluster is running, with its mbarriers armed and its
  // copy of the row complete, before any remote store or shared read.
  cluster.sync();

  int last = 0;
  for (int i = 1; i < m; ++i) {
    const float* lp = PER > 0 ? s_xyz + 3 * last : p + 3 * last;
    const float lx = lp[0], ly = lp[1], lz = lp[2];
    unsigned long long best = 0ull;
    if constexpr (PER > 0) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        mind[k] = fminf(mind[k], sqdist(px[k], py[k], pz[k], lx, ly, lz));
        best = umax64(best, pack(mind[k], first + k * kStride));
      }
    } else {
      for (int j = first; j < n; j += kStride) {
        const float d =
            sqdist(p[3 * j], p[3 * j + 1], p[3 * j + 2], lx, ly, lz);
        const float c = fminf(cache[j], d);
        cache[j] = c;
        best = umax64(best, pack(c, j));
      }
    }
    best = warp_max(best);
    const int b = i & 1;
    if (lane < kCluster) {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.u64 "
          "[%0], %1, [%2];\n" ::"r"(r_key + b * kStepBytes),
          "l"(best), "r"(r_bar + b * 8u)
          : "memory");
    }
    wait_phase(&s_bar[b], (parities >> b) & 1u);
    parities ^= 1u << b;
    unsigned long long key = 0ull;
#pragma unroll
    for (int q = lane; q < kKeys; q += 32) key = umax64(key, s_keys[b][q]);
    key = warp_max(key);
    last = static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
    if (rank == 0 && tid == 0) o[i] = last;
    if (tid == 0) arm(&s_bar[b]);  // step i + 2
  }
  // No CTA leaves while another may still store into it.
  cluster.sync();
}

cudaLaunchConfig_t launch_config(int b, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Dynamic shared memory of the instance: the largest row it takes.
template <int PER>
constexpr size_t kMaxSmem = PER > 0 ? kRegisterRow * 3 * sizeof(float) : 0;

// Allows the instance its largest dynamic shared memory and checks that a
// cluster of kCluster CTAs with it can be scheduled on the current device.
// A function attribute holds per device, so this runs once per device
// (not per launch, where it would add host time to every call).
template <int PER>
int prepare() {
  static std::once_flag once[kMaxDevices];
  static int status[kMaxDevices];
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::call_once(once[device], [device] {
    auto kernel = fps_kernel<PER>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem<PER>));
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(1, kMaxSmem<PER>, nullptr, &attr);
    int clusters = 0;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    }
    status[device] = e != cudaSuccess ? static_cast<int>(e)
                     : clusters == 0  ? kErrNoCluster
                                      : 0;
  });
  return status[device];
}

template <int PER>
int launch(const float* xyz, int b, int n, int m, int* out, float* scratch,
           cudaStream_t stream) {
  const int ready = prepare<PER>();
  if (ready != 0) return ready;
  const size_t smem = PER > 0 ? static_cast<size_t>(n) * 3 * sizeof(float)
                              : 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(b, smem, stream, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, fps_kernel<PER>, xyz, n, m, out, scratch);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// scratch holds b * n floats when n > kRegisterRow (the cache of the
// scratch path); it is not read otherwise.
extern "C" int fps_launch(const float* xyz, int b, int n, int m, int* out,
                          float* scratch, cudaStream_t stream) {
  return n <= kRegisterRow ? launch<kPer>(xyz, b, n, m, out, scratch, stream)
                           : launch<0>(xyz, b, n, m, out, scratch, stream);
}

extern "C" const char* kernel_error_string(int code) {
  if (code == kErrNoCluster) {
    return "no cluster of 8 CTAs with a 12288-point row in shared memory "
           "can be scheduled on this card";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
