// K4: MeanShift winner statistics, one thread-block cluster per hypothesis.
//
// Replaces pvn3d_tpu/ops/pallas/winner.py::winner_stats_fused
// (_winner_kernel).  Semantics (meanshift_pytorch.py:45-51 of the
// reference): for hypothesis h with points a (K, 3) and validity mask,
// count for every valid seed i the valid points j with
// |a_i - a_j|^2 < bw^2 at their ORIGINAL positions; the winner is the first
// argmax of those counts (an invalid seed counts 0, so with every count 0
// the winner is seed 0); return the winner, its membership row (valid j
// within bw of the winner) and its count.
//
// Bound: operations.  sum_h v_h^2 pair tests over the v_h valid points
// (the keypoint pass: 168 x ~360^2 = 22M at 70% valid, ~10 instructions
// each) against O(H*K) bytes in and out.  The TPU kernel held each (K, K)
// tile in VMEM; nothing K x K is held here.
//
// Design: one launch, a cluster of kCluster CTAs per hypothesis.
//   1. Every CTA compacts the valid points of a tile of kStagePoints row
//      indices into shared memory in index order, one float4 a point
//      (x, y, z and the row index's bits): each warp loads 32-point runs
//      of coordinates and mask together, and a ballot and popc give each
//      valid lane its place after the warps before it.  The scan below
//      has no mask test and runs over v points, not K.
//   2. CTA r takes the r-th of kCluster equal shares of the tile's valid
//      seeds (a contiguous run of the compacted list), so the shares are
//      balanced whatever the mask: the pose stage's masks are prefixes of
//      the row, where shares of the row's indices leave CTAs idle.
//   3. Each thread holds kSeeds seeds in registers, so every shared-memory
//      load of a point serves kSeeds pair tests; the lanes of a seed block
//      (a power of two within a warp) split the compacted list, lane l
//      taking j = l, l + lanes, ..., and a shuffle butterfly sums their
//      counts: no block barrier and no atomic in a pass.  Invalid seeds
//      are never scanned.  A row longer than kStagePoints is tiled: seeds
//      and points come from each tile in turn (a serving row fits one
//      tile, which is staged once).
//   4. Each warp reduces its seeds to one 64-bit key, count in the high
//      word and 0xffffffff - index in the low word, so the largest key is
//      the largest count with the lowest index.  After a cluster barrier
//      every warp reads the cluster's keys through distributed shared
//      memory and takes their maximum itself: no DSMEM or 64-bit shared
//      atomics (nvcc lowers a 64-bit shared atomicMax to a CTA-local CAS
//      loop), no global ticket.
//   5. Each CTA writes its share of the row's labels from the winner's
//      coordinates (from the stage) against the original points, whose
//      first group it loaded while the cluster waited (4 labels a store
//      where the row is aligned), between the arrive and the wait of a
//      last cluster barrier, so no CTA leaves while another may still read
//      its keys.
// An all-invalid hypothesis (v = 0: every CTA counts it from the same mask,
// so the branch is uniform) writes winner 0, count 0 and a zero row and
// leaves before either barrier.  A CTA has 256 threads when all H clusters
// of such CTAs are resident on the card at once (the pose stage's 21
// hypotheses), else 128 (its 168).
//
// Measured alternatives (PERF.md, section 6): 1 or 4 seeds a thread, CTAs
// of 512 threads, registers capped for more resident CTAs, seed shares by
// row index, and partial counts summed by shared-memory atomics were each
// slower on an H100.
//
// d^2 is ((dx*dx)+(dy*dy))+(dz*dz) with round-to-nearest intrinsics: no FMA
// contraction, so bandwidth membership equals the plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // the largest portable cluster
constexpr int kSeeds = 2;    // seeds a thread holds in registers
// Row indices a tile stages (x, y, z, index: 16 bytes a point).
constexpr int kStagePoints = 2048;
// 32-point runs a warp loads per staging round: a round covers 512 points
// (a serving row) in a CTA of 128 or 256 threads.
__host__ __device__ constexpr int runs_per_warp(int threads) {
  return 512 / threads;
}
// Returned when no cluster of kCluster CTAs fits on the card.
constexpr int kErrNoCluster = -1;
constexpr int kMaxDevices = 64;

// Dynamic shared memory of a CTA: the stage, 16 bytes a point.
constexpr size_t smem_bytes(int cap) { return static_cast<size_t>(cap) * 16; }

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned long long pack(int count, int index) {
  return (static_cast<unsigned long long>(count) << 32) |
         (0xffffffffu - static_cast<unsigned>(index));
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// Max of a key over the warp, in every lane: the high word's max, then the
// largest low word among the lanes that hold it (two redux.sync).
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  const unsigned hi = static_cast<unsigned>(v >> 32);
  const unsigned top = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, hi == top ? static_cast<unsigned>(v) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

// Compacts the valid points among row indices [base, base + lim) into the
// stage in index order and returns their number.  Every thread of the
// block calls it; it begins and ends with a block barrier.
template <int kThreads>
__device__ __forceinline__ int stage_tile(const float* __restrict__ a,
                                          const unsigned char* __restrict__ am,
                                          int base, int lim, float4* s,
                                          int (*s_wcnt)[kThreads / 32]) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kRunsPerWarp = runs_per_warp(kThreads);
  static_assert(kThreads * kRunsPerWarp == 512, "a round covers 512 points");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  __syncthreads();  // the previous tile's readers are done
  int n = 0;
  for (int r0 = 0, round = 0; r0 < lim;
       r0 += kThreads * kRunsPerWarp, ++round) {
    // Coordinates and mask are loaded together (one round trip); the
    // ballot words say which lanes keep theirs.
    float px[kRunsPerWarp], py[kRunsPerWarp], pz[kRunsPerWarp];
    unsigned bal[kRunsPerWarp];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < kRunsPerWarp; ++q) {
      const int t = r0 + (warp * kRunsPerWarp + q) * 32 + lane;
      const bool in = t < lim;
      const int j = base + t;
      px[q] = in ? a[3 * j] : 0.f;
      py[q] = in ? a[3 * j + 1] : 0.f;
      pz[q] = in ? a[3 * j + 2] : 0.f;
      bal[q] = __ballot_sync(0xffffffffu, in && am[j] != 0);
      cnt += __popc(bal[q]);
    }
    // Double-buffered by round: round i + 2 writes after every thread has
    // passed round i + 1's barrier, so after its round-i reads.
    int* wc = s_wcnt[round & 1];
    if (lane == 0) wc[warp] = cnt;
    __syncthreads();
    int off = n;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wc[w];
      off += w < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int q = 0; q < kRunsPerWarp; ++q) {
      if ((bal[q] >> lane) & 1u) {
        const int pos = off + __popc(bal[q] & below);
        s[pos] = make_float4(
            px[q], py[q], pz[q],
            __int_as_float(base + r0 + (warp * kRunsPerWarp + q) * 32 + lane));
      }
      off += __popc(bal[q]);
    }
    n += total;
  }
  __syncthreads();
  return n;
}

// The row index a staged point carries in its fourth word.
__device__ __forceinline__ int index_of(const float4& p) {
  return __float_as_int(p.w);
}

// First position in s[0, n) (increasing indices) holding an index >= key.
__device__ __forceinline__ int lower_bound(const float4* s, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (index_of(s[mid]) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// cnt += (d2 < bw2), as a compare and a predicated add.
__device__ __forceinline__ void count_if_less(int& cnt, float d2, float bw2) {
  asm("{\n .reg .pred p;\n setp.lt.f32 p, %1, %2;\n @p add.s32 %0, %0, 1;\n}"
      : "+r"(cnt)
      : "f"(d2), "f"(bw2));
}

// The inputs of one store of labels: four points and their mask bytes
// (vector path) or one (scalar path).
struct LabelIn {
  float4 p0, p1, p2;
  unsigned m;
};

__device__ __forceinline__ LabelIn load_label_in(
    const float* __restrict__ a, const unsigned char* __restrict__ am, int j,
    bool vec) {
  LabelIn in;
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(a + 3 * j);
    in.p0 = p[0];
    in.p1 = p[1];
    in.p2 = p[2];
    in.m = *reinterpret_cast<const unsigned*>(am + j);
  } else {
    in.p0 = make_float4(a[3 * j], a[3 * j + 1], a[3 * j + 2], 0.f);
    in.p1 = in.p2 = make_float4(0.f, 0.f, 0.f, 0.f);
    in.m = am[j];
  }
  return in;
}

// Labels of the points of `in` (one byte each): valid and within bw of the
// winner.
__device__ __forceinline__ unsigned label_bytes(const LabelIn& in, float wx,
                                                float wy, float wz, float bw2,
                                                bool vec) {
  const auto hit = [&](unsigned shift, float x, float y, float z) {
    return ((in.m >> shift) & 0xffu) != 0 && sqdist(wx, wy, wz, x, y, z) < bw2
               ? 1u << shift
               : 0u;
  };
  if (!vec) return hit(0, in.p0.x, in.p0.y, in.p0.z);
  return hit(0, in.p0.x, in.p0.y, in.p0.z) |
         hit(8, in.p0.w, in.p1.x, in.p1.y) |
         hit(16, in.p1.z, in.p1.w, in.p2.x) |
         hit(24, in.p2.y, in.p2.z, in.p2.w);
}

__device__ __forceinline__ void store_labels(unsigned char* row, int j,
                                             unsigned bytes, bool vec) {
  if (vec) {
    *reinterpret_cast<unsigned*>(row + j) = bytes;
  } else {
    row[j] = static_cast<unsigned char>(bytes);
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    winner_kernel(const float* __restrict__ pts,
                  const unsigned char* __restrict__ mask, int k, int cap,
                  float bw2, int* __restrict__ win,
                  unsigned char* __restrict__ labels,
                  int* __restrict__ counts) {
  constexpr int kWarps = kThreads / 32;
  // The stage: cap points, x, y, z and the row index's bits.
  extern __shared__ float4 s_dyn[];
  __shared__ int s_wcnt[2][kWarps];
  // Each warp's best key, read by every warp of the cluster.
  __shared__ unsigned long long s_wkey[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / kCluster;
  const float* a = pts + static_cast<size_t>(h) * k * 3;
  const unsigned char* am = mask + static_cast<size_t>(h) * k;
  unsigned char* row = labels + static_cast<size_t>(h) * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float4* st = s_dyn;
  const int tiles = (k + cap - 1) / cap;

  // This CTA's share of the row's labels, whole groups of four where the
  // row and its points are aligned to them.
  const bool vec = (k & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(pts) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(labels) & 3) == 0;
  const int step = vec ? 4 : 1;
  const int share = step * ((k + step * kCluster - 1) / (step * kCluster));
  const int j0 = min(k, rank * share);
  const int j1 = min(k, j0 + share);
  const int jt = j0 + step * tid;  // this thread's first store

  int staged = -1;  // the tile in the stage, and its valid points
  int n_staged = 0;
  auto ensure = [&](int t) {
    if (staged != t) {
      n_staged = stage_tile<kThreads>(a, am, t * cap, min(cap, k - t * cap),
                                      st, s_wcnt);
      staged = t;
    }
  };

  int v = 0;
  unsigned long long best = 0ull;
  for (int ta = 0; ta < tiles; ++ta) {
    ensure(ta);
    const int n_a = n_staged;
    v += n_a;
    const int c0 = n_a * rank / kCluster;
    const int c1 = n_a * (rank + 1) / kCluster;
    const int blocks = (c1 - c0 + kSeeds - 1) / kSeeds;  // CTA-uniform
    if (blocks == 0) continue;
    // Lanes a seed block: a power of two within a warp, so a block's
    // partial counts are summed by shuffles.
    int lanes = 1;
    while (lanes < 32 && 2 * lanes * blocks <= kThreads) lanes *= 2;
    const int groups = kThreads / lanes;
    const int g = tid / lanes;
    const int l = tid & (lanes - 1);
    for (int b0 = 0; b0 < blocks; b0 += groups) {
      ensure(ta);
      const int first_seed = c0 + (b0 + g) * kSeeds;
      const bool active = b0 + g < blocks;
      float sx[kSeeds], sy[kSeeds], sz[kSeeds];
      int sidx[kSeeds], cnt[kSeeds];
#pragma unroll
      for (int q = 0; q < kSeeds; ++q) {
        // Slots past the share hold no seed (index -1): counted, dropped.
        const bool real = active && first_seed + q < c1;
        const float4 p = real ? st[first_seed + q]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        sx[q] = p.x;
        sy[q] = p.y;
        sz[q] = p.z;
        sidx[q] = real ? index_of(p) : -1;
        cnt[q] = 0;
      }
      for (int tb = 0; tb < tiles; ++tb) {
        ensure(tb);
        if (!active) continue;
        // Lane l takes points l, l + lanes, ...: `trips` of them.
        const int trips = l < n_staged ? (n_staged - 1 - l) / lanes + 1 : 0;
        const float4* p = st + l;
        int i = 0;
        for (; i + 4 <= trips; i += 4, p += 4 * lanes) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 pt = p[u * lanes];
#pragma unroll
            for (int q = 0; q < kSeeds; ++q) {
              count_if_less(cnt[q],
                            sqdist(sx[q], sy[q], sz[q], pt.x, pt.y, pt.z),
                            bw2);
            }
          }
        }
        for (; i < trips; ++i, p += lanes) {
          const float4 pt = *p;
#pragma unroll
          for (int q = 0; q < kSeeds; ++q) {
            count_if_less(cnt[q],
                          sqdist(sx[q], sy[q], sz[q], pt.x, pt.y, pt.z), bw2);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kSeeds; ++q) {
        for (int off = lanes >> 1; off > 0; off >>= 1) {
          cnt[q] += __shfl_xor_sync(0xffffffffu, cnt[q], off);
        }
        if (sidx[q] >= 0) best = umax64(best, pack(cnt[q], sidx[q]));
      }
    }
  }

  if (v == 0) {
    // Every CTA counted the same mask: all leave here, none at a barrier.
    for (int j = jt; j < j1; j += step * kThreads) store_labels(row, j, 0u, vec);
    if (rank == 0 && tid == 0) {
      win[h] = 0;
      counts[h] = 0;
    }
    return;
  }

  // The inputs of this thread's first store of labels, loaded while the
  // cluster waits for its slowest CTA.
  LabelIn first = {};
  if (jt < j1) first = load_label_in(a, am, jt, vec);
  best = warp_max(best);
  if (lane == 0) s_wkey[warp] = best;
  cluster.sync();
  // The cluster's kCluster * kWarps keys, read by every warp.
  unsigned long long key = 0ull;
#pragma unroll
  for (int q = lane; q < kCluster * kWarps; q += 32) {
    key = umax64(key, cluster.map_shared_rank(
                          s_wkey, static_cast<unsigned>(q / kWarps))[q % kWarps]);
  }
  key = warp_max(key);
  // Done with the other CTAs' keys; the wait below keeps this CTA's keys
  // alive until every CTA has read them.
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  const int count = static_cast<int>(key >> 32);
  // Every count 0 (a bandwidth of 0): the first argmax is seed 0.
  const int w = count == 0
                    ? 0
                    : static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
  // The winner's coordinates from the stage when it holds them (always for
  // a row of one tile), else from the row.
  const int pos = lower_bound(st, n_staged, w);
  bool w_valid = true;
  float wx, wy, wz;
  if (pos < n_staged && index_of(st[pos]) == w) {
    wx = st[pos].x;
    wy = st[pos].y;
    wz = st[pos].z;
  } else {
    w_valid = am[w] != 0;
    wx = a[3 * w];
    wy = a[3 * w + 1];
    wz = a[3 * w + 2];
  }
  for (int j = jt; j < j1; j += step * kThreads) {
    const LabelIn in = j == jt ? first : load_label_in(a, am, j, vec);
    store_labels(row, j, w_valid ? label_bytes(in, wx, wy, wz, bw2, vec) : 0u,
                 vec);
  }
  if (rank == 0 && tid == 0) {
    win[h] = w;
    counts[h] = count;
  }
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <int kThreads>
cudaLaunchConfig_t launch_config(int h, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(h * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allows an instance its largest stage and counts the clusters of kCluster
// CTAs with it that are resident on the current device at once.
template <int kThreads>
cudaError_t check_instance(int* clusters) {
  auto kernel = winner_kernel<kThreads>;
  const size_t smem = smem_bytes(kStagePoints);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<kThreads>(1, smem, nullptr, &attr);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  }
  return e;
}

// Once per device (a function attribute holds per device): both
// instances' shared memory and cluster checks, and how many clusters of
// each are resident on the card at once.
struct DeviceSetup {
  int status;
  int clusters[2];  // CTAs of 128, 256 threads
};

const DeviceSetup& prepare(int device) {
  static std::once_flag once[kMaxDevices];
  static DeviceSetup setup[kMaxDevices];
  std::call_once(once[device], [device] {
    DeviceSetup& d = setup[device];
    cudaError_t e = check_instance<128>(&d.clusters[0]);
    if (e == cudaSuccess) e = check_instance<256>(&d.clusters[1]);
    d.status = e != cudaSuccess                           ? static_cast<int>(e)
               : d.clusters[0] == 0 || d.clusters[1] == 0 ? kErrNoCluster
                                                          : 0;
  });
  return setup[device];
}

template <int kThreads>
int launch(const float* pts, const unsigned char* mask, int h, int k,
           float bw2, int* win, unsigned char* labels, int* counts,
           cudaStream_t stream) {
  const int cap = k < 1 ? 1 : (k < kStagePoints ? k : kStagePoints);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<kThreads>(h, smem_bytes(cap), stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, winner_kernel<kThreads>, pts, mask, k, cap, bw2, win, labels,
      counts);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The threads per CTA of a launch for h hypotheses on the current device
// (into *threads): 256 when all h clusters of such CTAs are resident at
// once (the pose stage's 21 hypotheses), else 128 (its 168), whose smaller
// CTAs hold more clusters at once.  Returns the device setup's status.
int cta_threads(int h, int* threads) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const DeviceSetup& setup = prepare(device);
  *threads = h <= setup.clusters[1] ? 256 : 128;
  return setup.status;
}

}  // namespace

// pts (h, k, 3) float32, mask (h, k) bool bytes; win (h,) int32,
// labels (h, k) bool bytes, counts (h,) int32.  One cluster per hypothesis.
extern "C" int winner_launch(const float* pts, const unsigned char* mask,
                             int h, int k, float bw2, int* win,
                             unsigned char* labels, int* counts,
                             cudaStream_t stream) {
  int threads = 0;
  const int ready = cta_threads(h, &threads);
  if (ready != 0) return ready;
  return threads == 256
             ? launch<256>(pts, mask, h, k, bw2, win, labels, counts, stream)
             : launch<128>(pts, mask, h, k, bw2, win, labels, counts, stream);
}

// The threads per CTA winner_launch takes for h hypotheses; 0 when the
// device's setup failed (winner_launch then returns the error).
extern "C" int winner_cta_threads(int h) {
  int threads = 0;
  return cta_threads(h, &threads) == 0 ? threads : 0;
}

extern "C" const char* kernel_error_string(int code) {
  if (code == kErrNoCluster) {
    return "no cluster of 8 CTAs with a 2048-point stage can be scheduled "
           "on this card";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
