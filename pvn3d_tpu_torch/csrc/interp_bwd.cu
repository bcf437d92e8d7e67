// K3 backward: the gradient of the 3-NN inverse-distance blend with respect
// to the known features, a deterministic scatter-add.
//
// Replaces pvn3d_tpu/ops/pallas/interp.py::_fused_bwd, the custom VJP of
// three_interpolate_fused:
//   g_features[b, idx[b,i,k], :] += w[b,i,k] * g_out[b,i,:]
// with w recomputed from the saved distances exactly as the forward kernel
// computed it: r_k = 1/(d_k + eps), w_k = r_k / ((r0 + r1) + r2).  The
// coordinate inputs get no gradient.
//
// Bound: bytes.  g_out (B, n, C) is read once and g_features (B, m, C)
// written once.  Design: a gather by destination over inverted lists, so no
// floating-point atomics and a fixed order.  One entry point issues five
// kernels on the stream; the flattened entries p = 3i + k of a batch row are
// cut into tiles of 1024.
// 1. rank   one warp per tile: its 32 runs of 32 entries are matched
//           (__match_any_sync) all at once, then walked in order, each
//           entry ranked among the tile's earlier entries with the same
//           destination j by a per-tile counter row (shared memory for
//           m <= 12288, else the tile's row of the count table), which is
//           written out as the tile's histogram (B, tiles, m).
// 2. cols   a thread per destination: its count before each tile.
// 3. rows   a block per batch row: the exclusive scan of the destinations'
//           totals (the start of each list), and the list of destinations
//           with more than kLong hits.
// 4. fill   a thread per unknown row computes its three weights once and
//           writes each entry (i, w) to start[j] + before-tile[j] + rank:
//           a stable counting sort, so every list is in (i, k) order.
// 5. sum    lists of at most kLong hits: a warp per (destination, 128
//           channels), 32 entries a load, 8 g_out rows loaded ahead of the
//           in-order sum (float4; scalar when C % 4 != 0 or a pointer is not
//           16-byte aligned).  Longer lists (the training batch's clustered
//           clouds reach 1832 hits at fp0): one warp alone keeps too few
//           loads in flight, so the first blocks of the same launch take
//           them, a block per (destination, 32 channels) whose four warps
//           stage 64 hits at a time into shared memory with cp.async (four
//           hits an instruction when rows are float4-aligned) while warp 0
//           sums the previous 64 in order.  Every sum is
//           acc = acc + (w * g) with round-to-nearest intrinsics and no FMA
//           contraction; a row nothing points at is written as zeros.
// The plain version sums the stably sorted hit lists in the same order, so
// the two are equal bit for bit and two runs on the same input are too.
// Work: O(B * (3n + tiles * m)) index steps (tiles * m = 3n * m / 1024)
// plus B * 3n * C multiply-adds; the first kernel scanned all 3n entries
// once per destination (B * m * 3n index tests).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;            // flattened entries per rank tile
constexpr int kRuns = kTile / 32;
constexpr int kSharedCounters = 12288; // m up to which counters are shared
constexpr int kColThreads = 256;
constexpr int kRowThreads = 1024;
constexpr int kFillThreads = 256;
constexpr int kSumWarps = 4;
constexpr int kAhead = 8;              // g_out rows loaded ahead of the sum
constexpr int kVec = 4;                // channels a lane sums (float4)
constexpr int kLong = 128;             // longer lists: the sum's block role
constexpr int kChunk = 64;             // hits a long-list block stages
constexpr int kPer = kChunk / kSumWarps;  // ... per warp
constexpr int kLongBlocks = 264;       // 2 per SM of an H100
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32)
    three_interp_bwd_rank(const int* __restrict__ idx, int n3, int m,
                          int tiles, bool shared_counters,
                          int* __restrict__ counts, int* __restrict__ rank) {
  extern __shared__ int s_ctr[];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  int* hist = counts + (static_cast<size_t>(b) * tiles + t) * m;
  int* ctr = shared_counters ? s_ctr : hist;
  for (int j = lane; j < m; j += 32) ctr[j] = 0;
  __syncwarp();
  const int* ib = idx + static_cast<size_t>(b) * n3;
  int* rb = rank + static_cast<size_t>(b) * n3;
  const unsigned lt = (1u << lane) - 1u;
  const int p0 = t * kTile;
  // All the tile's destinations load at once; the walk is then a chain of
  // shared-memory steps, not of global loads.
  int dst[kRuns];
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int p = p0 + 32 * r + lane;
    dst[r] = p < n3 ? __ldg(ib + p) : -1;
  }
  // The matches do not depend on the counters: all 32 first, so only the
  // shared-memory read-modify-write is a chain.
  unsigned peers[kRuns];
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const bool valid = static_cast<unsigned>(dst[r]) < static_cast<unsigned>(m);
    peers[r] = __match_any_sync(kFull, valid ? dst[r] : -1);
  }
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    if (p0 + 32 * r >= n3) break;   // warp-uniform
    const int j = dst[r];
    const bool valid = static_cast<unsigned>(j) < static_cast<unsigned>(m);
    const int before = valid ? ctr[j] : 0;
    __syncwarp();
    if (valid && (peers[r] & lt) == 0u) ctr[j] = before + __popc(peers[r]);
    __syncwarp();
    if (valid) rb[p0 + 32 * r + lane] = before + __popc(peers[r] & lt);
  }
  if (shared_counters) {
    for (int j = lane; j < m; j += 32) hist[j] = s_ctr[j];
  }
}

// Down the tile axis, a thread per destination: its count before each
// tile, and its total (into start[j], for the row scan).
__global__ void __launch_bounds__(kColThreads)
    three_interp_bwd_cols(const int* __restrict__ counts, int m, int tiles,
                          int* __restrict__ before_tile,
                          int* __restrict__ start) {
  const int j = blockIdx.x * kColThreads + threadIdx.x;
  if (j >= m) return;
  const int b = blockIdx.y;
  const int* cb = counts + static_cast<size_t>(b) * tiles * m + j;
  int* pb = before_tile + static_cast<size_t>(b) * tiles * m + j;
  int run = 0;
  for (int t0 = 0; t0 < tiles; t0 += 16) {
    int v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      v[u] = t0 + u < tiles ? cb[static_cast<size_t>(t0 + u) * m] : 0;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (t0 + u < tiles) {
        pb[static_cast<size_t>(t0 + u) * m] = run;
        run += v[u];
      }
    }
  }
  start[static_cast<size_t>(b) * (m + 1) + j] = run;
}

// Across the destinations, a block per batch row: exclusive scan of the
// totals, 1024 a round, and the list of destinations longer than kLong for
// the sum's block role (its order is free: it only says which block sums
// which destination).
__global__ void __launch_bounds__(kRowThreads)
    three_interp_bwd_rows(int m, int* __restrict__ start,
                          int* __restrict__ long_rows,
                          int* __restrict__ n_long) {
  __shared__ int s_warp[32];
  __shared__ int s_long;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* sb = start + static_cast<size_t>(b) * (m + 1);
  int* lb = long_rows + static_cast<size_t>(b) * m;
  if (threadIdx.x == 0) s_long = 0;
  int carry = 0;
  for (int j0 = 0; j0 < m; j0 += kRowThreads) {
    __syncthreads();
    const int j = j0 + threadIdx.x;
    const int v = j < m ? sb[j] : 0;
    if (v > kLong) lb[atomicAdd(&s_long, 1)] = j;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    if (j < m) sb[j] = carry + (warp ? s_warp[warp - 1] : 0) + x - v;
    carry += s_warp[31];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sb[m] = carry;
    n_long[b] = s_long;
  }
}

__global__ void __launch_bounds__(kFillThreads)
    three_interp_bwd_fill(const int* __restrict__ idx,
                          const float* __restrict__ dist,
                          const int* __restrict__ rank,
                          const int* __restrict__ before_tile,
                          const int* __restrict__ start, int n, int m,
                          int tiles, float eps, int2* __restrict__ list) {
  const int i = blockIdx.x * kFillThreads + threadIdx.x;
  if (i >= n) return;
  const int b = blockIdx.y;
  const size_t n3 = 3 * static_cast<size_t>(n);
  const size_t e = static_cast<size_t>(b) * n3 + 3 * static_cast<size_t>(i);
  const float r0 = __fdiv_rn(1.f, __fadd_rn(dist[e], eps));
  const float r1 = __fdiv_rn(1.f, __fadd_rn(dist[e + 1], eps));
  const float r2 = __fdiv_rn(1.f, __fadd_rn(dist[e + 2], eps));
  const float sum = __fadd_rn(__fadd_rn(r0, r1), r2);
  const float w[3] = {__fdiv_rn(r0, sum), __fdiv_rn(r1, sum),
                      __fdiv_rn(r2, sum)};
  const int* sb = start + static_cast<size_t>(b) * (m + 1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = idx[e + k];
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(m)) continue;
    const int p = 3 * i + k;
    const int pos = sb[j] +
                    before_tile[(static_cast<size_t>(b) * tiles + p / kTile) *
                                    m + j] +
                    rank[e + k];
    list[static_cast<size_t>(b) * n3 + pos] =
        make_int2(i, __float_as_int(w[k]));
  }
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T axpy(T acc, float w, T g) {
    return make_float4(__fadd_rn(acc.x, __fmul_rn(w, g.x)),
                       __fadd_rn(acc.y, __fmul_rn(w, g.y)),
                       __fadd_rn(acc.z, __fmul_rn(w, g.z)),
                       __fadd_rn(acc.w, __fmul_rn(w, g.w)));
  }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T axpy(T acc, float w, T g) {
    return make_float2(__fadd_rn(acc.x, __fmul_rn(w, g.x)),
                       __fadd_rn(acc.y, __fmul_rn(w, g.y)));
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T axpy(T acc, float w, T g) {
    return __fadd_rn(acc, __fmul_rn(w, g));
  }
};

// Lists longer than kLong: one warp alone keeps too few loads in flight
// for a list of thousands of hits, so a block of kSumWarps warps sums one
// (destination, 32 channels): all its warps stage the next kChunk hits'
// channels into shared memory with cp.async while warp 0 sums the current
// chunk in list order, lanes along the channels.
template <bool kVec4>
__device__ __forceinline__ void sum_long(
    const float* __restrict__ g_out, const int2* __restrict__ lb,
    const int* __restrict__ sb, const int* __restrict__ long_rows,
    int tasks, int long_blocks, int n, int m, int c, int b,
    float* __restrict__ g_feat, float (*s_g)[kChunk][32],
    float (*s_w)[kChunk]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = (c + 31) / 32;
  for (int task = blockIdx.x; task < tasks; task += long_blocks) {
    const int j = long_rows[task / groups];
    const int col0 = (task % groups) * 32;
    const int col = col0 + lane;
    const bool live = col < c;
    const float* gb = g_out + static_cast<size_t>(b) * n * c;
    const int h0 = sb[j];
    const int h1 = sb[j + 1];
    const int chunks = (h1 - h0 + kChunk - 1) / kChunk;
    // Warp w stages hits w*kPer .. (w+1)*kPer-1 of a chunk: with float4
    // rows, 8 lanes a hit and 4 hits an instruction; else lane = channel.
    auto stage = [&](int ch, int buf) {
      const int q0 = warp * kPer;
      const int h = h0 + ch * kChunk + q0;
      const int2 e = lane < kPer && h + lane < h1 ? __ldg(lb + h + lane)
                                                  : make_int2(0, 0);
      if (lane < kPer) s_w[buf][q0 + lane] = __int_as_float(e.y);
      const int cnt = min(kPer, h1 - h);
      if constexpr (kVec4) {
        const int sub = lane >> 3;            // which of the 4 hits
        const int c4 = col0 + 4 * (lane & 7); // its first channel
        for (int q = 0; q < cnt; q += 4) {
          const int i = __shfl_sync(kFull, e.x, (q + sub) & 31);
          if (q + sub < cnt && c4 < c) {
            __pipeline_memcpy_async(&s_g[buf][q0 + q + sub][4 * (lane & 7)],
                                    gb + static_cast<size_t>(i) * c + c4,
                                    4 * sizeof(float));
          }
        }
      } else {
        for (int q = 0; q < cnt; ++q) {
          const int i = __shfl_sync(kFull, e.x, q);
          if (live) {
            __pipeline_memcpy_async(&s_g[buf][q0 + q][lane],
                                    gb + static_cast<size_t>(i) * c + col,
                                    sizeof(float));
          }
        }
      }
      __pipeline_commit();
    };
    float acc = 0.f;
    stage(0, 0);
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch + 1 < chunks) {
        stage(ch + 1, (ch + 1) & 1);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      if (warp == 0) {
        const int buf = ch & 1;
        const int cnt = min(kChunk, h1 - h0 - ch * kChunk);
        for (int q = 0; q < cnt; ++q) {
          acc = __fadd_rn(acc, __fmul_rn(s_w[buf][q], s_g[buf][q][lane]));
        }
      }
      __syncthreads();
    }
    if (warp == 0 && live) {
      g_feat[(static_cast<size_t>(b) * m + j) * c + col] = acc;
    }
  }
}

// The sum, one launch with two roles.  Blocks 0 .. long_blocks-1 come first
// and take the lists longer than kLong (sum_long); every later block's warps
// each take one (destination, 32 * V channels) with at most kLong hits: 32
// entries a load, kAhead g_out rows loaded ahead of the in-order sum.
template <int V>
__global__ void __launch_bounds__(32 * kSumWarps)
    three_interp_bwd_sum(const float* __restrict__ g_out,
                         const int2* __restrict__ list,
                         const int* __restrict__ start,
                         const int* __restrict__ long_rows,
                         const int* __restrict__ n_long, int n, int m, int c,
                         int groups, int long_blocks,
                         float* __restrict__ g_feat) {
  __shared__ __align__(16) float s_g[2][kChunk][32];
  __shared__ float s_w[2][kChunk];
  using T = typename Vec<V>::T;
  const int b = blockIdx.y;
  const int* sb = start + static_cast<size_t>(b) * (m + 1);
  const int2* lb = list + static_cast<size_t>(b) * 3 * n;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    sum_long<V == 4>(g_out, lb, sb, long_rows + static_cast<size_t>(b) * m,
                     n_long[b] * ((c + 31) / 32), long_blocks, n, m, c, b,
                     g_feat, s_g, s_w);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int task = (blockIdx.x - long_blocks) * kSumWarps +
                   (threadIdx.x >> 5);
  if (task >= m * groups) return;   // warp-uniform; no block barrier here
  const int j = task / groups;
  const int col = ((task - j * groups) * 32 + lane) * V;
  const bool live = col < c;
  const int h0 = sb[j];
  const int h1 = sb[j + 1];
  if (h1 - h0 > kLong) return;   // a long list: sum_long's
  const float* gb = g_out + static_cast<size_t>(b) * n * c + col;

  T acc = Vec<V>::zero();
  int2 e = h0 + lane < h1 ? __ldg(lb + h0 + lane) : make_int2(0, 0);
  for (int h = h0; h < h1; h += 32) {
    const int cnt = min(32, h1 - h);
    // The next 32 entries load while these are summed.
    const int2 e_next = h + 32 + lane < h1 ? __ldg(lb + h + 32 + lane)
                                           : make_int2(0, 0);
    for (int u = 0; u < cnt; u += kAhead) {
      T g[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int i = __shfl_sync(kFull, e.x, (u + q) & 31);
        g[q] = live && u + q < cnt
                   ? __ldg(reinterpret_cast<const T*>(
                         gb + static_cast<size_t>(i) * c))
                   : Vec<V>::zero();
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const float w = __int_as_float(__shfl_sync(kFull, e.y, (u + q) & 31));
        if (u + q < cnt) acc = Vec<V>::axpy(acc, w, g[q]);
      }
    }
    e = e_next;
  }
  if (live) {
    *reinterpret_cast<T*>(g_feat + (static_cast<size_t>(b) * m + j) * c +
                          col) = acc;
  }
}

}  // namespace

// scratch: int32 words, laid out as list (2 * b * 3n, (i, w) pairs), rank
// (b * 3n), counts and before_tile (b * tiles * m each), start
// (b * (m + 1)), long_rows (b * m), n_long (b);
// ops/kernels/interp.py::backward_scratch_words sizes it.
extern "C" int three_interp_bwd_launch(const float* g_out, const int* idx,
                                       const float* dist, int b, int n, int m,
                                       int c, float eps, int tiles,
                                       int* scratch, float* g_feat,
                                       cudaStream_t stream) {
  const int n3 = 3 * n;
  if (tiles != (n3 + kTile - 1) / kTile || m < 1 || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t entries = static_cast<size_t>(b) * n3;
  int2* list = reinterpret_cast<int2*>(scratch);
  int* rank = scratch + 2 * entries;
  int* counts = rank + entries;
  int* before_tile = counts + static_cast<size_t>(b) * tiles * m;
  int* start = before_tile + static_cast<size_t>(b) * tiles * m;
  int* long_rows = start + static_cast<size_t>(b) * (m + 1);
  int* n_long = long_rows + static_cast<size_t>(b) * m;
  if (tiles > 0) {
    const bool shared_counters = m <= kSharedCounters;
    three_interp_bwd_rank<<<dim3(tiles, b), 32,
                            shared_counters ? m * sizeof(int) : 0, stream>>>(
        idx, n3, m, tiles, shared_counters, counts, rank);
  }
  three_interp_bwd_cols<<<dim3((m + kColThreads - 1) / kColThreads, b),
                          kColThreads, 0, stream>>>(counts, m, tiles,
                                                    before_tile, start);
  three_interp_bwd_rows<<<b, kRowThreads, 0, stream>>>(m, start, long_rows,
                                                        n_long);
  if (n > 0) {
    three_interp_bwd_fill<<<dim3((n + kFillThreads - 1) / kFillThreads, b),
                            kFillThreads, 0, stream>>>(
        idx, dist, rank, before_tile, start, n, m, tiles, eps, list);
  }
  const bool vec = (c % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(g_out) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(g_feat) % 16 == 0);
  const int per_warp = vec ? 32 * kVec : 32;
  const int groups = (c + per_warp - 1) / per_warp;
  // No list is longer than kLong unless 3n is; then at most 3n / kLong are.
  const int long_blocks =
      n3 > kLong ? min(kLongBlocks, n3 / (kLong + 1) * ((c + 31) / 32)) : 0;
  const dim3 grid(long_blocks + (m * groups + kSumWarps - 1) / kSumWarps, b);
  if (vec) {
    three_interp_bwd_sum<kVec><<<grid, 32 * kSumWarps, 0, stream>>>(
        g_out, list, start, long_rows, n_long, n, m, c, groups, long_blocks,
        g_feat);
  } else {
    three_interp_bwd_sum<1><<<grid, 32 * kSumWarps, 0, stream>>>(
        g_out, list, start, long_rows, n_long, n, m, c, groups, long_blocks,
        g_feat);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
