// k-NN: the indices of the k nearest candidates of each query, k = 1 or 16.
//
// Replaces no TPU kernel: the JAX package runs PVN3D only.  FFB6D's
// bidirectional fusion needs 22 searches a frame on 3-D points
// (data/ffb6d_index.py): the 16 nearest of a cloud level within itself,
// of sampled points among a stride-s map's pixels, and the 1 nearest of a
// level's points in the next level or of each map pixel among the sampled
// points, with up to 76800 queries or candidates.  A cdist + topk writes a
// Q x C float32 matrix (983 MB at 76800 x 3200); this kernel writes none.
//
// Semantics: for each query the k candidates smallest in lexicographic
// (d^2, index) order, d^2 = ((dx*dx)+(dy*dy))+(dz*dz) in float32 with
// round-to-nearest intrinsics (no FMA contraction), so the order equals
// the plain version's (ops/kernels/knn.py::knn_plain).  When C < k the
// empty slots repeat the nearest candidate's index.  Output (B, Q, k)
// int32, nearest first.
//
// Bound: operations.  8 flops a (query, candidate) pair; bytes are the
// coordinates and the indices, at most a few MB a search.  Warp-select: a
// warp per query, the block's 8 queries sharing shared-memory tiles of
// 1024 float4 candidates, 32 candidates a step (one a lane), four steps
// at once.  The top-16 is spread over lanes 0..15, and a candidate nearer
// than slot 15 (found by a ballot) is inserted by one shuffle-up of the
// slots behind it: a few instructions for the whole warp, in (d^2, index)
// order.  The tiles are visited in a scrambled order: the map pixels come
// in raster order, and scanned in it the nearest rows come last, with
// inserts at every row on the way.  When the queries alone would not fill
// the card the candidates are split into S segments (grid.y); the partial
// lists, (B, S, k, Q) so that both passes touch them coalesced, are
// merged by knn_merge in segment order.
// Two designs were measured and dropped (PERF.md section 6): a thread per
// query with a register top-k (faster only at three of the four 1-NN
// searches with 19200 or more queries: 2.17 against 2.34 ms a frame for
// the 22 searches), and K3's
// (csrc/interp.cu: lane-split lists, a butterfly of bitonic merges;
// fastest at 12 of the 22 shapes, each under 0.13 ms, by 0.12 ms in all,
// and 2-6x slower at the four largest).

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMergeBlock = 128;
constexpr int kTile = 1024;
constexpr int kNone = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

template <int K>
__device__ __forceinline__ void clear(float (&d)[K], int (&id)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    d[s] = CUDART_INF_F;
    id[s] = kNone;
  }
}

// Insert (dd, j) into the sorted list; the merge takes the segments' lists
// in index order, so strict '<' keeps ties by index.
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], int (&id)[K], float dd,
                                       int j) {
  if (!(dd < d[K - 1])) return;
  d[K - 1] = dd;
  id[K - 1] = j;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (d[s] < d[s - 1]) {
      const float td = d[s];
      d[s] = d[s - 1];
      d[s - 1] = td;
      const int ti = id[s];
      id[s] = id[s - 1];
      id[s - 1] = ti;
    }
  }
}

// The list's index at slot s, with an empty slot (C < k) read as the
// nearest candidate.
template <int K>
__device__ __forceinline__ int slot_index(const int (&id)[K], int s) {
  return id[s] == kNone ? id[0] : id[s];
}

template <int K>
__device__ __forceinline__ void store(int* __restrict__ out, size_t row,
                                      const int (&id)[K]) {
  int* o = out + row * K;
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int s = 0; s < K; s += 4) {
      reinterpret_cast<int4*>(o)[s / 4] =
          make_int4(slot_index(id, s), slot_index(id, s + 1),
                    slot_index(id, s + 2), slot_index(id, s + 3));
    }
  } else {
#pragma unroll
    for (int s = 0; s < K; ++s) o[s] = slot_index(id, s);
  }
}

template <int K>
__global__ void __launch_bounds__(kMergeBlock)
    knn_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
              int nq, int nseg, int* __restrict__ out) {
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kMergeBlock + threadIdx.x;
  if (qi >= nq) return;
  float d[K];
  int id[K];
  clear(d, id);
  for (int seg = 0; seg < nseg; ++seg) {
    const size_t base = (static_cast<size_t>(b) * nseg + seg) * K * nq + qi;
    for (int s = 0; s < K; ++s) {
      const float dd = part_d[base + static_cast<size_t>(s) * nq];
      if (!(dd < d[K - 1])) break;     // the rest of this list is no nearer
      insert(d, id, dd, part_i[base + static_cast<size_t>(s) * nq]);
    }
  }
  store(out, static_cast<size_t>(b) * nq + qi, id);
}

// Warp-select.  k = 16: lane s < 16 holds slot s; a ballot finds whether
// any of the four batches holds a candidate not behind slot 15, and each
// such candidate is inserted by one shuffle-up of the slots behind it in
// (d^2, index) order.  k = 1: a running minimum a lane, merged by a
// shuffle butterfly.
constexpr int kSelectWarps = 8;
constexpr int kSelectUnroll = 4;
constexpr int kScramble = 7919;

template <int K>
__device__ __forceinline__ void select_insert(float dd, int j, int lane,
                                              float& sd, int& si,
                                              float& worst, int& worst_i) {
  unsigned mask = __ballot_sync(kFull, dd <= worst);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float dv = __shfl_sync(kFull, dd, src);
    const int jv = __shfl_sync(kFull, j, src);
    if (before(dv, jv, worst, worst_i)) {          // warp-uniform
      const bool gt = lane < K && before(dv, jv, sd, si);
      const int pos = __ffs(__ballot_sync(kFull, gt)) - 1;
      const float ud = __shfl_up_sync(kFull, sd, 1);
      const int ui = __shfl_up_sync(kFull, si, 1);
      if (gt) {
        sd = lane == pos ? dv : ud;
        si = lane == pos ? jv : ui;
      }
      worst = __shfl_sync(kFull, sd, K - 1);
      worst_i = __shfl_sync(kFull, si, K - 1);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(32 * kSelectWarps)
    knn_select(const float* __restrict__ query, const float* __restrict__ cand,
               int nq, int nc, int seg_len, float* __restrict__ part_d,
               int* __restrict__ part_i, int* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int seg = blockIdx.y;
  const int nseg = gridDim.y;
  const int qi = blockIdx.x * kSelectWarps + (threadIdx.x >> 5);
  const bool live = qi < nq;   // warp-uniform; every warp loads the tiles
  const float* qp =
      query + (static_cast<size_t>(b) * nq + min(qi, nq - 1)) * 3;
  const float qx = __ldg(qp), qy = __ldg(qp + 1), qz = __ldg(qp + 2);
  const float* cp = cand + static_cast<size_t>(b) * nc * 3;
  float sd = CUDART_INF_F;
  int si = kNone;
  float worst = CUDART_INF_F;
  int worst_i = kNone;
  const int c0 = seg * seg_len;
  const int c1 = min(nc, c0 + seg_len);
  const int tiles = max(0, (c1 - c0 + kTile - 1) / kTile);
  const int step = tiles % kScramble == 0 ? 1 : kScramble;
  for (int t = 0; t < tiles; ++t) {
    // Tiles in a scrambled order (kScramble is prime, so t -> t * step mod
    // tiles is a permutation): candidates in raster order would bring the
    // nearest last and insert at every row on the way.
    const int t0 = c0 + static_cast<int>(
        (static_cast<long long>(t) * step) % tiles) * kTile;
    const int n = min(kTile, c1 - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += 32 * kSelectWarps) {
      const float* p = cp + static_cast<size_t>(t0 + j) * 3;
      tile[j] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
    }
    __syncthreads();
    if (!live) continue;
    for (int j0 = 0; j0 < n; j0 += 32 * kSelectUnroll) {
      // A lane past the tile's end holds (inf, none): never inserted.
      float dd[kSelectUnroll];
      int jj[kSelectUnroll];
#pragma unroll
      for (int u = 0; u < kSelectUnroll; ++u) {
        const int j = j0 + 32 * u + lane;
        dd[u] = CUDART_INF_F;
        jj[u] = kNone;
        if (j < n) {
          const float4 c = tile[j];
          dd[u] = sqdist(qx, qy, qz, c.x, c.y, c.z);
          jj[u] = t0 + j;
        }
      }
      if constexpr (K == 1) {
#pragma unroll
        for (int u = 0; u < kSelectUnroll; ++u) {
          if (before(dd[u], jj[u], sd, si)) {
            sd = dd[u];
            si = jj[u];
          }
        }
      } else {
        float lo = dd[0];
#pragma unroll
        for (int u = 1; u < kSelectUnroll; ++u) lo = fminf(lo, dd[u]);
        if (!__any_sync(kFull, lo <= worst)) continue;
#pragma unroll
        for (int u = 0; u < kSelectUnroll; ++u) {
          select_insert<K>(dd[u], jj[u], lane, sd, si, worst, worst_i);
        }
      }
    }
  }
  if (!live) return;
  if constexpr (K == 1) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, sd, off);
      const int oi = __shfl_xor_sync(kFull, si, off);
      if (before(od, oi, sd, si)) {
        sd = od;
        si = oi;
      }
    }
  }
  if (nseg == 1) {
    const int first = __shfl_sync(kFull, si, 0);
    if (lane < K) {
      out[(static_cast<size_t>(b) * nq + qi) * K + lane] =
          si == kNone ? first : si;
    }
    return;
  }
  if (lane < K) {
    const size_t at = ((static_cast<size_t>(b) * nseg + seg) * K + lane) * nq
                      + qi;
    part_d[at] = sd;
    part_i[at] = si;
  }
}

template <int K>
cudaError_t launch(const float* query, const float* cand, int b, int nq,
                   int nc, int nseg, float* part_d, int* part_i, int* out,
                   cudaStream_t stream) {
  const int seg_len = (nc + nseg - 1) / nseg;
  const dim3 grid((nq + kSelectWarps - 1) / kSelectWarps, nseg, b);
  knn_select<K><<<grid, 32 * kSelectWarps, 0, stream>>>(
      query, cand, nq, nc, seg_len, part_d, part_i, out);
  if (nseg > 1) {
    const dim3 mgrid((nq + kMergeBlock - 1) / kMergeBlock, b);
    knn_merge<K><<<mgrid, kMergeBlock, 0, stream>>>(part_d, part_i, nq, nseg,
                                                    out);
  }
  return cudaGetLastError();
}

}  // namespace

// query (B, Q, 3), cand (B, C, 3) float32 -> out (B, Q, k) int32, over
// nseg candidate segments (part_d / part_i hold B * nseg * k * Q entries
// each when nseg > 1).
extern "C" int knn_launch(const float* query, const float* cand, int b,
                          int nq, int nc, int k, int nseg, float* part_d,
                          int* part_i, int* out, cudaStream_t stream) {
  if (nq < 1 || nc < 1 || b < 1 || nseg < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  switch (k) {
    case 1:
      err = launch<1>(query, cand, b, nq, nc, nseg, part_d, part_i, out,
                      stream);
      break;
    case 16:
      err = launch<16>(query, cand, b, nq, nc, nseg, part_d, part_i, out,
                       stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
