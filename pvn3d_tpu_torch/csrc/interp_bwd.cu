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
// written once; the index tests (m * 3n per batch row) are integer
// compares.  Design: a gather by destination, so no atomics and a fixed
// order.  One warp owns one known row j.  It scans its batch row's
// flattened idx (3n entries) in index order, 4 runs of 32 a trip (the
// loads of a trip are independent), finds its hits with a ballot and gives
// each hit the slot popc(ballot & lanemask_lt) in a small shared list of
// (i, w), so the list is in (i, k) order.  The list is then summed into
// the row with lanes along the channel axis (float4 when C % 4 == 0), each
// channel's sum taken in list order: acc = acc + (w * g) with
// round-to-nearest intrinsics and no FMA contraction, which the plain
// version repeats, so the two are equal bit for bit and two runs on the
// same input are too.  A list that fills (more than 32 hits pending) is
// flushed into the row and the sum goes on from what the row holds, so any
// chain length works: all 3n entries may name one row.  The four warps of a
// block own neighbouring rows of one batch row and scan the same idx, which
// they share through L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRuns = 4;     // 32-entry runs loaded per trip
constexpr int kCap = 64;     // pending hits a warp holds before a flush
constexpr unsigned kFull = 0xffffffffu;

// Sum the warp's pending hits into its row, channel by channel in list
// order.  `first`: the row holds nothing yet (start from 0), else go on
// from what an earlier flush wrote.
template <bool kVec>
__device__ __forceinline__ void flush(const float* __restrict__ gb,
                                      float* __restrict__ orow,
                                      const int* s_i, const float* s_w,
                                      int count, int c, bool first,
                                      int lane) {
  __syncwarp();
  if constexpr (kVec) {
    const int c4 = c >> 2;
    float4* o4 = reinterpret_cast<float4*>(orow);
    for (int q = lane; q < c4; q += 32) {
      float4 acc = first ? make_float4(0.f, 0.f, 0.f, 0.f) : o4[q];
#pragma unroll 4
      for (int h = 0; h < count; ++h) {
        const float w = s_w[h];
        const float4 g = __ldg(reinterpret_cast<const float4*>(
                                   gb + static_cast<size_t>(s_i[h]) * c) + q);
        acc.x = __fadd_rn(acc.x, __fmul_rn(w, g.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(w, g.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(w, g.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(w, g.w));
      }
      o4[q] = acc;
    }
  } else {
    for (int ch = lane; ch < c; ch += 32) {
      float acc = first ? 0.f : orow[ch];
#pragma unroll 4
      for (int h = 0; h < count; ++h) {
        acc = __fadd_rn(acc, __fmul_rn(
            s_w[h], __ldg(gb + static_cast<size_t>(s_i[h]) * c + ch)));
      }
      orow[ch] = acc;
    }
  }
  __syncwarp();
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    three_interp_bwd_kernel(const float* __restrict__ g_out,
                            const int* __restrict__ idx,
                            const float* __restrict__ dist, int n, int m,
                            int c, float eps, float* __restrict__ g_feat) {
  __shared__ int s_i[kWarps][kCap];
  __shared__ float s_w[kWarps][kCap];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int j = blockIdx.x * kWarps + warp;
  if (j >= m) return;   // warp-uniform; the kernel has no block barrier
  const int n3 = 3 * n;
  const int* ib = idx + static_cast<size_t>(b) * n3;
  const float* db = dist + static_cast<size_t>(b) * n3;
  const float* gb = g_out + static_cast<size_t>(b) * n * c;
  float* orow = g_feat + (static_cast<size_t>(b) * m + j) * c;
  const unsigned lt = (1u << lane) - 1u;

  int count = 0;
  bool first = true;
  for (int base = 0; base < n3; base += 32 * kRuns) {
    int v[kRuns];
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int p = base + 32 * r + lane;
      v[r] = p < n3 ? __ldg(ib + p) : -1;
    }
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const bool hit = v[r] == j;
      const unsigned mask = __ballot_sync(kFull, hit);
      if (mask == 0u) continue;
      if (count > kCap - 32) {
        flush<kVec>(gb, orow, s_i[warp], s_w[warp], count, c, first, lane);
        count = 0;
        first = false;
      }
      if (hit) {
        const int p = base + 32 * r + lane;
        const int i = p / 3;
        const int k = p - 3 * i;
        const float r0 = __fdiv_rn(1.f, __fadd_rn(db[3 * i], eps));
        const float r1 = __fdiv_rn(1.f, __fadd_rn(db[3 * i + 1], eps));
        const float r2 = __fdiv_rn(1.f, __fadd_rn(db[3 * i + 2], eps));
        const float sum = __fadd_rn(__fadd_rn(r0, r1), r2);
        const float rk = k == 0 ? r0 : (k == 1 ? r1 : r2);
        const int slot = count + __popc(mask & lt);
        s_i[warp][slot] = i;
        s_w[warp][slot] = __fdiv_rn(rk, sum);
      }
      count += __popc(mask);
    }
  }
  // Always: a row nothing points at is written as zeros here.
  flush<kVec>(gb, orow, s_i[warp], s_w[warp], count, c, first, lane);
}

}  // namespace

extern "C" int three_interp_bwd_launch(const float* g_out, const int* idx,
                                       const float* dist, int b, int n, int m,
                                       int c, float eps, float* g_feat,
                                       cudaStream_t stream) {
  const dim3 grid((m + kWarps - 1) / kWarps, b), block(kThreads);
  const bool vec = (c % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(g_out) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(g_feat) % 16 == 0);
  if (vec) {
    three_interp_bwd_kernel<true><<<grid, block, 0, stream>>>(
        g_out, idx, dist, n, m, c, eps, g_feat);
  } else {
    three_interp_bwd_kernel<false><<<grid, block, 0, stream>>>(
        g_out, idx, dist, n, m, c, eps, g_feat);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
