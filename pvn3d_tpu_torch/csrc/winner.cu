// K4: MeanShift winner statistics, one thread block per hypothesis.
//
// Replaces pvn3d_tpu/ops/pallas/winner.py::winner_stats_fused
// (_winner_kernel).  Semantics (meanshift_pytorch.py:45-51 of the
// reference): for hypothesis h with points a (K, 3) and validity mask,
// count for every valid seed i the valid points j with
// |a_i - a_j|^2 < bw^2 at their ORIGINAL positions; the winner is the first
// argmax of those counts (an invalid seed counts 0); return the winner, its
// membership row (valid j within bw of the winner) and its count.
//
// Bound: operations.  H * K^2 pair tests (the keypoint pass: 168 x 512^2 =
// 44M, ~10 flops each) against (H, K) bytes in and out.  The TPU kernel
// held the whole (K, K) tile in VMEM; here nothing K x K is held: a block's
// threads each own seeds and scan the hypothesis's points from shared
// memory tiles of kTile points, so any K works (the all-points arm runs
// K = 12288).  A warp-shuffle argmax (first index on ties) picks the
// winner, and one more pass writes its membership row.
//
// d^2 is ((dx*dx)+(dy*dy))+(dz*dz) with round-to-nearest intrinsics: no FMA
// contraction, so bandwidth membership equals the plain version's.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (c, i) <- the better of (c, i) and (c2, i2): larger count, lower index.
__device__ __forceinline__ void take_better(int& c, int& i, int c2, int i2) {
  if (c2 > c || (c2 == c && i2 < i)) {
    c = c2;
    i = i2;
  }
}

__global__ void __launch_bounds__(kThreads)
    winner_kernel(const float* __restrict__ pts,
                  const unsigned char* __restrict__ mask, int k, float bw2,
                  int* __restrict__ win, unsigned char* __restrict__ labels,
                  int* __restrict__ counts) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ unsigned char sm[kTile];
  __shared__ int s_cnt[kWarps], s_idx[kWarps];
  __shared__ int s_win, s_count;
  const int h = blockIdx.x;
  const float* a = pts + static_cast<size_t>(h) * k * 3;
  const unsigned char* am = mask + static_cast<size_t>(h) * k;
  const int tid = threadIdx.x;

  int best_c = -1, best_i = INT_MAX;
  for (int seed0 = 0; seed0 < k; seed0 += kThreads) {
    const int i = seed0 + tid;
    const bool seed_valid = i < k && am[i] != 0;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (i < k) {
      xi = a[3 * i];
      yi = a[3 * i + 1];
      zi = a[3 * i + 2];
    }
    int cnt = 0;
    for (int base = 0; base < k; base += kTile) {
      const int lim = min(kTile, k - base);
      __syncthreads();
      for (int t = tid; t < lim; t += kThreads) {
        sx[t] = a[3 * (base + t)];
        sy[t] = a[3 * (base + t) + 1];
        sz[t] = a[3 * (base + t) + 2];
        sm[t] = am[base + t];
      }
      __syncthreads();
      if (!seed_valid) continue;
      for (int j = 0; j < lim; ++j) {
        cnt += (sm[j] != 0 &&
                sqdist(xi, yi, zi, sx[j], sy[j], sz[j]) < bw2) ? 1 : 0;
      }
    }
    if (i < k) take_better(best_c, best_i, cnt, i);
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int c2 = __shfl_down_sync(0xffffffffu, best_c, off);
    const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
    take_better(best_c, best_i, c2, i2);
  }
  if (lane == 0) {
    s_cnt[warp] = best_c;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best_c = lane < kWarps ? s_cnt[lane] : -1;
    best_i = lane < kWarps ? s_idx[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int c2 = __shfl_down_sync(0xffffffffu, best_c, off);
      const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
      take_better(best_c, best_i, c2, i2);
    }
    if (lane == 0) {
      s_win = best_i == INT_MAX ? 0 : best_i;
      s_count = best_c < 0 ? 0 : best_c;
    }
  }
  __syncthreads();

  const int w = s_win;
  const bool w_valid = w < k && am[w] != 0;
  float wx = 0.f, wy = 0.f, wz = 0.f;
  if (w < k) {
    wx = a[3 * w];
    wy = a[3 * w + 1];
    wz = a[3 * w + 2];
  }
  unsigned char* row = labels + static_cast<size_t>(h) * k;
  for (int j = tid; j < k; j += kThreads) {
    row[j] = (w_valid && am[j] != 0 &&
              sqdist(wx, wy, wz, a[3 * j], a[3 * j + 1], a[3 * j + 2]) < bw2)
                 ? 1
                 : 0;
  }
  if (tid == 0) {
    win[h] = w;
    counts[h] = s_count;
  }
}

}  // namespace

// pts (h, k, 3) float32, mask (h, k) bool bytes; win (h,) int32,
// labels (h, k) bool bytes, counts (h,) int32.
extern "C" int winner_launch(const float* pts, const unsigned char* mask,
                             int h, int k, float bw2, int* win,
                             unsigned char* labels, int* counts,
                             cudaStream_t stream) {
  winner_kernel<<<h, kThreads, 0, stream>>>(pts, mask, k, bw2, win, labels,
                                            counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
