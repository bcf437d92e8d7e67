// Train-mode BatchNorm: float32 batch statistics, the normalisation with an
// optional ReLU, and its backward.
//
// Replaces no TPU kernel: the JAX package's BatchNorm
// (pvn3d_tpu/models/layers.py:29-69) is plain jnp that XLA fuses.  In
// PyTorch the same tensor code is ~30 launches a call, most of them full
// float32 passes, and autograd's differentiation of it as many again.
// What it computes (models/layers.py::BatchNorm, unchanged):
//   mean = E[x], meansq = E[x^2] in float32 over every axis but the channel
//   var  = max(meansq - mean^2, 0),  inv = 1 / sqrt(var + eps)
//   y    = (x - mean) * (inv * weight) + bias in float32, rounded once to
//          x's type, then ReLU where the caller fuses it
// and the backward of that chain: with g = dy (masked by the ReLU where
// fused, the mask recomputed from x), xh = (x - mean) * inv,
//   dbias = sum g,  dweight = sum g * xh,
//   dx = inv * weight * ((g - sum g / n) - xh * (sum g xh / n))
// where the variance term is dropped for a channel whose variance was
// clamped (the clamp's gradient).
//
// Bound: bytes, far below the ridge.  The forward reads x twice and writes
// y (6 bytes an element in bf16), the backward reads x and dy twice and
// writes dx (10).  Design: a pass is a grid of ~8 blocks of 256 threads per
// SM over one of two layouts, with 16-byte loads and stores (8 bf16 or 4
// float32 values; scalar when the channel or plane length or a pointer is
// not aligned) and float32 accumulation:
//   rows  (R, C) contiguous (channels last: SA, FP, the heads, and an NCHW
//         map in channels_last memory): a thread owns a fixed group of
//         channels and strides over rows; threads of a block cover
//         consecutive rows, so a block reads one contiguous run.
//   nchw  (N, C, HW) contiguous: a block per (slice, channel) strides over
//         the channel's N planes.
// Each statistics or gradient-sum block writes per-channel partials (two
// float32 per channel) to scratch; bn_finish sums them in a fixed order, so
// no float atomics and every result is the same run to run (rematerialised
// forwards recompute it exactly).  bn_finish then derives mean, inv,
// scale = inv * weight and the variance flag, and moves the running
// statistics; for synced BN it stops at (mean, meansq) for the all-reduce
// and a second bn_finish launch takes them up.  The normalise pass and the
// two backward passes reuse the statistics pass's grid, so a thread loads
// its channels' parameters once.  Launches: 3 a forward, 3 a backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // loads a thread keeps in flight
constexpr int kMaxVec = 8;
constexpr int kLayoutRows = 0;
constexpr int kLayoutNchw = 1;
constexpr int kFinishChannels = 32;
constexpr int kFinishLanes = 32;

template <typename T, int V>
struct Vec;

// A vector's load kept packed (``Raw``) until it is used, so a thread
// holds kUnroll loads of two tensors in few registers.
template <>
struct Vec<float, 4> {
  using Raw = float4;
  __device__ static Raw raw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void unpack(const Raw& v, float (&f)[4]) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  __device__ static Raw raw(const float* p) { return *p; }
  __device__ static void unpack(const Raw& v, float (&f)[1]) { f[0] = v; }
  __device__ static void store(float* p, const float (&f)[1]) { *p = f[0]; }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static void unpack(const Raw& v, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static Raw raw(const __nv_bfloat16* p) { return *p; }
  __device__ static void unpack(const Raw& v, float (&f)[1]) {
    f[0] = __bfloat162float(v);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[1]) {
    *p = __float2bfloat16_rn(f[0]);
  }
};

// v rounded to T and back: the value the forward stores.
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The normalised value before rounding: (x - mean) * scale + bias, each
// operation rounded as the plain version's separate tensor operations are.
__device__ __forceinline__ float normalised(float x, float mean, float scale,
                                            float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), bias);
}

// One layout's walk over the elements a thread visits, kUnroll vector loads
// at a time.  Rows: a fixed channel group, rows tr, tr + step, ...  NCHW:
// vector indices over the block's channel's N planes.
struct Walk {
  int layout;
  long long outer;  // rows R (rows) or N (nchw)
  int c;
  long long inner;  // 1 (rows) or HW (nchw)
  int tcols;        // channel groups a block covers (rows)
  int rl;           // rows a block covers at a time (rows)
};

// Per-thread position: the channel group (rows) or channel (nchw), the
// first index and the stride.  Returns false for a thread with no channels.
template <int V>
__device__ __forceinline__ bool place(const Walk& w, int& cg, long long& i0,
                                      long long& step, long long& count) {
  if (w.layout == kLayoutRows) {
    const int tc = threadIdx.x % w.tcols;
    const int tr = threadIdx.x / w.tcols;
    cg = blockIdx.y * w.tcols + tc;
    if (tr >= w.rl || cg * V >= w.c) return false;
    i0 = static_cast<long long>(blockIdx.x) * w.rl + tr;
    step = static_cast<long long>(gridDim.x) * w.rl;
    count = w.outer;
    return true;
  }
  cg = blockIdx.y;
  i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  step = static_cast<long long>(gridDim.x) * blockDim.x;
  count = w.outer * (w.inner / V);
  return true;
}

// Element offset of a thread's i-th vector.
template <int V>
__device__ __forceinline__ long long offset(const Walk& w, int cg,
                                            long long i) {
  if (w.layout == kLayoutRows) {
    return i * w.c + static_cast<long long>(cg) * V;
  }
  // 32-bit division: the wrapper keeps a channel's vectors under 2^31.
  const unsigned hv = static_cast<unsigned>(w.inner / V);
  const unsigned n = static_cast<unsigned>(i) / hv;
  return (static_cast<long long>(n) * w.c + cg) * w.inner +
         static_cast<long long>(static_cast<unsigned>(i) - n * hv) * V;
}

// Channel of value k of a thread's vector.
template <int V>
__device__ __forceinline__ int channel(const Walk& w, int cg, int k) {
  return w.layout == kLayoutRows ? cg * V + k : cg;
}

// Sums a[0..V), b[0..V) over the block's threads that share channels and
// writes them to part[blockIdx.x][0|1][channel].  Rows: a fixed-order tree
// over the row lanes.  NCHW: a thread's V values are one channel's; they
// are summed, then a fixed-order tree over the block.
template <int V>
__device__ void write_partials(const Walk& w, bool live, int cg,
                               float (&a)[V], float (&b)[V],
                               float* __restrict__ part) {
  __shared__ float sa[kThreads * kMaxVec];
  __shared__ float sb[kThreads * kMaxVec];
  const int t = threadIdx.x;
  float* out_a = part + (2 * static_cast<long long>(blockIdx.x)) * w.c;
  float* out_b = out_a + w.c;
  if (w.layout == kLayoutRows) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sa[t * V + k] = live ? a[k] : 0.f;
      sb[t * V + k] = live ? b[k] : 0.f;
    }
    __syncthreads();
    const int tr = t / w.tcols;
    for (int st = 1; st < w.rl; st *= 2) {
      if (tr % (2 * st) == 0 && tr + st < w.rl) {
        const int o = (t + st * w.tcols) * V;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          sa[t * V + k] += sa[o + k];
          sb[t * V + k] += sb[o + k];
        }
      }
      __syncthreads();
    }
    if (live && tr == 0) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        out_a[cg * V + k] = sa[t * V + k];
        out_b[cg * V + k] = sb[t * V + k];
      }
    }
    return;
  }
  float x = 0.f, y = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    x += a[k];
    y += b[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
    y += __shfl_xor_sync(0xffffffffu, y, o);
  }
  if ((t & 31) == 0) {
    sa[t >> 5] = x;
    sb[t >> 5] = y;
  }
  __syncthreads();
  if (t == 0) {
    float u = 0.f, v = 0.f;
    for (int k = 0; k < (blockDim.x >> 5); ++k) {
      u += sa[k];
      v += sb[k];
    }
    out_a[cg] = u;
    out_b[cg] = v;
  }
}

// Forward statistics: per-block partial sums of x and x^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, Walk w,
                    float* __restrict__ part) {
  int cg;
  long long i0, step, count;
  const bool live = place<V>(w, cg, i0, step, count);
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (live) {
    for (long long i = i0; i < count; i += kUnroll * step) {
      typename Vec<T, V>::Raw rx[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + u * step;
        if (j < count) rx[u] = Vec<T, V>::raw(x + offset<V>(w, cg, j));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * step >= count) continue;
        float f[V];
        Vec<T, V>::unpack(rx[u], f);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k] += f[k];
          q[k] = fmaf(f[k], f[k], q[k]);
        }
      }
    }
  }
  write_partials<V>(w, live, cg, s, q, part);
}

// Loads the per-channel values a thread needs: stats rows 0..3 are mean,
// inv, scale, the variance flag.
template <int V>
__device__ __forceinline__ void channel_params(const Walk& w, int cg,
                                               const float* __restrict__ st,
                                               const float* __restrict__ bias,
                                               float (&mu)[V], float (&inv)[V],
                                               float (&sc)[V], float (&b)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = channel<V>(w, cg, k);
    mu[k] = st[c];
    inv[k] = st[w.c + c];
    sc[k] = st[2 * w.c + c];
    b[k] = bias[c];
  }
}

// Forward normalisation, optional ReLU.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, Walk w,
                    const float* __restrict__ st,
                    const float* __restrict__ bias, int relu,
                    T* __restrict__ y) {
  int cg;
  long long i0, step, count;
  if (!place<V>(w, cg, i0, step, count)) return;
  float mu[V], inv[V], sc[V], b[V];
  channel_params<V>(w, cg, st, bias, mu, inv, sc, b);
  for (long long i = i0; i < count; i += kUnroll * step) {
    typename Vec<T, V>::Raw rx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * step;
      if (j < count) rx[u] = Vec<T, V>::raw(x + offset<V>(w, cg, j));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * step;
      if (j >= count) continue;
      float f[V];
      Vec<T, V>::unpack(rx[u], f);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = rounded<T>(normalised(f[k], mu[k], sc[k], b[k]));
        f[k] = (relu && v <= 0.f) ? 0.f : v;
      }
      Vec<T, V>::store(y + offset<V>(w, cg, j), f);
    }
  }
}

// The cotangent an element passes on: dy, zero where the fused ReLU's
// output was at most 0 (torch's threshold_backward).
template <typename T>
__device__ __forceinline__ float masked(float g, float xm, float sc, float b,
                                        int relu) {
  if (!relu) return g;
  return rounded<T>(__fadd_rn(__fmul_rn(xm, sc), b)) <= 0.f ? 0.f : g;
}

// Backward pass 1: per-block partial sums of g and g * xh.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         Walk w, const float* __restrict__ st,
                         const float* __restrict__ bias, int relu,
                         float* __restrict__ part) {
  int cg;
  long long i0, step, count;
  const bool live = place<V>(w, cg, i0, step, count);
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (live) {
    float mu[V], inv[V], sc[V], b[V];
    channel_params<V>(w, cg, st, bias, mu, inv, sc, b);
    for (long long i = i0; i < count; i += kUnroll * step) {
      typename Vec<T, V>::Raw rx[kUnroll], rg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = i + u * step;
        if (j < count) {
          const long long o = offset<V>(w, cg, j);
          rx[u] = Vec<T, V>::raw(x + o);
          rg[u] = Vec<T, V>::raw(dy + o);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * step >= count) continue;
        float fx[V], fg[V];
        Vec<T, V>::unpack(rx[u], fx);
        Vec<T, V>::unpack(rg[u], fg);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xm = __fsub_rn(fx[k], mu[k]);
          const float g = masked<T>(fg[k], xm, sc[k], b[k], relu);
          s[k] += g;
          q[k] = fmaf(g, __fmul_rn(xm, inv[k]), q[k]);
        }
      }
    }
  }
  write_partials<V>(w, live, cg, s, q, part);
}

// Backward pass 2: dx from the channel sums (global under synced BN).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        Walk w, const float* __restrict__ st,
                        const float* __restrict__ bias, int relu,
                        const float* __restrict__ sums, float n,
                        T* __restrict__ dx) {
  int cg;
  long long i0, step, count;
  if (!place<V>(w, cg, i0, step, count)) return;
  float mu[V], inv[V], sc[V], b[V], ga[V], gb[V];
  channel_params<V>(w, cg, st, bias, mu, inv, sc, b);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = channel<V>(w, cg, k);
    ga[k] = __fdiv_rn(sums[c], n);
    gb[k] = __fmul_rn(__fdiv_rn(sums[w.c + c], n), st[3 * w.c + c]);
  }
  for (long long i = i0; i < count; i += kUnroll * step) {
    typename Vec<T, V>::Raw rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * step;
      if (j < count) {
        const long long o = offset<V>(w, cg, j);
        rx[u] = Vec<T, V>::raw(x + o);
        rg[u] = Vec<T, V>::raw(dy + o);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * step;
      if (j >= count) continue;
      float fx[V], fg[V];
      Vec<T, V>::unpack(rx[u], fx);
      Vec<T, V>::unpack(rg[u], fg);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xm = __fsub_rn(fx[k], mu[k]);
        const float g = masked<T>(fg[k], xm, sc[k], b[k], relu);
        const float xh = __fmul_rn(xm, inv[k]);
        fx[k] = __fmul_rn(
            sc[k], __fsub_rn(__fsub_rn(g, ga[k]), __fmul_rn(xh, gb[k])));
      }
      Vec<T, V>::store(dx + offset<V>(w, cg, j), fx);
    }
  }
}

// Sums P blocks' partials per channel in a fixed order (lane l takes
// partials l, l + 32, ..., then a tree over the lanes), divides by
// `divisor` and scales by `weight` into moments (2, C); with `params`, takes
// mean and meansq from there (or, when part is null, from moments as
// given) to the statistics (4, C) and moves the running statistics.
__global__ void __launch_bounds__(kFinishChannels* kFinishLanes)
    bn_finish_kernel(const float* __restrict__ part, int p, int c,
                     float divisor, float weight_factor,
                     float* __restrict__ moments, int params,
                     const float* __restrict__ weight, float eps,
                     float* __restrict__ running_mean,
                     float* __restrict__ running_var, float keep,
                     float momentum, float unbias, int update,
                     float* __restrict__ st) {
  __shared__ float sa[kFinishLanes][kFinishChannels + 1];
  __shared__ float sb[kFinishLanes][kFinishChannels + 1];
  const int tc = threadIdx.x;
  const int lane = threadIdx.y;
  const int ch = blockIdx.x * kFinishChannels + tc;
  if (part != nullptr) {
    float a = 0.f, b = 0.f;
    if (ch < c) {
      for (int k = lane; k < p; k += kFinishLanes) {
        a += part[(2 * static_cast<long long>(k)) * c + ch];
        b += part[(2 * static_cast<long long>(k) + 1) * c + ch];
      }
    }
    sa[lane][tc] = a;
    sb[lane][tc] = b;
    __syncthreads();
    for (int s = kFinishLanes / 2; s > 0; s >>= 1) {
      if (lane < s) {
        sa[lane][tc] += sa[lane + s][tc];
        sb[lane][tc] += sb[lane + s][tc];
      }
      __syncthreads();
    }
    if (lane == 0 && ch < c) {
      float m0 = __fdiv_rn(sa[0][tc], divisor);
      float m1 = __fdiv_rn(sb[0][tc], divisor);
      if (weight_factor != 1.f) {
        m0 = __fmul_rn(m0, weight_factor);
        m1 = __fmul_rn(m1, weight_factor);
      }
      moments[ch] = m0;
      moments[c + ch] = m1;
    }
  }
  if (!params || lane != 0 || ch >= c) return;
  const float mean = moments[ch];
  const float meansq = moments[c + ch];
  const float raw = __fsub_rn(meansq, __fmul_rn(mean, mean));
  const float var = raw < 0.f ? 0.f : raw;
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  st[ch] = mean;
  st[c + ch] = inv;
  st[2 * c + ch] = __fmul_rn(inv, weight[ch]);
  st[3 * c + ch] = raw >= 0.f ? 1.f : 0.f;
  if (update) {
    running_mean[ch] = __fadd_rn(__fmul_rn(running_mean[ch], keep),
                                 __fmul_rn(momentum, mean));
    running_var[ch] = __fadd_rn(__fmul_rn(running_var[ch], keep),
                                __fmul_rn(momentum, __fmul_rn(var, unbias)));
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int check(const Walk& w, int vec, int dtype, int grid_x, int grid_y,
          int threads) {
  const int want = dtype == 0 ? 4 : 8;
  const bool ok =
      (dtype == 0 || dtype == 1) && (vec == 1 || vec == want) &&
      (w.layout == kLayoutRows || w.layout == kLayoutNchw) && w.c >= 1 &&
      grid_x >= 1 && grid_y >= 1 && threads >= 32 && threads <= kThreads &&
      (w.layout == kLayoutRows
           ? (w.c % vec == 0 && w.tcols * w.rl == threads)
           : (w.inner % vec == 0 && threads == kThreads && grid_y == w.c &&
              w.outer * (w.inner / vec) < (1LL << 31)));
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

Walk make_walk(int layout, long long outer, int c, long long inner, int tcols,
               int rl) {
  Walk w;
  w.layout = layout;
  w.outer = outer;
  w.c = c;
  w.inner = inner;
  w.tcols = tcols;
  w.rl = rl;
  return w;
}

}  // namespace

// Every entry point takes the layout (0 rows, 1 nchw), the dtype (0 float32,
// 1 bfloat16), the vector width (1, or 16 bytes of the dtype), the grid the
// wrapper chose (grid_y channel groups for rows, C for nchw), and returns
// cudaGetLastError() after its launch.
#define BN_DISPATCH(dtype, vec, KERNEL, ARGS)                                 \
  do {                                                                        \
    if (dtype == 0 && vec == 4) {                                             \
      using T = float;                                                        \
      KERNEL<float, 4><<<grid, threads, 0, stream>>> ARGS;                    \
    } else if (dtype == 0) {                                                  \
      using T = float;                                                        \
      KERNEL<float, 1><<<grid, threads, 0, stream>>> ARGS;                    \
    } else if (vec == 8) {                                                    \
      using T = __nv_bfloat16;                                                \
      KERNEL<__nv_bfloat16, 8><<<grid, threads, 0, stream>>> ARGS;            \
    } else {                                                                  \
      using T = __nv_bfloat16;                                                \
      KERNEL<__nv_bfloat16, 1><<<grid, threads, 0, stream>>> ARGS;            \
    }                                                                         \
  } while (0)

extern "C" int bn_stats_launch(const void* x, int dtype, int layout,
                               long long outer, int c, long long inner,
                               int vec, int tcols, int rl, int grid_x,
                               int grid_y, int threads, float* part,
                               cudaStream_t stream) {
  const Walk w = make_walk(layout, outer, c, inner, tcols, rl);
  if (int e = check(w, vec, dtype, grid_x, grid_y, threads)) return e;
  if (vec > 1 && !aligned(x)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, grid_y);
  BN_DISPATCH(dtype, vec, bn_stats_kernel,
              (static_cast<const T*>(x), w, part));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_apply_launch(const void* x, int dtype, int layout,
                               long long outer, int c, long long inner,
                               int vec, int tcols, int rl, int grid_x,
                               int grid_y, int threads, const float* st,
                               const float* bias, int relu, void* y,
                               cudaStream_t stream) {
  const Walk w = make_walk(layout, outer, c, inner, tcols, rl);
  if (int e = check(w, vec, dtype, grid_x, grid_y, threads)) return e;
  if (vec > 1 && !(aligned(x) && aligned(y))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, grid_y);
  BN_DISPATCH(dtype, vec, bn_apply_kernel,
              (static_cast<const T*>(x), w, st, bias, relu,
               static_cast<T*>(y)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_bwd_reduce_launch(const void* x, const void* dy, int dtype,
                                    int layout, long long outer, int c,
                                    long long inner, int vec, int tcols,
                                    int rl, int grid_x, int grid_y,
                                    int threads, const float* st,
                                    const float* bias, int relu, float* part,
                                    cudaStream_t stream) {
  const Walk w = make_walk(layout, outer, c, inner, tcols, rl);
  if (int e = check(w, vec, dtype, grid_x, grid_y, threads)) return e;
  if (vec > 1 && !(aligned(x) && aligned(dy))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, grid_y);
  BN_DISPATCH(dtype, vec, bn_bwd_reduce_kernel,
              (static_cast<const T*>(x), static_cast<const T*>(dy), w, st,
               bias, relu, part));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_bwd_apply_launch(const void* x, const void* dy, int dtype,
                                   int layout, long long outer, int c,
                                   long long inner, int vec, int tcols,
                                   int rl, int grid_x, int grid_y,
                                   int threads, const float* st,
                                   const float* bias, int relu,
                                   const float* sums, float n, void* dx,
                                   cudaStream_t stream) {
  const Walk w = make_walk(layout, outer, c, inner, tcols, rl);
  if (int e = check(w, vec, dtype, grid_x, grid_y, threads)) return e;
  if (vec > 1 && !(aligned(x) && aligned(dy) && aligned(dx))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, grid_y);
  BN_DISPATCH(dtype, vec, bn_bwd_apply_kernel,
              (static_cast<const T*>(x), static_cast<const T*>(dy), w, st,
               bias, relu, sums, n, static_cast<T*>(dx)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bn_finish_launch(const float* part, int p, int c,
                                float divisor, float weight_factor,
                                float* moments, int params,
                                const float* weight, float eps,
                                float* running_mean, float* running_var,
                                float keep, float momentum, float unbias,
                                int update, float* st, cudaStream_t stream) {
  if (c < 1 || (part != nullptr && p < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 threads(kFinishChannels, kFinishLanes);
  bn_finish_kernel<<<(c + kFinishChannels - 1) / kFinishChannels, threads, 0,
                     stream>>>(part, p, c, divisor, weight_factor, moments,
                               params, weight, eps, running_mean,
                               running_var, keep, momentum, unbias, update,
                               st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
