// K3: exact 3-NN + inverse-distance-weighted blend (forward).
//
// Replaces pvn3d_tpu/ops/pallas/interp.py::three_interpolate_fused
// (_fused_fwd / _interp_kernel).  Semantics: for each unknown point, the 3
// known points smallest in lexicographic (d^2, index) order (the reference
// running top-3 of interpolate_gpu.cu:24-38: equal distances keep the lower
// index first); weights 1/(d + eps) normalised over the three; the blend of
// the known features.  With m < 3 the empty slots get index 0 and
// d^2 = 1e30 (the reference's initialised slots), so their weight is ~0.
// Returns out (B, n, C), dist (B, n, 3) and idx (B, n, 3).
//
// The expanded instance (kExpanded) is the XLA arm of the JAX package's
// interp_mode "exact" / "approx" (pvn3d_tpu/ops/interpolate.py:22-70:
// three_nn, then idw_weights and three_interpolate): d^2 in the expanded
// form (|u|^2 - 2 u.k) + |k|^2, the same (d^2, index) order (top_k puts
// the lower index first on ties; approx_min_k off a TPU is exact), and
// dist = sqrt(max(d^2, 0)), since the expanded d^2 can be negative.  The
// blend, and the backward kernel, are the same for both forms.
//
// Bound: bytes.  The n*C float32 output (fp0: 12.6 MB) and the n*m
// direct-form distance tests (fp0: 12288 x 2048 = 25M, ~9 flops each) are
// both a few microseconds of the card; what held the first kernel back was
// grid fill (one thread per unknown row: 4 blocks at fp3, 96 at fp0) and a
// blend written one float at a time with a division per element.
//
// Design: a warp per unknown row (R = 1, 2 or 4 rows per warp, chosen by
// the wrapper so that a level at batch 1 launches at least 132 blocks).
// - Search: lane l scans the known points j = l, l+32, ... in index order
//   (__ldg: a batch row's points are at most 24 KB and stay in L1 for all
//   the warps of an SM) and keeps a running top-3 per row with strict '<',
//   which is lexicographic within its subset.  The 32 lists are merged by a
//   __shfl_xor_sync butterfly; each step merges two sorted 3-lists under
//   the (d^2, index) order.  That order is total and the subsets disjoint,
//   so the merge is exact whatever the split, and every lane ends with the
//   row's top-3.  An empty slot carries (1e30, INT_MAX) through the merge
//   and becomes index 0 only at the end, so a lane with fewer than three
//   points never displaces a real neighbour.
// - Blend: the same warp, lanes along the channels, float4 loads of the
//   three feature rows (L2-resident: at most 2.1 MB) and float4 stores,
//   (w0*f0 + w1*f1) + w2*f2; a scalar instance when C % 4 != 0 or a pointer
//   is not 16-byte aligned.  The TPU kernel's blend was a bf16 MXU matmul;
//   this one is float32.
//
// d^2 is ((dx*dx)+(dy*dy))+(dz*dz), or in the expanded instance each norm
// and u.k as ((x*x)+(y*y))+(z*z) and then (|u|^2 - 2 u.k) + |k|^2, with
// round-to-nearest intrinsics: no FMA contraction, so neighbour order
// equals the plain version's.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;
constexpr float kEmpty = 1e30f;
constexpr int kNone = INT_MAX;
constexpr unsigned kFull = 0xffffffffu;

struct Top3 {
  float d0, d1, d2;
  int i0, i1, i2;
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

// Running top-3 over a lane's subset, scanned in index order: strict '<'
// keeps an equal distance behind the lower index already held.
__device__ __forceinline__ void insert(Top3& t, float d, int j) {
  if (d < t.d2) {
    if (d < t.d1) {
      t.d2 = t.d1; t.i2 = t.i1;
      if (d < t.d0) {
        t.d1 = t.d0; t.i1 = t.i0;
        t.d0 = d; t.i0 = j;
      } else {
        t.d1 = d; t.i1 = j;
      }
    } else {
      t.d2 = d; t.i2 = j;
    }
  }
}

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// a <- the first three of the sorted lists a and b under (d^2, index).
__device__ __forceinline__ void merge(Top3& a, Top3 b) {
  Top3 c;
  if (before(b.d0, b.i0, a.d0, a.i0)) {
    c.d0 = b.d0; c.i0 = b.i0;
    b.d0 = b.d1; b.i0 = b.i1; b.d1 = b.d2; b.i1 = b.i2;
  } else {
    c.d0 = a.d0; c.i0 = a.i0;
    a.d0 = a.d1; a.i0 = a.i1; a.d1 = a.d2; a.i1 = a.i2;
  }
  if (before(b.d0, b.i0, a.d0, a.i0)) {
    c.d1 = b.d0; c.i1 = b.i0;
    b.d0 = b.d1; b.i0 = b.i1;
  } else {
    c.d1 = a.d0; c.i1 = a.i0;
    a.d0 = a.d1; a.i0 = a.i1;
  }
  if (before(b.d0, b.i0, a.d0, a.i0)) {
    c.d2 = b.d0; c.i2 = b.i0;
  } else {
    c.d2 = a.d0; c.i2 = a.i0;
  }
  a = c;
}

__device__ __forceinline__ void butterfly(Top3& t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top3 o;
    o.d0 = __shfl_xor_sync(kFull, t.d0, off);
    o.d1 = __shfl_xor_sync(kFull, t.d1, off);
    o.d2 = __shfl_xor_sync(kFull, t.d2, off);
    o.i0 = __shfl_xor_sync(kFull, t.i0, off);
    o.i1 = __shfl_xor_sync(kFull, t.i1, off);
    o.i2 = __shfl_xor_sync(kFull, t.i2, off);
    merge(t, o);
  }
}

__device__ __forceinline__ float blend(float w0, float a, float w1, float b,
                                       float w2, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b)),
                   __fmul_rn(w2, c));
}

template <int R, bool kVec, bool kExpanded>
__global__ void __launch_bounds__(32 * kMaxWarps)
    three_interp_kernel(const float* __restrict__ unknown,
                        const float* __restrict__ known,
                        const float* __restrict__ feats, int n, int m, int c,
                        float eps, float* __restrict__ out,
                        float* __restrict__ dist, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int row0 = (blockIdx.x * warps + (threadIdx.x >> 5)) * R;
  if (row0 >= n) return;   // warp-uniform; the kernel has no block barrier
  const int b = blockIdx.y;
  const float* kp = known + static_cast<size_t>(b) * m * 3;

  float ux[R], uy[R], uz[R], usq[R];
  Top3 t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* u = unknown + (static_cast<size_t>(b) * n +
                                min(row0 + r, n - 1)) * 3;
    ux[r] = __ldg(u);
    uy[r] = __ldg(u + 1);
    uz[r] = __ldg(u + 2);
    usq[r] = dot3(ux[r], uy[r], uz[r], ux[r], uy[r], uz[r]);
    t[r] = Top3{kEmpty, kEmpty, kEmpty, kNone, kNone, kNone};
  }
#pragma unroll 4
  for (int j = lane; j < m; j += 32) {
    const float kx = __ldg(kp + 3 * j);
    const float ky = __ldg(kp + 3 * j + 1);
    const float kz = __ldg(kp + 3 * j + 2);
    const float ksq = dot3(kx, ky, kz, kx, ky, kz);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (kExpanded) {
        const float cross = dot3(ux[r], uy[r], uz[r], kx, ky, kz);
        insert(t[r],
               __fadd_rn(__fsub_rn(usq[r], __fmul_rn(2.f, cross)), ksq), j);
      } else {
        insert(t[r], sqdist(ux[r], uy[r], uz[r], kx, ky, kz), j);
      }
    }
  }

  const float* fb = feats + static_cast<size_t>(b) * m * c;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    butterfly(t[r]);
    const int row = row0 + r;
    if (row >= n) break;
    const size_t urow = static_cast<size_t>(b) * n + row;
    const int i0 = t[r].d0 >= kEmpty ? 0 : t[r].i0;
    const int i1 = t[r].d1 >= kEmpty ? 0 : t[r].i1;
    const int i2 = t[r].d2 >= kEmpty ? 0 : t[r].i2;
    const float d0 = sqrtf(fmaxf(t[r].d0, 0.f));
    const float d1 = sqrtf(fmaxf(t[r].d1, 0.f));
    const float d2 = sqrtf(fmaxf(t[r].d2, 0.f));
    const float r0 = __fdiv_rn(1.f, __fadd_rn(d0, eps));
    const float r1 = __fdiv_rn(1.f, __fadd_rn(d1, eps));
    const float r2 = __fdiv_rn(1.f, __fadd_rn(d2, eps));
    const float sum = __fadd_rn(__fadd_rn(r0, r1), r2);
    const float w0 = __fdiv_rn(r0, sum);
    const float w1 = __fdiv_rn(r1, sum);
    const float w2 = __fdiv_rn(r2, sum);
    if (lane < 3) {
      dist[3 * urow + lane] = lane == 0 ? d0 : (lane == 1 ? d1 : d2);
      idx[3 * urow + lane] = lane == 0 ? i0 : (lane == 1 ? i1 : i2);
    }
    if constexpr (kVec) {
      const int c4 = c >> 2;
      const float4* f0 = reinterpret_cast<const float4*>(
          fb + static_cast<size_t>(i0) * c);
      const float4* f1 = reinterpret_cast<const float4*>(
          fb + static_cast<size_t>(i1) * c);
      const float4* f2 = reinterpret_cast<const float4*>(
          fb + static_cast<size_t>(i2) * c);
      float4* o = reinterpret_cast<float4*>(out + urow * c);
      for (int q = lane; q < c4; q += 32) {
        const float4 a = __ldg(f0 + q);
        const float4 e = __ldg(f1 + q);
        const float4 g = __ldg(f2 + q);
        o[q] = make_float4(blend(w0, a.x, w1, e.x, w2, g.x),
                           blend(w0, a.y, w1, e.y, w2, g.y),
                           blend(w0, a.z, w1, e.z, w2, g.z),
                           blend(w0, a.w, w1, e.w, w2, g.w));
      }
    } else {
      const float* f0 = fb + static_cast<size_t>(i0) * c;
      const float* f1 = fb + static_cast<size_t>(i1) * c;
      const float* f2 = fb + static_cast<size_t>(i2) * c;
      float* o = out + urow * c;
      for (int ch = lane; ch < c; ch += 32) {
        o[ch] = blend(w0, __ldg(f0 + ch), w1, __ldg(f1 + ch), w2,
                      __ldg(f2 + ch));
      }
    }
  }
}

template <int R, bool kExpanded>
void launch_rows(dim3 grid, dim3 block, bool vec, cudaStream_t stream,
                 const float* unknown, const float* known, const float* feats,
                 int n, int m, int c, float eps, float* out, float* dist,
                 int* idx) {
  if (vec) {
    three_interp_kernel<R, true, kExpanded><<<grid, block, 0, stream>>>(
        unknown, known, feats, n, m, c, eps, out, dist, idx);
  } else {
    three_interp_kernel<R, false, kExpanded><<<grid, block, 0, stream>>>(
        unknown, known, feats, n, m, c, eps, out, dist, idx);
  }
}

template <bool kExpanded>
bool launch_form(int rows, dim3 grid, dim3 block, bool vec,
                 cudaStream_t stream, const float* unknown,
                 const float* known, const float* feats, int n, int m, int c,
                 float eps, float* out, float* dist, int* idx) {
  switch (rows) {
    case 1:
      launch_rows<1, kExpanded>(grid, block, vec, stream, unknown, known,
                                feats, n, m, c, eps, out, dist, idx);
      return true;
    case 2:
      launch_rows<2, kExpanded>(grid, block, vec, stream, unknown, known,
                                feats, n, m, c, eps, out, dist, idx);
      return true;
    case 4:
      launch_rows<4, kExpanded>(grid, block, vec, stream, unknown, known,
                                feats, n, m, c, eps, out, dist, idx);
      return true;
    default:
      return false;
  }
}

}  // namespace

// rows: unknown rows per warp (1, 2 or 4); warps: warps per block (1-4).
// The wrapper (ops/kernels/interp.py::forward_grid) chooses both.
// expanded: 0 for the direct d^2, 1 for the expanded form.
extern "C" int three_interp_launch(const float* unknown, const float* known,
                                   const float* feats, int b, int n, int m,
                                   int c, float eps, int rows, int warps,
                                   float* out, float* dist, int* idx,
                                   int expanded, cudaStream_t stream) {
  if (warps < 1 || warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_groups = (n + rows - 1) / rows;
  const dim3 grid((row_groups + warps - 1) / warps, b), block(32 * warps);
  const bool vec = (c % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(feats) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const bool ok =
      expanded ? launch_form<true>(rows, grid, block, vec, stream, unknown,
                                   known, feats, n, m, c, eps, out, dist, idx)
               : launch_form<false>(rows, grid, block, vec, stream, unknown,
                                    known, feats, n, m, c, eps, out, dist,
                                    idx);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
