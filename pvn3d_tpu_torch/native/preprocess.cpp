// Host-side frame preprocessing: depth completion + normals.
//
// The port's copy of the JAX package's native/preprocess.cpp (it imports
// nothing of that package; the port keeps its own copy).  C++ twins of
// ip_basic's multiscale fill, the one the reference runs per YCB frame
// (pvn3d/lib/utils/ip_basic/ip_basic/depth_map_utils_ycb.py:290-445), and
// of the numpy normals_from_depth_map; their plain versions are
// pvn3d_tpu_torch/data/depth_completion.py (impl="torch") and
// pvn3d_tpu_torch/data/normals.py (impl="numpy"), and
// tests/test_torch_native.py holds both twins against them and against
// the JAX package's cv2 / numpy arms.
//
// Morphology matches cv2 defaults: dilate = max / erode = min over the
// in-bounds kernel support (constant border that never wins).  Median uses
// BORDER_REPLICATE like cv2::medianBlur.  The bilateral filter reproduces
// cv2::bilateralFilter's float path (circle mask r <= radius, reflect101
// border, the color weight through cv2's interpolated 4096-bin exp LUT).
//
// Everything is malloc-once, OpenMP over rows.  Loader workers are separate
// processes, so the thread count defaults to 1 unless PVN3D_NATIVE_THREADS
// says otherwise.
#include <chrono>
#include <cmath>
#if defined(__AVX2__)
#include <immintrin.h>
#endif
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr float kValidEps = 0.01f;

// ---------------------------------------------------------------------------
// Stencil primitives
// ---------------------------------------------------------------------------

// Horizontal running max/min of half-width r into dst, one row at a time:
// guard-padded source row, then a fixed-trip-count window op over shifted
// reads — contiguous and branch-free so the compiler vectorizes it.
template <bool kMax>
inline void row_window(const float* row, float* out, float* pad, int w,
                       int r) {
  const float guard = kMax ? -1e30f : 1e30f;
  for (int j = 0; j < r; ++j) pad[j] = guard;
  std::memcpy(pad + r, row, w * sizeof(float));
  for (int j = 0; j < r; ++j) pad[r + w + j] = guard;
  std::memcpy(out, pad, w * sizeof(float));
  for (int d = 1; d <= 2 * r; ++d) {
    const float* __restrict p = pad + d;
    for (int j = 0; j < w; ++j)
      out[j] = kMax ? std::max(out[j], p[j]) : std::min(out[j], p[j]);
  }
}

// Vertical max/min of half-width r: element-wise combine of the valid
// neighbor rows (vectorizable row-length ops).
template <bool kMax>
inline void col_window(const float* src, float* dst, int h, int w, int r) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < h; ++i) {
    const int lo = std::max(i - r, 0), hi = std::min(i + r, h - 1);
    float* out = dst + i * w;
    std::memcpy(out, src + lo * w, w * sizeof(float));
    for (int ii = lo + 1; ii <= hi; ++ii) {
      const float* row = src + ii * w;
      for (int j = 0; j < w; ++j)
        out[j] = kMax ? std::max(out[j], row[j]) : std::min(out[j], row[j]);
    }
  }
}

// Dilation with a cross (plus-shaped) kernel of odd size s: max of the
// horizontal and vertical arms through the center (NOT a composed square).
void dilate_cross(const float* src, float* dst, int h, int w, int s) {
  const int r = s / 2;
  col_window<true>(src, dst, h, w, r);             // vertical arm
#pragma omp parallel
  {
    std::vector<float> pad(w + 2 * r), harm(w);
#pragma omp for schedule(static)
    for (int i = 0; i < h; ++i) {
      row_window<true>(src + i * w, harm.data(), pad.data(), w, r);
      float* out = dst + i * w;
      for (int j = 0; j < w; ++j) out[j] = std::max(out[j], harm[j]);
    }
  }
}

// Full-square max/min, separable: rows pass then columns pass.
template <bool kMax>
void square_morph(const float* src, float* dst, float* tmp, int h, int w,
                  int s) {
  const int r = s / 2;
#pragma omp parallel
  {
    std::vector<float> pad(w + 2 * r);
#pragma omp for schedule(static)
    for (int i = 0; i < h; ++i)
      row_window<kMax>(src + i * w, tmp + i * w, pad.data(), w, r);
  }
  col_window<kMax>(tmp, dst, h, w, r);
}

inline void dilate_square(const float* s, float* d, float* t, int h, int w,
                          int k) { square_morph<true>(s, d, t, h, w, k); }

// morphologyEx MORPH_CLOSE with a full kernel: dilate then erode.
void close_square(float* buf, float* tmp1, float* tmp2, int h, int w, int s) {
  square_morph<true>(buf, tmp1, tmp2, h, w, s);
  square_morph<false>(tmp1, buf, tmp2, h, w, s);
}

// 5x5 median with BORDER_REPLICATE (cv2::medianBlur semantics).
//
// Lanes-parallel selection: the 25 window taps become 25 row-length
// arrays (plus 7 +inf pads to 32) and a Batcher odd-even-merge sorting
// network runs element-wise over them — every compare-exchange is a
// vectorizable min/max over the row, no data-dependent branches.  The
// network is pruned to the comparators that can reach output wire 12
// (the median of 25; the pads sort above it), ~2/3 of the full sort.
const std::vector<std::pair<int, int>>& median25_network() {
  static const std::vector<std::pair<int, int>> pruned = [] {
    std::vector<std::pair<int, int>> all;
    const int n = 32;
    for (int p = 1; p < n; p <<= 1)
      for (int k = p; k >= 1; k >>= 1)
        for (int j = k % p; j <= n - 1 - k; j += 2 * k)
          for (int i = 0; i <= std::min(k - 1, n - j - k - 1); ++i)
            if ((i + j) / (2 * p) == (i + j + k) / (2 * p))
              all.emplace_back(i + j, i + j + k);
    // Backward reachability from output wire 12.
    std::vector<bool> live(n, false);
    live[12] = true;
    std::vector<std::pair<int, int>> kept;
    for (auto it = all.rbegin(); it != all.rend(); ++it)
      if (live[it->first] || live[it->second]) {
        live[it->first] = live[it->second] = true;
        kept.push_back(*it);
      }
    return std::vector<std::pair<int, int>>(kept.rbegin(), kept.rend());
  }();
  return pruned;
}

void median5(const float* src, float* dst, int h, int w) {
  const auto& net = median25_network();
  // j-blocked so the whole 32-wire working set stays L1-resident while
  // the ~150 network passes run over it.
  constexpr int kBlock = 64;
#pragma omp parallel
  {
    alignas(64) float buf[32][kBlock];
#pragma omp for schedule(static)
    for (int i = 0; i < h; ++i) {
      for (int j0 = 0; j0 < w; j0 += kBlock) {
        const int bw = std::min(kBlock, w - j0);
        int t = 0;
        for (int di = -2; di <= 2; ++di) {
          const int ii = std::min(std::max(i + di, 0), h - 1);
          const float* row = src + ii * w;
          for (int dj = -2; dj <= 2; ++dj, ++t) {
            float* b = buf[t];
            for (int j = 0; j < bw; ++j) {
              const int jj = std::min(std::max(j0 + j + dj, 0), w - 1);
              b[j] = row[jj];
            }
          }
        }
        for (; t < 32; ++t)
          std::fill(buf[t], buf[t] + bw, 1e30f);
        for (const auto& ce : net) {
          float* __restrict a = buf[ce.first];
          float* __restrict b = buf[ce.second];
          for (int j = 0; j < kBlock; ++j) {
            const float lo2 = std::min(a[j], b[j]);
            const float hi2 = std::max(a[j], b[j]);
            a[j] = lo2;
            b[j] = hi2;
          }
        }
        std::memcpy(dst + i * w + j0, buf[12], bw * sizeof(float));
      }
    }
  }
}

inline int reflect101(int i, int n) {
  // cv2 BORDER_REFLECT_101: ...cba|abcd|cba...
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
  }
  return i;
}

// cv2::bilateralFilter(src, d=5, sigma_color, sigma_space) float path:
// weights over the r <= radius circle, w = exp(r^2 * sc + dv^2 * cc),
// with the color term through cv2's own interpolated exp LUT
// (bilateral_filter.dispatch.cpp: kExpNumBinsPerChannel = 1 << 12 bins
// over the source value range).
void bilateral5(const float* src, float* dst, int h, int w,
                float sigma_color, float sigma_space) {
  const int radius = 2;
  const int n = h * w;
  const double cc = -0.5 / (double(sigma_color) * sigma_color);
  const double sc = -0.5 / (double(sigma_space) * sigma_space);
  float sw[25];
  int oi[25], oj[25];
  int k = 0;
  for (int di = -radius; di <= radius; ++di)
    for (int dj = -radius; dj <= radius; ++dj) {
      const double r2 = double(di) * di + double(dj) * dj;
      if (std::sqrt(r2) > radius) continue;
      sw[k] = float(std::exp(r2 * sc));
      oi[k] = di; oj[k] = dj;
      ++k;
    }
  // Color-weight LUT over |diff| in [0, maxVal - minVal].
  float lo = src[0], hi = src[0];
  for (int p = 1; p < n; ++p) {
    lo = std::min(lo, src[p]);
    hi = std::max(hi, src[p]);
  }
  const int kBins = 1 << 12;
  const float len = std::max(hi - lo, 1e-12f);
  const float scale_index = float(kBins) / len;
  std::vector<float> lut(kBins + 2);
  for (int b = 0; b < kBins + 2; ++b) {
    const double v = double(b) / scale_index;
    lut[b] = float(std::exp(v * v * cc));
  }
  const auto scalar_px = [&](int i, int j) {
    const float c = src[i * w + j];
    float sum = 0.f, wsum = 0.f;
    for (int t = 0; t < k; ++t) {
      const int ii = reflect101(i + oi[t], h);
      const int jj = reflect101(j + oj[t], w);
      const float v = src[ii * w + jj];
      const float alpha = std::fabs(v - c) * scale_index;
      const int bi = int(alpha);
      const float fr = alpha - float(bi);
      const float cw = lut[bi] + fr * (lut[bi + 1] - lut[bi]);
      const float wt = sw[t] * cw;
      sum += v * wt;
      wsum += wt;
    }
    dst[i * w + j] = sum / wsum;
  };

#pragma omp parallel for schedule(static)
  for (int i = 0; i < h; ++i) {
    const bool interior_row = i >= radius && i < h - radius;
    const int j_lo = interior_row ? radius : w;
    for (int j = 0; j < j_lo; ++j) scalar_px(i, j);
#if defined(__AVX2__) && defined(__FMA__)
    // Interior: 8 pixels at a time, LUT via vgatherdps.
    int j = j_lo;
    for (; j + 8 <= w - radius; j += 8) {
      const __m256 c = _mm256_loadu_ps(src + i * w + j);
      __m256 sum = _mm256_setzero_ps(), wsum = _mm256_setzero_ps();
      const __m256 vscale = _mm256_set1_ps(scale_index);
      const __m256 absmask = _mm256_castsi256_ps(_mm256_set1_epi32(0x7fffffff));
      for (int t = 0; t < k; ++t) {
        const __m256 v =
            _mm256_loadu_ps(src + (i + oi[t]) * w + j + oj[t]);
        const __m256 alpha = _mm256_mul_ps(
            _mm256_and_ps(_mm256_sub_ps(v, c), absmask), vscale);
        const __m256i bi = _mm256_cvttps_epi32(alpha);
        const __m256 fr = _mm256_sub_ps(alpha, _mm256_cvtepi32_ps(bi));
        const __m256 l0 = _mm256_i32gather_ps(lut.data(), bi, 4);
        const __m256 l1 = _mm256_i32gather_ps(lut.data() + 1, bi, 4);
        const __m256 cw = _mm256_fmadd_ps(fr, _mm256_sub_ps(l1, l0), l0);
        const __m256 wt = _mm256_mul_ps(_mm256_set1_ps(sw[t]), cw);
        sum = _mm256_fmadd_ps(v, wt, sum);
        wsum = _mm256_add_ps(wsum, wt);
      }
      _mm256_storeu_ps(dst + i * w + j, _mm256_div_ps(sum, wsum));
    }
    for (; j < w; ++j) scalar_px(i, j);
#else
    for (int j = j_lo; j < w; ++j) scalar_px(i, j);
#endif
  }
}

// True at/below the first valid (> eps) pixel of each column
// (depth_map_utils_ycb.py:366-372).  top_row[j] stays 0 for empty columns,
// matching np.argmax on an all-false column.
void top_valid_rows(const float* d, int h, int w, int* top_row) {
#pragma omp parallel for schedule(static)
  for (int j = 0; j < w; ++j) {
    int t = 0;
    for (int i = 0; i < h; ++i)
      if (d[i * w + j] > kValidEps) { t = i; break; }
    top_row[j] = t;
  }
}

// Stage timing when PVN3D_NATIVE_PROFILE is set (development aid).
struct StageTimer {
  const bool on = std::getenv("PVN3D_NATIVE_PROFILE") != nullptr;
  std::chrono::steady_clock::time_point t0 = std::chrono::steady_clock::now();
  void lap(const char* name) {
    if (!on) return;
    auto t1 = std::chrono::steady_clock::now();
    std::fprintf(stderr, "  [native] %-12s %6.2f ms\n", name,
                 std::chrono::duration<double, std::milli>(t1 - t0).count());
    t0 = t1;
  }
};

void set_threads() {
#ifdef _OPENMP
  const char* env = std::getenv("PVN3D_NATIVE_THREADS");
  omp_set_num_threads(env ? std::max(1, std::atoi(env)) : 1);
#endif
}

}  // namespace

extern "C" {

// ip_basic fill_in_multiscale: meters in, meters out.
// blur_mode: 0 none, 1 gaussian (unsupported here -> treated as none),
// 2 bilateral (the default path).
void pvn3d_fill_multiscale(const float* depth, int32_t h, int32_t w,
                           float max_depth, float near_bin, float med_bin,
                           int32_t extrapolate, int32_t blur_mode,
                           float* out) {
  set_threads();
  StageTimer st;
  const int n = h * w;
  std::vector<float> inv(n), masked(n), dil(n), tmp1(n), tmp2(n), blur(n);
  std::vector<int> top(w);
  std::vector<uint8_t> m(n);

  // Invert valid depths.
  for (int i = 0; i < n; ++i) {
    const float d = depth[i];
    inv[i] = d > kValidEps ? max_depth - d : d;
  }
  std::memcpy(out, inv.data(), n * sizeof(float));

  // Depth-binned cross dilations, farthest overwritten by nearest.
  struct Bin { float lo, hi; int ksize; };
  const Bin bins[3] = {{med_bin, 1e30f, 3},          // far, cross 3
                       {near_bin, med_bin, 5},       // med, cross 5
                       {kValidEps, near_bin, 7}};    // near, cross 7
  for (const Bin& b : bins) {
    for (int i = 0; i < n; ++i) {
      const float d = depth[i];
      masked[i] = (d > b.lo && d <= b.hi) ? inv[i] : 0.f;
    }
    dilate_cross(masked.data(), dil.data(), h, w, b.ksize);
    for (int i = 0; i < n; ++i)
      if (dil[i] > kValidEps) out[i] = dil[i];
  }
  st.lap("cross_dil");

  close_square(out, tmp1.data(), tmp2.data(), h, w, 5);
  st.lap("close");

  // Median de-noise of currently-valid pixels.
  median5(out, blur.data(), h, w);
  for (int i = 0; i < n; ++i)
    if (out[i] > kValidEps) out[i] = blur[i];
  st.lap("median1");

  // Fill holes below each column's first valid pixel with a 9x9 dilation.
  top_valid_rows(out, h, w, top.data());
  dilate_square(out, dil.data(), tmp1.data(), h, w, 9);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < w; ++j) {
      const int p = i * w + j;
      if (!(out[p] > kValidEps) && i >= top[j]) out[p] = dil[p];
    }

  st.lap("fill9");

  if (extrapolate) {
    // Extend each column's first valid value to the top of the image.
#pragma omp parallel for schedule(static)
    for (int j = 0; j < w; ++j) {
      int t = 0;
      for (int i = 0; i < h; ++i)
        if (out[i * w + j] > kValidEps) { t = i; break; }
      const float v = out[t * w + j];
      for (int i = 0; i < t; ++i) out[i * w + j] = v;
      top[j] = 0;
    }
  } else {
    top_valid_rows(out, h, w, top.data());
  }

  // Six rounds of masked 5x5 dilation fill.
  for (int it = 0; it < 6; ++it) {
    dilate_square(out, dil.data(), tmp1.data(), h, w, 5);
#pragma omp parallel for schedule(static)
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        const int p = i * w + j;
        if (out[p] < kValidEps && i >= top[j]) out[p] = dil[p];
      }
  }

  st.lap("fill5x6");

  // Median, then optional blur; `m` is the median-stage mask and the
  // bilateral branch deliberately reuses it (as the JAX package's cv2 arm does).
  median5(out, blur.data(), h, w);
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < w; ++j) {
      const int p = i * w + j;
      m[p] = (out[p] > kValidEps && i >= top[j]) ? 1 : 0;
      if (m[p]) out[p] = blur[p];
    }
  st.lap("median2");
  if (blur_mode == 2) {
    bilateral5(out, blur.data(), h, w, 0.5f, 2.0f);
    for (int p = 0; p < n; ++p)
      if (m[p]) out[p] = blur[p];
  }
  st.lap("bilateral");

  // Invert back.
  for (int p = 0; p < n; ++p)
    if (out[p] > kValidEps) out[p] = max_depth - out[p];
}

// normals_from_depth_map: organized-grid normals.
// k_mat is the row-major 3x3 intrinsic matrix; out is (h, w, 3) float32.
//
// Caveat (fuzz-measured): on numerically degenerate neighborhoods —
// near-exact planes where the tangent cross product sits at f32 rounding
// level — the f64-window box blur here and numpy's f32 cumsum blur land
// on different sides of the 1e-12 degeneracy threshold for a small
// fraction of pixels (~0.1%), giving a zero normal in one path and a
// rounding-chaos direction in the other.  Both are noise; real depth
// frames (sensor noise >> 1e-6) don't exhibit it.
void pvn3d_normals_from_depth(const float* depth, int32_t h, int32_t w,
                              const float* k_mat, float cam_scale,
                              int32_t smooth, float depth_jump, float* out) {
  set_threads();
  const int n = h * w;
  const float fx = k_mat[0], cx = k_mat[2], fy = k_mat[4], cy = k_mat[5];
  std::vector<float> z(n), zs(n);

  for (int i = 0; i < n; ++i) z[i] = depth[i] / cam_scale;

  if (smooth > 0) {
    // Edge-clamped separable box blur of masked z and of the valid mask,
    // then normalized.  Double accumulation — the
    // numpy cumsum runs in f32; we are at least as accurate.
    const int r = smooth;
    const float inv_k = 1.f / float(2 * r + 1);
    std::vector<float> mz(n), mw(n), tz(n), tw(n);
    for (int i = 0; i < n; ++i) {
      const bool v = z[i] > 1e-6f;
      mz[i] = v ? z[i] : 0.f;
      mw[i] = v ? 1.f : 0.f;
    }
    // Vertical pass (axis 0), edge clamp.
#pragma omp parallel for schedule(static)
    for (int i = 0; i < h; ++i) {
      for (int j = 0; j < w; ++j) {
        double sz = 0, sw = 0;
        for (int di = -r; di <= r; ++di) {
          const int ii = std::min(std::max(i + di, 0), h - 1);
          sz += mz[ii * w + j];
          sw += mw[ii * w + j];
        }
        tz[i * w + j] = float(sz) * inv_k;
        tw[i * w + j] = float(sw) * inv_k;
      }
    }
    // Horizontal pass (axis 1).
#pragma omp parallel for schedule(static)
    for (int i = 0; i < h; ++i) {
      for (int j = 0; j < w; ++j) {
        double sz = 0, sw = 0;
        for (int dj = -r; dj <= r; ++dj) {
          const int jj = std::min(std::max(j + dj, 0), w - 1);
          sz += tz[i * w + jj];
          sw += tw[i * w + jj];
        }
        const float num = float(sz) * inv_k;
        const float den = float(sw) * inv_k;
        const int p = i * w + j;
        zs[p] = den > 1e-6f ? num / std::max(den, 1e-6f) : z[p];
      }
    }
  } else {
    std::memcpy(zs.data(), z.data(), n * sizeof(float));
  }

  // Unprojected smoothed map p, central differences with np.roll's
  // wrap-around indexing (as the numpy version does — a twin, quirks included).
  std::vector<float> pxm(n), pym(n);
  const float inv_fx = 1.f / fx, inv_fy = 1.f / fy;
#pragma omp parallel for schedule(static)
  for (int i = 0; i < h; ++i)
    for (int j = 0; j < w; ++j) {
      const int p = i * w + j;
      pxm[p] = (float(j) - cx) * zs[p] * inv_fx;
      pym[p] = (float(i) - cy) * zs[p] * inv_fy;
    }

#pragma omp parallel for schedule(static)
  for (int i = 0; i < h; ++i) {
    const int im = i == 0 ? h - 1 : i - 1, ip = i == h - 1 ? 0 : i + 1;
    for (int j = 0; j < w; ++j) {
      const int jm = j == 0 ? w - 1 : j - 1, jp = j == w - 1 ? 0 : j + 1;
      const int p = i * w + j;
      // du = 0.5 * (p[., j+1] - p[., j-1]); dv likewise over rows
      // ((fwd + bwd) / 2 telescopes to the half central difference).
      const float du0 = 0.5f * (pxm[i * w + jp] - pxm[i * w + jm]);
      const float du1 = 0.5f * (pym[i * w + jp] - pym[i * w + jm]);
      const float du2 = 0.5f * (zs[i * w + jp] - zs[i * w + jm]);
      const float dv0 = 0.5f * (pxm[ip * w + j] - pxm[im * w + j]);
      const float dv1 = 0.5f * (pym[ip * w + j] - pym[im * w + j]);
      const float dv2 = 0.5f * (zs[ip * w + j] - zs[im * w + j]);
      // n = cross(dv, du)
      float nx = dv1 * du2 - dv2 * du1;
      float ny = dv2 * du0 - dv0 * du2;
      float nz = dv0 * du1 - dv1 * du0;
      const float norm = std::sqrt(nx * nx + ny * ny + nz * nz);
      if (norm > 1e-12f) {
        nx /= norm; ny /= norm; nz /= norm;
      } else {
        nx = ny = nz = 0.f;
      }
      // Orient toward the camera at the origin (n . p <= 0), p smoothed.
      const float dot = nx * pxm[p] + ny * pym[p] + nz * zs[p];
      if (dot > 0.f) { nx = -nx; ny = -ny; nz = -nz; }
      // Suppress invalid pixels and depth jumps (on the raw z map).
      const float ju = 0.5f * (z[i * w + jp] - z[i * w + jm]);
      const float jv = 0.5f * (z[ip * w + j] - z[im * w + j]);
      if (!(z[p] > 1e-6f) || std::fabs(ju) > depth_jump ||
          std::fabs(jv) > depth_jump) {
        nx = ny = nz = 0.f;
      }
      out[p * 3 + 0] = nx;
      out[p * 3 + 1] = ny;
      out[p * 3 + 2] = nz;
    }
  }
}

}  // extern "C"
