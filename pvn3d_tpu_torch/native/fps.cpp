// Offline farthest point sampling on the host CPU.
//
// The port's copy of the JAX package's native/fps.cpp.  Native equivalent
// of the reference's cffi extension
// (pvn3d/lib/utils/dataset_tools/fps/src/farthest_point_sampling.cpp):
// O(K*N) FPS over mesh vertices with an OpenMP-parallel distance update
// and max-reduction.  Used by the new-dataset tooling
// (pvn3d_tpu_torch/tools/gen_obj_info.py) to pick keypoints; the network's
// FPS on the card is kernel K1 (pvn3d_tpu_torch/csrc/fps.cu).  Its plain
// version is pvn3d_tpu_torch/native/__init__.py::_fps.
//
// Differences from the reference: the start index is an explicit argument
// (the reference seeds with srand(time(0)) — non-reproducible); the
// bbox-center-seeded variant is otherwise semantically identical.

#include <cfloat>
#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline float sqdist(const float* a, const float* b) {
  const float dx = a[0] - b[0];
  const float dy = a[1] - b[1];
  const float dz = a[2] - b[2];
  return dx * dx + dy * dy + dz * dz;
}

void run_fps(const float* pts, int32_t pn, int32_t sn, int32_t cur,
             float* min_dist, int32_t* out_idx) {
  for (int32_t s = 0; s < sn; ++s) {
    out_idx[s] = cur;
    min_dist[cur] = -1.0f;  // selected points never win again
    if (s == sn - 1) break;
    const float* p = pts + 3 * cur;
    int32_t best = 0;
    float best_d = -1.0f;
#pragma omp parallel
    {
      int32_t lbest = 0;
      float lbest_d = -1.0f;
#pragma omp for nowait
      for (int32_t i = 0; i < pn; ++i) {
        if (min_dist[i] < 0.0f) continue;  // already selected
        const float d = sqdist(pts + 3 * i, p);
        if (d < min_dist[i]) min_dist[i] = d;
        if (min_dist[i] > lbest_d) {
          lbest_d = min_dist[i];
          lbest = i;
        }
      }
#pragma omp critical
      {
        if (lbest_d > best_d) {
          best_d = lbest_d;
          best = lbest;
        }
      }
    }
    cur = best;
  }
}

}  // namespace

extern "C" {

// FPS from an explicit start index.  out_idx must hold sn ints.
void pvn3d_fps(const float* pts, int32_t pn, int32_t sn, int32_t start_idx,
               int32_t* out_idx) {
  float* min_dist = new float[pn];
  for (int32_t i = 0; i < pn; ++i) min_dist[i] = FLT_MAX;
  run_fps(pts, pn, sn, start_idx % pn, min_dist, out_idx);
  delete[] min_dist;
}

// FPS seeded by distance from the bbox center (reference:
// sample_farthest_points_init_center).
void pvn3d_fps_center(const float* pts, int32_t pn, int32_t sn,
                      int32_t* out_idx) {
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  for (int32_t i = 0; i < pn; ++i) {
    for (int c = 0; c < 3; ++c) {
      const float v = pts[3 * i + c];
      if (v < lo[c]) lo[c] = v;
      if (v > hi[c]) hi[c] = v;
    }
  }
  const float ctr[3] = {(lo[0] + hi[0]) * 0.5f, (lo[1] + hi[1]) * 0.5f,
                        (lo[2] + hi[2]) * 0.5f};
  float* min_dist = new float[pn];
  int32_t cur = 0;
  float best = -1.0f;
  for (int32_t i = 0; i < pn; ++i) {
    min_dist[i] = sqdist(pts + 3 * i, ctr);
    if (min_dist[i] > best) {
      best = min_dist[i];
      cur = i;
    }
  }
  run_fps(pts, pn, sn, cur, min_dist, out_idx);
  delete[] min_dist;
}

}  // extern "C"
