// Native host-side data-pipeline ops for monoforce_tpu_torch: an own copy
// of monoforce_tpu/native/hostops.cpp.
//
// The training data path rasterizes multi-million-point lidar clouds into
// heightmap labels and voxel-downsamples meshes/clouds on the host while the
// card runs the train step (reference equivalents: cloudproc.py:55-148).
// These are the host hot loops, implemented in C++ and bound via ctypes
// (see native/__init__.py); the numpy implementations remain as fallbacks
// and as the semantic reference.
//
// All functions use plain C ABI with caller-allocated buffers.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Max-z heightmap rasterization with the reference's semantics
// (cloudproc.py:88-148): drop NaNs, optional inner-radius filter, bounds
// filter, bucketize, scatter-max, final transpose so out[x_idx * n + y_idx].
// out_h and out_mask must hold n*n floats, n = floor(2*d_max/grid_res).
void estimate_heightmap_f32(const float* pts, int64_t n_pts, float grid_res,
                            float d_max, float h_max, float r_min,
                            float h_min, float* out_h, float* out_mask,
                            int64_t n) {
  const int64_t cells = n * n;
  for (int64_t i = 0; i < cells; ++i) {
    out_h[i] = 0.0f;
    out_mask[i] = 0.0f;
  }
  std::vector<float> zmax(cells, -INFINITY);
  const bool use_rmin = r_min > 0.0f;
  for (int64_t i = 0; i < n_pts; ++i) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
    if (std::isnan(x) || std::isnan(y) || std::isnan(z)) continue;
    if (use_rmin && std::sqrt(x * x + y * y) <= r_min) continue;
    if (!(x > -d_max && x < d_max && y > -d_max && y < d_max &&
          z > h_min && z < h_max)) continue;
    // searchsorted(bins, v, 'right') - 1 with bins = arange(-d_max, d_max)
    int64_t xi = (int64_t)std::floor((x + d_max) / grid_res);
    int64_t yi = (int64_t)std::floor((y + d_max) / grid_res);
    if (xi < 0 || xi >= n || yi < 0 || yi >= n) continue;
    // reference layout quirk: transposed write -> out[x * n + y]
    const int64_t j = xi * n + yi;
    if (z > zmax[j]) zmax[j] = z;
  }
  for (int64_t j = 0; j < cells; ++j) {
    if (zmax[j] > -INFINITY) {
      out_h[j] = zmax[j];
      out_mask[j] = 1.0f;
    }
  }
}

// Voxel-grid downsampling with open3d semantics (centroid of the points in
// each voxel, voxel index floor((p - min) / voxel)).  Returns the number of
// output points written to `out` (capacity must be >= n_pts * 3 floats).
int64_t voxel_downsample_f32(const float* pts, int64_t n_pts,
                             float voxel_size, float* out) {
  if (n_pts == 0) return 0;
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  for (int64_t i = 0; i < n_pts; ++i)
    for (int k = 0; k < 3; ++k)
      if (pts[3 * i + k] < mn[k]) mn[k] = pts[3 * i + k];

  struct Acc {
    double s[3] = {0, 0, 0};
    int64_t cnt = 0;
    int64_t order = 0;
  };
  std::unordered_map<uint64_t, Acc> cellmap;
  cellmap.reserve((size_t)n_pts);
  int64_t next_order = 0;
  for (int64_t i = 0; i < n_pts; ++i) {
    uint64_t key = 0;
    for (int k = 0; k < 3; ++k) {
      const int64_t c =
          (int64_t)std::floor((pts[3 * i + k] - mn[k]) / voxel_size);
      key = key * 73856093ULL ^ (uint64_t)(c + (1LL << 20)) * 19349663ULL;
    }
    Acc& a = cellmap[key];
    if (a.cnt == 0) a.order = next_order++;
    for (int k = 0; k < 3; ++k) a.s[k] += pts[3 * i + k];
    a.cnt++;
  }
  std::vector<const Acc*> ordered(cellmap.size());
  for (const auto& kv : cellmap) ordered[(size_t)kv.second.order] = &kv.second;
  int64_t m = 0;
  for (const Acc* a : ordered) {
    for (int k = 0; k < 3; ++k)
      out[3 * m + k] = (float)(a->s[k] / (double)a->cnt);
    ++m;
  }
  return m;
}

// Keep one point (the first) per grid cell (cloudproc.py:55-86).  Writes
// selected row indices into `out_idx` (capacity >= n_pts); returns count.
int64_t filter_grid_f32(const float* pts, int64_t n_pts, float grid_res,
                        int64_t* out_idx) {
  std::unordered_map<uint64_t, int64_t> seen;
  seen.reserve((size_t)n_pts);
  int64_t m = 0;
  for (int64_t i = 0; i < n_pts; ++i) {
    uint64_t key = 0;
    for (int k = 0; k < 3; ++k) {
      const int64_t c = (int64_t)std::floor(pts[3 * i + k] / grid_res);
      key = key * 73856093ULL ^ (uint64_t)(c + (1LL << 20)) * 19349663ULL;
    }
    auto it = seen.find(key);
    if (it == seen.end()) {
      seen.emplace(key, i);
      out_idx[m++] = i;
    }
  }
  return m;
}

}  // extern "C"
