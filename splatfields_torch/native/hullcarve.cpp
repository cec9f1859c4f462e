// Multithreaded visual-hull carving (host-side point-cloud init).
//
// Native equivalent of the mask-projection loops of the NumPy routes in
// data/point_init.py and readers/neus.py (reference
// scene/dataset_readers.py:796-856, 1385-1417): for every candidate 3-D
// point, project into every training view and test the mask. The Python
// path is O(n_pts * n_cams) NumPy passes; this kernel fuses the camera loop
// per point, runs on all cores, and early-exits a point at its first
// failing view.
//
// Exposed via ctypes (splatfields_torch/native/__init__.py). Two projection
// conventions, matching the two Python call sites:
//   mode 0: transposed full-projection matrices (4x4, row-vector convention)
//           with NDC -> pixel mapping ((v+1)*S - 1)/2   [Blender hull]
//   mode 1: 3x4 KRT pixel projections (u = P x / P z)   [NeuS hull]
//
// Built at first use by native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread hullcarve.cpp

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// points:     [n_pts * 3] float32
// mats:       mode 0: [n_cams * 16] (4x4 transposed full projection)
//             mode 1: [n_cams * 12] (3x4 KRT)
// masks:      [n_cams * h * w] uint8 (nonzero = inside)
// widths/heights: per-camera image sizes
// keep (out): [n_pts] uint8
void carve_points(const float* points, int64_t n_pts,
                  const float* mats, const uint8_t* masks,
                  const int32_t* widths, const int32_t* heights,
                  const int64_t* mask_offsets, int32_t n_cams,
                  int32_t mode, uint8_t* keep, int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  std::atomic<int64_t> cursor{0};
  const int64_t block = 16384;

  auto worker = [&]() {
    for (;;) {
      int64_t lo = cursor.fetch_add(block);
      if (lo >= n_pts) return;
      int64_t hi = lo + block < n_pts ? lo + block : n_pts;
      for (int64_t i = lo; i < hi; ++i) {
        const float x = points[i * 3 + 0];
        const float y = points[i * 3 + 1];
        const float z = points[i * 3 + 2];
        uint8_t ok = 1;
        for (int32_t c = 0; c < n_cams && ok; ++c) {
          const int32_t w = widths[c];
          const int32_t h = heights[c];
          const uint8_t* mask = masks + mask_offsets[c];
          float u, v;
          if (mode == 0) {
            const float* m = mats + (int64_t)c * 16;  // transposed 4x4
            const float cx = x * m[0] + y * m[4] + z * m[8] + m[12];
            const float cy = x * m[1] + y * m[5] + z * m[9] + m[13];
            const float cz = x * m[2] + y * m[6] + z * m[10] + m[14];
            const float ndc_x = cx / cz;  // no z test: parity with the
            const float ndc_y = cy / cz;  // Python projection (it divides raw)
            u = ((ndc_x + 1.f) * w - 1.f) * 0.5f;
            v = ((ndc_y + 1.f) * h - 1.f) * 0.5f;
          } else {
            const float* m = mats + (int64_t)c * 12;  // 3x4 KRT
            const float pu = x * m[0] + y * m[1] + z * m[2] + m[3];
            const float pv = x * m[4] + y * m[5] + z * m[6] + m[7];
            const float pw = x * m[8] + y * m[9] + z * m[10] + m[11];
            u = pu / pw;
            v = pv / pw;
          }
          if (!std::isfinite(u) || !std::isfinite(v) ||
              u < -2.e9f || u > 2.e9f || v < -2.e9f || v > 2.e9f) {
            ok = 0; break;
          }
          // round-half-to-even to match np.round exactly
          int32_t ui = (int32_t)std::nearbyintf(u);
          int32_t vi = (int32_t)std::nearbyintf(v);
          if (mode == 0) {
            // Blender path: integer bounds after rounding (point_init.py)
            if (ui < 0 || ui >= w || vi < 0 || vi >= h) { ok = 0; break; }
          } else {
            // NeuS path: float bounds, clipped lookup (readers/neus.py)
            if (u < 0.f || u > (float)(w - 1) || v < 0.f ||
                v > (float)(h - 1)) { ok = 0; break; }
            ui = ui < 0 ? 0 : (ui >= w ? w - 1 : ui);
            vi = vi < 0 ? 0 : (vi >= h ? h - 1 : vi);
          }
          if (!mask[(int64_t)vi * w + ui]) { ok = 0; break; }
        }
        keep[i] = ok;
      }
    }
  };

  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
