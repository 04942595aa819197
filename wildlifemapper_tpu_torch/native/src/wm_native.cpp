// Native host-side kernels for wildlifemapper_tpu.
//
// The reference leans on native code through dependencies only (SURVEY §2.4):
// scipy's C++ Jonker-Volgenant LSAP (matcher.py:80), torchvision's C++ NMS
// (visualize_prediction.py:154), and pycocotools' C extension
// (inference.py:15-17). The TPU training path solves LSAP on-device
// (ops/lsap.py); these C++ implementations serve the host-side runtime: the
// data/eval pipeline (COCO matching over many detections), mosaic-level NMS,
// and a fast oracle for cross-checking the on-device solver.
//
// Exposed with plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Jonker-Volgenant shortest augmenting path LSAP (square, minimize).
// cost: n*n row-major; row_to_col: n outputs. Returns 0 on success.
// ---------------------------------------------------------------------------
int wm_lapjv(const float* cost, int n, int* row_to_col) {
  const double INF = std::numeric_limits<double>::infinity();
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, -1);  // p[j]: row matched to column j (col 0 virtual)
  std::vector<double> minv(n + 1);
  std::vector<int> way(n + 1);
  std::vector<char> used(n + 1);

  for (int i = 0; i < n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::fill(minv.begin(), minv.end(), INF);
    std::fill(used.begin(), used.end(), 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = (double)cost[(size_t)i0 * n + (j - 1)] - u[i0 + 1] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      if (j1 < 0) return 1;  // infeasible (should not happen for finite costs)
      for (int j = 0; j <= n; ++j) {
        if (used[j]) { u[p[j] + 1] += delta; v[j] -= delta; }
        else minv[j] -= delta;
      }
      j0 = j1;
    } while (p[j0] != -1);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int j = 1; j <= n; ++j)
    if (p[j] >= 0) row_to_col[p[j]] = j - 1;
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy class-agnostic NMS. boxes: n*4 xyxy, scores: n.
// keep_out: n ints (1 = kept). Returns number kept.
// ---------------------------------------------------------------------------
int wm_nms(const float* boxes, const float* scores, int n, float iou_thr,
           int32_t* keep_out) {
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<char> suppressed(n, 0);
  std::vector<float> area(n);
  for (int i = 0; i < n; ++i) {
    area[i] = (boxes[i * 4 + 2] - boxes[i * 4]) *
              (boxes[i * 4 + 3] - boxes[i * 4 + 1]);
    keep_out[i] = 0;
  }
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[i] = 1;
    ++kept;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      float xx0 = std::max(boxes[i * 4], boxes[j * 4]);
      float yy0 = std::max(boxes[i * 4 + 1], boxes[j * 4 + 1]);
      float xx1 = std::min(boxes[i * 4 + 2], boxes[j * 4 + 2]);
      float yy1 = std::min(boxes[i * 4 + 3], boxes[j * 4 + 3]);
      float inter = std::max(0.f, xx1 - xx0) * std::max(0.f, yy1 - yy0);
      float iou = inter / std::max(area[i] + area[j] - inter, 1e-9f);
      if (iou > iou_thr) suppressed[j] = 1;
    }
  }
  return kept;
}

// ---------------------------------------------------------------------------
// COCOeval greedy matching for one (image, category, areaRng, maxDet) cell.
// dts are pre-sorted by score desc and truncated; gts pre-sorted ignore-last.
// ious: D*G row-major. iou_thrs: T. g_ignore/g_crowd: G flags.
// Outputs: dtm (T*D, matched gt index+1 or 0), dt_ig (T*D flags),
// gtm (T*G, matched dt index+1 or 0).
// ---------------------------------------------------------------------------
void wm_coco_match(const double* ious, int D, int G, const double* iou_thrs,
                   int T, const uint8_t* g_ignore, const uint8_t* g_crowd,
                   int64_t* dtm, uint8_t* dt_ig, int64_t* gtm) {
  std::memset(dtm, 0, sizeof(int64_t) * T * D);
  std::memset(gtm, 0, sizeof(int64_t) * T * G);
  std::memset(dt_ig, 0, sizeof(uint8_t) * T * D);
  for (int t = 0; t < T; ++t) {
    for (int d = 0; d < D; ++d) {
      double best = std::min(iou_thrs[t], 1.0 - 1e-10);
      int m = -1;
      for (int g = 0; g < G; ++g) {
        if (gtm[(size_t)t * G + g] > 0 && !g_crowd[g]) continue;
        if (m > -1 && !g_ignore[m] && g_ignore[g]) break;
        double iou = ious[(size_t)d * G + g];
        if (iou < best) continue;
        best = iou;
        m = g;
      }
      if (m < 0) continue;
      dt_ig[(size_t)t * D + d] = g_ignore[m];
      dtm[(size_t)t * D + d] = m + 1;
      gtm[(size_t)t * G + m] = d + 1;
    }
  }
}

}  // extern "C"
